#!/usr/bin/env python3
"""Drive the PyTorch port of the detector on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises, so the script exits
non-zero and never prints its last line):
  1. device: torch/CUDA versions, the card's name and power limit; TF32 off
     for the parity phases.
  2. build: compile csrc/*.cu with nvcc, one process per source, all started
     together (seconds and ptxas resource lines).
  3. kernels vs their plain PyTorch twins at the shapes of the paths: NMS
     at (8, 2048) -> 300 @ 0.7, (16, 300) -> 100 @ 0.6 (image serving),
     (8, 4096) -> 2000 @ 0.7 (training), (8, 1100) -> 300 @ 0.7 and
     (16, 300) -> 100 @ 0.6 (BEV serving), (8, 1024) -> 1024 slots @ 0.7
     (BEV training) must keep identical lanes (each check also prints the
     mask and scan kernels' device times apart, from torch.profiler); RoI
     align at features
     (8, 32, 60, 1024) and (8, 25, 22, 1024) x 300 rois and (8, 25, 22,
     1024) x 256 (BEV training) within 1e-5 * max|F| (float32) and 1e-2 *
     max|F| (bfloat16, rounded output), its time printed beside the
     replaced kernel's (REPLACED_FWD_MS); the RoI-align backward at
     (8, 32, 60, 1024) and (8, 25, 22, 1024) x 256 rois: every element
     within the sum-order limit of the twin's autograd gradient on CPU
     copies (sum_order_tolerance: 64 float32 eps times the summed
     magnitudes of its contributions, plus one bf16 ulp for bfloat16; the
     max|dF|-relative error is printed beside it), and two runs bitwise
     equal; the BEV
     voxelizer at (8, 32768) points -> 400 x 350 x 15 and
     (8, 180000) -> 800 x 700 x 15, with points on cell and slice
     boundaries, invalid lanes, points out of range, over-full voxels and an
     all-invalid frame, and at both sizes once more with frame 0's points
     all in one tile of the raster (skew_points): height and density
     channels equal, and equal over two runs, the meta channels within
     1e-5 (float sums in arrival order), times beside the replaced
     kernel's (REPLACED_VOX_MS).  Forward results are
     compared with the twins on CPU copies, the backwards too.  Each kernel's time is device time (CUDA events, the median
     of 5 windows queued while the card sleeps, so the host's launch time is
     not in it: kernel_ms), beside the twin's time on the card (back to
     back, host included) and the least time the card could take (the
     larger of bytes over 3.35 TB/s and float32 operations over 67 TFLOP/s).
  4. the image serving slice at res101, float32, one 256x320 frame: card
     (kernels) against CPU (twins).
  5. the image serving path: the image config at test settings, compute
     dtype bfloat16, SyntheticDataset 512x960, batch 8, one warm-up batch
     then 3 batches through inference.evaluate.  Outputs must be finite,
     every frame must have proposals, and NMS and RoI align must have
     launched.
  6. the training slice at res101, float32, one 256x320 frame, ROI_BATCH_SIZE
     64, NMS_PRE_TRAIN 1024 -> 256: card against CPU on the same random
     draws, the card's second stage pinned to the CPU's proposal lanes.
     Equal anchor and RoI samples, the four losses within rtol 1e-3, the
     gradients of six trainable leaves within 1e-3 * max|g| of each leaf.
  7. the training path: the image config (res101, bf16), SyntheticDataset
     512x960 through the BatchLoader, batch 8, one warm-up step then 10
     steps of training.solver.train.  Every loss finite at every step; NMS,
     RoI align and its backward must have launched.
  8. the BEV serving slice at res101, float32, one synthetic 400 x 350 x 15
     frame: card (kernels) against CPU (twins): raster, C4 features,
     fg_prob, proposals, cls_prob and 7-DoF boxes pinned to the CPU's rois
     and 3D anchors, final detections.
  9. the BEV serving path: the BEV config (res101 LiDAR, 0.2 m voxels,
     400 x 350 x 15 raster, 1,100 anchors a frame) at test settings, bf16,
     batch 8 of synthetic LiDAR frames (32768 padded points) through the
     BatchLoader (voxelize_bev on the card) and inference.evaluate, one
     warm-up batch then 3 batches.  Outputs finite, proposals in every
     frame, voxelize_bev, NMS and RoI align launched.
 10. the BEV training slice at res101, float32, one synthetic 400 x 350 x 15
     raster with 7-DoF GT, as phase 6: card against CPU on the same draws,
     equal samples, losses within rtol 1e-3, leaf gradients within 1e-3 *
     max|g|.
 11. the BEV training path: the BEV config (the JAX bench's bev_config:
     frozen BN, RPN_POST_NMS_TOP_N 2000, NMS_PRE_TRAIN 1024, MAX_GT 64),
     bf16, batch 8 of synthetic LiDAR frames through the BatchLoader
     (voxelize_bev on the card), one warm-up step then 10 steps.  Every loss
     finite; voxelize_bev, NMS, RoI align and its backward launched.
 12. the rotated BEV serving path: phase 9 with TEST.ROTATED_NMS and
     TEST.NMS_THRESH 0.3.  The rotated NMS kernel must launch once a batch
     and the axis-aligned one that much less than in phase 9; ms, frames/s
     and peak memory beside phase 9's.
 13. the FPN slices at res101, float32, one 256x320 frame, serving and
     training, card against CPU as in phases 4 and 6 (the pyramid p2..p5 in
     place of the C4 map; the FPN, layer4 and FCTail among the leaves).
 14. the FPN serving path: the FPN config (the image config with USE_FPN and
     multiscale pooling: the RPN on p2 at stride 4, 768,000 anchors a frame)
     at test settings, bf16, batch 8, 512x960, one warm-up batch then 3
     batches.  The multiscale RoI-align kernel must have launched and the
     single-level one not.
 15. the FPN training path: the FPN config, bf16, batch 8, one warm-up step
     then 10 steps; the multiscale kernel and its backward must have
     launched.  Then anchor_target alone at (8, 768000 anchors, 64 GT):
     time and peak memory.
Phase 3 also holds the multiscale RoI-align kernels against their twins at
the FPN shapes: maps (8, 128, 240, 256) .. (8, 16, 30, 256), (8, 300) RoIs
of 16-900 px (every level gets RoIs, every RoI on the twin's level) within
1e-5 / 1e-2 * max|F| (its bound reads only the tap rows the RoIs hit on
their levels; times beside the replaced kernel's, REPLACED_MS_FWD_MS), and
once with every RoI on p2, many of them wide enough for a one-row ring
(p2_rois), the backward at dOut (8, 256, 7, 7, 256) within the
sum-order limit on every level and bitwise equal over two runs, and once
with every RoI on p5 (times beside the replaced kernel's,
REPLACED_MS_BWD_MS); and the
rotated NMS at the BEV final filter's shape, (16, 300) -> 100 @ 0.3, on
rotated boxes in voxel units, half of them clustered: its IoU kernel within
5e-5 of the twin's IoU (and on edge cases: identical, nested, shared edge,
90 degrees, zero width, disjoint), its keeps identical to the twin's on
every problem where no kept lane's pair lies within 1e-4 of the threshold,
and on every problem a tolerant greedy check against the twin's IoU matrix
(`greedy_violations`).
Each path (5, 7, 9, 11, 12, 14, 15) runs with the launch counts set to 0
just before it and read just after.  Then one JSON line describing the
kernels (each kernel's `launches` is the count on the newest path that runs
it: BEV training for the voxelizer, NMS, RoI align and its backward, rotated
BEV serving for the rotated NMS, FPN serving and FPN training for the
multiscale kernels; its times, error and bound are from phase 3 at that
path's shapes; `launches_by_path` has all seven), the nvidia-smi
name/power line, and the result line {"ok": true, "device": ...}.

Imports nothing of JAX; needs the repository checkout around it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PKG = "faster_rcnn_pytorch_multimodal_tpu_torch"
B, H_FEAT, W_FEAT, C_FEAT, R = 8, 32, 60, 1024, 300
R_TRAIN = 256  # TRAIN.ROI_BATCH_SIZE: RoIs pooled per training frame
FRAME_HW = (512, 960)  # the serving and training frame: 32 x 60 C4 cells at stride 16
BEV_FEAT_HW = (25, 22)  # the 400 x 350 BEV raster at stride 16
BEV_ANCHORS = 25 * 22 * 2  # 2 anchor headings a cell
SLICE_HW = (256, 320)
TRAIN_STEPS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
IOU_FLOPS = 13  # float32 operations of one IoU pair in the NMS mask
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's 1.98 GHz: the host queues a window meanwhile
EPS32 = 2.0 ** -23  # float32 machine epsilon
# sum_order_tolerance's factor: float32 rounding errors of a sum of up to
# ~1e4 contributions, random in sign, stay several standard deviations below
# 64 eps times the sum of their magnitudes, in either summation order
SUM_ORDER_FACTOR = 64
BF16_ULP = 2.0 ** -7  # one bfloat16 ulp, relative to the value it rounds

# The image and BEV configurations of the JAX package's bench (bench.py:196-228):
# Waymo front camera at scale 0.5, and Waymo BEV at scale 0.5 (400 x 350 x 15).
IMAGE_OVERRIDES = (
    "NET_TYPE", "image", "NET_VARIANT", "res101", "PIXEL_STDDEVS", "[60.,60.,60.]",
    "TRAIN.RPN_POST_NMS_TOP_N", "2000", "STATIC.NMS_PRE_TRAIN", "4096", "STATIC.MAX_GT", "64",
)
BEV_OVERRIDES = (
    "NET_TYPE", "lidar", "NET_VARIANT", "res101", "TRAIN.SCALES", "(0.5,)",
    "TRAIN.RPN_POST_NMS_TOP_N", "2000", "STATIC.NMS_PRE_TRAIN", "1024", "STATIC.MAX_GT", "64",
    "STATIC.MAX_POINTS", "32768",
)
SERVING_OVERRIDES = ("STATIC.NMS_PRE_TEST", "2048", "TEST.RPN_POST_NMS_TOP_N", "300")
# bench.py:292-297: the image config with the FPN backbone and multiscale pooling
FPN_OVERRIDES = ("USE_FPN", "True", "POOLING_MODE", "multiscale")
FPN_STRIDES = (4, 8, 16, 32)
FPN_MAP_HW = ((128, 240), (64, 120), (32, 60), (16, 30))  # p2..p5 of a 512x960 frame
C_FPN = 256
# the raster grid follows TRAIN.SCALES[0] in the loader; serving sets both
BEV_SERVING_OVERRIDES = SERVING_OVERRIDES + ("TEST.SCALES", "(0.5,)", "COMPUTE_DTYPE", "bfloat16")
# rotated NMS in the final filter at the quality recipe's threshold (tools/quality_run.py:219-222)
ROTATED_OVERRIDES = ("TEST.ROTATED_NMS", "True", "TEST.NMS_THRESH", "0.3")


def make_config(*overrides):
    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list, default_config

    cfg = default_config()
    for o in overrides:
        cfg = cfg_from_list(cfg, o)
    return cfg


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the float32 operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_T0 = time.perf_counter()


def sum_order_tolerance(twin_fn, inputs, grad_out, out_dtype=None) -> list:
    """Per-element limits for holding a gradient that sums the twin's
    contributions in another order (the backward kernels' tile gathers) to the
    twin's gradient: SUM_ORDER_FACTOR x EPS32 x S, where S is the twin's
    gradient of |grad_out| taken in float32, per element the sum of the
    magnitudes of every contribution to it; for a bfloat16 gradient plus one
    bf16 ulp of the float32 gradient and of that limit (each side rounds
    once).  twin_fn(list of float32 inputs) -> output; returns one limit
    tensor per input."""
    import torch

    xs = [x.detach().float().requires_grad_(True) for x in inputs]
    out = twin_fn(xs)
    g = grad_out.float()
    sums = torch.autograd.grad(out, xs, g.abs(), retain_graph=True)
    grads = torch.autograd.grad(out, xs, g) if out_dtype == torch.bfloat16 else sums
    limits = []
    for s_, d in zip(sums, grads):
        lim = SUM_ORDER_FACTOR * EPS32 * s_
        if out_dtype == torch.bfloat16:
            lim = lim + BF16_ULP * (d.abs() + lim)
        limits.append(lim)
    return limits


def limit_ratio(got, want, limit) -> float:
    """The largest |got - want| / limit over the elements: at most 1 passes
    (an element with a zero limit must be equal)."""
    import torch

    diff = (got.float() - want.float()).abs()
    ratio = torch.where(limit > 0, diff / limit.clamp_min(1e-30),
                        torch.where(diff > 0, torch.full_like(diff, float("inf")), diff))
    return float(ratio.max()) if ratio.numel() else 0.0


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs back to back, after one
    warm-up, between CUDA events: where the host takes longer to issue a call
    than the card to run it, the host's time is in the number."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_ms(fn, reps: int, windows: int = 5) -> dict:
    """Device milliseconds of one fn() call without the host's time: in each
    of `windows` windows the card first sleeps (SLEEP_CYCLES) while the host
    queues reps calls, so the CUDA events time the calls back to back on the
    card.  Returns the median, min and max over the windows and the host's
    milliseconds to queue a window, which must stay below the sleep (else
    the host's time would be in the number, and this raises)."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times, host = [], []
    for _ in range(windows):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        host.append((time.perf_counter() - t0) * 1e3)
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    times.sort()
    sleep = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sleep[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    sleep[1].record()
    sleep[1].synchronize()
    sleep_ms = sleep[0].elapsed_time(sleep[1])
    if max(host) >= sleep_ms:
        raise AssertionError(f"kernel_ms: the host took {max(host)} ms to queue {reps} calls, "
                             f"longer than the card's {sleep_ms} ms sleep")
    return {"ms": times[len(times) // 2], "min": times[0], "max": times[-1], "windows": windows,
            "host_queue_ms": max(host), "sleep_ms": sleep_ms}


def profile_kernels(fn, reps: int, *names) -> dict:
    """Device milliseconds per call of the CUDA kernels fn() launches whose
    name holds each of `names`, from torch.profiler's per-kernel totals over
    reps calls (after one warm-up call): {name: ms}, 0 where the profiler
    saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        for n in names:
            if n in e.key:
                out[n] += us / 1e3 / reps
    return out


def spread(t: dict) -> str:
    return (f"{t['ms']} ms (device time, median of {t['windows']} windows, min {t['min']}, max "
            f"{t['max']}; the host queued a window in {t['host_queue_ms']} ms while the card "
            f"slept {t['sleep_ms']} ms)")


def random_boxes(rng, n, frame_hw=(512, 960), size=(16.0, 256.0)):
    x1 = rng.uniform(0, frame_hw[1] - size[0], n)
    y1 = rng.uniform(0, frame_hw[0] - size[0], n)
    w = rng.uniform(*size, n)
    h = rng.uniform(*size, n)
    return np.stack([x1, y1, np.minimum(x1 + w, frame_hw[1] - 1),
                     np.minimum(y1 + h, frame_hw[0] - 1)], 1).astype(np.float32)


def nms_problems(rng, g, n):
    """g problems of n boxes: random boxes and scores, plus score ties,
    invalid lanes and a suppression chain in some of the problems."""
    boxes = np.stack([random_boxes(rng, n) for _ in range(g)])
    scores = rng.uniform(size=(g, n)).astype(np.float32)
    valid = np.ones((g, n), bool)
    scores[1] = np.round(scores[1] * 8) / 8  # ties
    valid[2] = rng.uniform(size=n) < 0.7  # invalid lanes
    # neighbours overlap at IoU 0.74, every other box at 0.54: greedy keeps
    # the even lanes at thresholds 0.6 and 0.7
    chain = min(n, 40)
    boxes[3, :chain] = [[i * 1.5, 0, i * 1.5 + 10, 10] for i in range(chain)]
    scores[3, :chain] = np.linspace(2.0, 1.5, chain)  # above every random score
    return boxes, scores, valid


def nms_pairs(scores, valid, idx, ok):
    """IoU pairs greedy NMS needs on these problems: each kept box against
    every box after it in score order."""
    pairs = 0
    for s, v, i, k in zip(scores, valid, idx, ok):
        order = np.argsort(-np.where(v, s, -np.inf), kind="stable")
        pos = np.empty_like(order)
        pos[order] = np.arange(len(order))
        pairs += int((len(order) - 1 - pos[i[k]]).sum())
    return pairs


def score_order(scores, valid):
    """Lanes of one problem in NMS order: descending score, stable, invalid
    lanes last (the wrappers' sort)."""
    return np.argsort(-np.where(valid, scores, -1e30).astype(np.float64), kind="stable")


def near_threshold(iou, valid, thr, tol, rows) -> bool:
    """Whether one of the lanes `rows` (a reference's kept lanes: only their
    rows decide a greedy NMS) has an IoU within tol of thr with another
    valid lane of the problem (iou: (N, N) over the input lanes)."""
    near = (np.abs(iou - thr) <= tol) & valid[:, None] & valid[None, :]
    np.fill_diagonal(near, False)
    return bool(near[rows].any())


def greedy_violations(iou, scores, valid, idx, ok, thr, tol, max_out) -> list:
    """How one problem's keep slots (idx, ok) break greedy NMS by more than
    tol against iou (N, N), the IoU of every lane (row) with every later one
    (column): walking the lanes in score order, a kept lane has no earlier
    kept lane with IoU > thr + tol, a valid lane not kept has an earlier kept
    lane with IoU > thr - tol, and the slots hold the first min(count, M)
    kept lanes in order, M = min(N, max_out).  Returns messages, [] when it
    passes."""
    n = len(scores)
    m = min(n, max_out)
    order = score_order(scores, valid)
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    count = int(ok.sum())
    bad = []
    if not ok[:count].all():
        bad.append("valid slots are not a prefix")
    kept = idx[:count].astype(np.int64)
    if not valid[kept].all():
        bad.append("an invalid lane was kept")
    if (np.diff(pos[kept]) <= 0).any():
        bad.append("kept lanes are not in score order")
    last = pos[kept[-1]] if count == m and count else n - 1
    is_kept = np.zeros(n, bool)
    is_kept[kept] = True
    before = []
    for lane in order[:last + 1]:
        best = float(iou[before, lane].max()) if before else 0.0
        if is_kept[lane]:
            if best > thr + tol:
                bad.append(f"lane {lane} kept under IoU {best}")
            before.append(lane)
        elif valid[lane] and best <= thr - tol:
            bad.append(f"lane {lane} dropped at best IoU {best}")
    return bad


def check_nms(name, g, n, thr, max_out, rng):
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms, nms_plain

    boxes, scores, valid = nms_problems(rng, g, n)
    tb, ts, tv = (torch.from_numpy(a) for a in (boxes, scores, valid))
    db, ds, dv = (t.cuda() for t in (tb, ts, tv))
    idx, ok = nms(db, ds, thr, max_out, dv)
    torch.cuda.synchronize()
    want_idx, want_ok = nms_plain(tb, ts, thr, max_out, tv)
    bad = (idx.cpu() != want_idx) | (ok.cpu() != want_ok)
    if bad.any():
        raise AssertionError(f"nms {name}: {int(bad.sum())} slots differ from the twin")
    err = float((idx.cpu().double() - want_idx.double()).abs().max())
    chain_kept = idx[3][ok[3]][:20].cpu().numpy()
    if not np.array_equal(chain_kept, np.arange(0, 40, 2)[:20]):
        raise AssertionError(f"nms {name}: chain keeps {chain_kept}")
    t = kernel_ms(lambda: nms(db, ds, thr, max_out, dv), 50)
    ms = t["ms"]
    split = profile_kernels(lambda: nms(db, ds, thr, max_out, dv), 10, "nms_mask_kernel",
                            "nms_scan_kernel")
    plain_ms = cuda_ms(lambda: nms_plain(db, ds, thr, max_out, dv), 2)
    m = idx.shape[-1]
    pairs = nms_pairs(scores, valid, want_idx.numpy(), want_ok.numpy())
    bound, by = bound_ms(g * n * (16 + 4 + 1) + g * m * (4 + 1), pairs * IOU_FLOPS)
    print(f"nms {name} ({g}, {n}) -> {max_out} @ {thr}: identical keeps "
          f"({int(ok.sum())} kept); kernel {spread(t)}, of it per call (torch.profiler) the mask "
          f"kernel {split['nms_mask_kernel']} ms and the staged block scan "
          f"{split['nms_scan_kernel']} ms (the rest: the wrapper's sort and casts); plain twin on "
          f"the card {plain_ms} ms, bound {bound} ms ({by}; {pairs} IoU pairs)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "mask_ms": split["nms_mask_kernel"], "scan_ms": split["nms_scan_kernel"]}


def rotated_boxes(rng, g, n):
    """g problems of n rotated BEV boxes [xc, yc, l, w, ry] in voxel units:
    centers over the 400-voxel raster, l 8-25, w 4-10, any heading; the
    first half jittered copies of the second half's centers, so that many
    pairs overlap."""
    b = np.stack([rng.uniform(0, 400, (g, n)), rng.uniform(0, 400, (g, n)),
                  rng.uniform(8, 25, (g, n)), rng.uniform(4, 10, (g, n)),
                  rng.uniform(-np.pi, np.pi, (g, n))], -1)
    h = n // 2
    b[:, :h, :2] = b[:, n - h:, :2] + rng.uniform(-6, 6, (g, h, 2))
    return b.astype(np.float32)


# float32 operations that every pair of csrc/nms.cu's rotated IoU costs at
# least, counted from its code (rot_intersection, rot_iou): both quads'
# corners relative to a's center, 2 x (2 + 16); the first clip stage, which
# no pair skips: the edge vector (2), the first signed distance (5) and 5 per
# vertex of a's quad (4 x 5); the union and the division (3).  Later clip
# stages, crossings and the shoelace depend on the pair and are left out, so
# pairs x ROT_PAIR_OPS undercounts the work: a valid bound.
ROT_PAIR_OPS = 36 + 2 + 5 + 4 * 5 + 3


ROTATED_EDGE_CASES = np.array([
    [100, 100, 20, 8, 0.3], [100, 100, 20, 8, 0.3],  # identical: 1
    [100, 100, 10, 4, 0.3],  # inside 0 at a quarter of its area: 0.25
    [100, 108, 20, 8, 0.0],  # shares an edge with 8: 0
    [100, 100, 20, 8, np.pi / 2],  # 8 turned by 90 degrees: 64 / 256
    [100, 100, 20, 0, 0.1],  # zero width: 0
    [300, 300, 10, 5, 1.0],  # disjoint from all: 0
    [130, 100, 20, 8, 0.0],  # disjoint from 8: 0
    [100, 100, 20, 8, 0.0],
], np.float32)


def check_rotated(g, n, thr, max_out, rng, tol=1e-4):
    """K4: the rotated IoU kernel's matrix against the twin's (max |dIoU| <=
    5e-5, edge cases by value), and the rotated NMS kernel's keeps against
    the twin's: identical on every problem where no kept lane's pair lies
    within tol of the threshold, and the tolerant greedy check against the
    twin's IoU matrix on every problem.  Twin on the card."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms, nms_plain
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.rotated_iou import (
        rotated_iou_matrix,
        rotated_iou_matrix_plain,
    )

    boxes = rotated_boxes(rng, g, n)
    scores = rng.uniform(size=(g, n)).astype(np.float32)
    scores[1] = np.round(scores[1] * 8) / 8  # ties
    valid = np.ones((g, n), bool)
    valid[2] = rng.uniform(size=n) < 0.7  # invalid lanes
    db, ds, dv = (torch.from_numpy(a).cuda() for a in (boxes, scores, valid))
    got = rotated_iou_matrix(db, db)
    want = rotated_iou_matrix_plain(db, db)
    torch.cuda.synchronize()
    iou_err = float((got - want).abs().max())
    overlapping = int((want > 0.05).sum()) - g * n
    e = torch.from_numpy(ROTATED_EDGE_CASES).cuda()
    ge, we = rotated_iou_matrix(e, e).cpu().numpy(), rotated_iou_matrix_plain(e, e).cpu().numpy()
    edge_err = float(np.abs(ge - we).max())
    edges = {"identical": float(ge[0, 1]), "inside": float(ge[0, 2]),
             "shared edge": float(abs(ge[3, 8])), "90 deg": float(ge[4, 8]),
             "zero width": float(np.abs(ge[5]).max()), "disjoint": float(np.delete(ge[6], 6).max())}
    edge_ok = (abs(edges["identical"] - 1) <= 1e-6 and abs(edges["inside"] - 0.25) <= 1e-6
               and edges["shared edge"] <= 1e-6 and abs(edges["90 deg"] - 0.25) <= 1e-6
               and edges["zero width"] <= 1e-6 and edges["disjoint"] == 0)
    if not iou_err <= 5e-5 or not edge_err <= 5e-5 or not edge_ok:
        raise AssertionError(f"rotated_iou: max |dIoU| {iou_err}, edge cases {edge_err} {edges}")

    idx, ok = nms(db, ds, thr, max_out, dv, rotated=True)
    torch.cuda.synchronize()
    want_idx, want_ok = (t.cpu().numpy() for t in nms_plain(db, ds, thr, max_out, dv, rotated=True))
    idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
    iou_np = want.cpu().numpy()
    near = bad = 0
    for i in range(g):
        rows = want_idx[i][want_ok[i]]
        if near_threshold(iou_np[i], valid[i], thr, tol, rows):
            near += 1
        elif not (np.array_equal(idx[i], want_idx[i]) and np.array_equal(ok[i], want_ok[i])):
            raise AssertionError(f"nms_rotated problem {i}: keeps differ from the twin's, and no "
                                 f"kept lane's pair lies within {tol} of {thr}")
        broken = greedy_violations(iou_np[i], scores[i], valid[i], idx[i], ok[i], thr, tol, max_out)
        if broken:
            bad += 1
            print(f"nms_rotated problem {i}: {broken[:5]}")
    if bad:
        raise AssertionError(f"nms_rotated: {bad} problems fail the tolerant greedy check")
    t = kernel_ms(lambda: nms(db, ds, thr, max_out, dv, rotated=True), 20)
    split = profile_kernels(lambda: nms(db, ds, thr, max_out, dv, rotated=True), 10,
                            "nms_rotated_mask_kernel", "nms_scan_kernel")
    plain_ms = cuda_ms(lambda: nms_plain(db, ds, thr, max_out, dv, rotated=True), 2)
    iou_t = kernel_ms(lambda: rotated_iou_matrix(db, db), 20)
    pairs = g * n * (n - 1) // 2  # the mask kernel's upper triangle
    ops = pairs * ROT_PAIR_OPS
    col_blocks = -(-n // 64)
    words = g * sum(col_blocks - i // 64 for i in range(n))
    bound, by = bound_ms(g * n * 20 + words * 8, ops)
    print(f"rotated_iou ({g}, {n}, 5)^2 -> ({g}, {n}, {n}): max |dIoU| vs twin {iou_err} (limit "
          f"5e-5), {overlapping} overlapping pairs (IoU > 0.05); edge cases {edges}, max |dIoU| "
          f"{edge_err}; kernel {spread(iou_t)}")
    print(f"nms_rotated ({g}, {n}) -> {max_out} @ {thr}: {int(ok.sum())} kept; identical keeps on "
          f"the {g - near} problems without a kept lane's pair within {tol} of {thr} ({near} "
          f"with one); the tolerant greedy check passes on all {g}; kernel {spread(t)}, of it "
          f"per call (torch.profiler) the rotated mask kernel "
          f"{split['nms_rotated_mask_kernel']} ms and the staged block scan "
          f"{split['nms_scan_kernel']} ms; plain "
          f"twin on the card {plain_ms} ms, bound {bound} ms ({by}: {pairs} upper-triangle pairs x "
          f"{ROT_PAIR_OPS} float32 operations, the least a pair costs in the kernel's code)")
    return {"max_abs_err": iou_err, "ms": t["ms"], "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "near_problems": near, "iou_ms": iou_t["ms"],
            "mask_ms": split["nms_rotated_mask_kernel"], "scan_ms": split["nms_scan_kernel"]}


def serving_rois(rng, b, r, frame_hw=FRAME_HW):
    """Proposal-like rois on a frame, with some straddling the edge, some
    outside it and some smaller than one feature cell."""
    size = (16.0, min(256.0, frame_hw[0] / 2))
    rois = np.stack([random_boxes(rng, r, frame_hw, size) for _ in range(b)])
    rois[:, :20, :2] -= 100.0
    rois[:, 20:30] += 2000.0
    rois[:, 30:40, 2:] = rois[:, 30:40, :2] + rng.uniform(1, 12, (b, 10, 2))
    return rois.astype(np.float32)


def roi_align_flops(n_out: int, sr: int = 2) -> int:
    """float32 operations of RoI align per output (or dOut) element: sr x sr
    samples of 4 bilinear taps, a multiply and an add each."""
    return n_out * sr * sr * 4 * 2


# The tap-by-tap forward's device ms (bf16, fp32) at these checks' shapes,
# before the staged forward replaced it (PERF.md section 6: chip_smoke.py on
# an NVIDIA H100 80GB HBM3, 700.00 W)
REPLACED_FWD_MS = {((32, 60), 300): (0.4962, 0.7252), ((25, 22), 300): (0.4949, 0.7149),
              ((25, 22), 256): (0.4264, 0.6156)}


def check_roi_align(rng, feat_hw, r=R):
    """The forward kernel against the twin on CPU copies at a path's shapes,
    values within tol * max|F|; its device time, printed beside the
    tap-by-tap kernel's it replaced (REPLACED_FWD_MS)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        roi_align_batched,
        roi_align_batched_plain,
    )

    h, w = feat_hw
    feats = rng.normal(size=(B, h, w, C_FEAT)).astype(np.float32)
    rois = torch.from_numpy(serving_rois(rng, B, r, (h * 16, w * 16)))
    results = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        tf = torch.from_numpy(feats).to(dtype)
        df, dr = tf.cuda(), rois.cuda()
        got = roi_align_batched(df, dr, 1.0 / 16)
        torch.cuda.synchronize()
        want = roi_align_batched_plain(tf, rois, 1.0 / 16)
        fmax = float(tf.float().abs().max())
        err = float((got.cpu().float() - want.float()).abs().max())
        if not err <= tol * fmax:
            raise AssertionError(f"roi_align {dtype}: max err {err} > {tol} * {fmax}")
        t = kernel_ms(lambda: roi_align_batched(df, dr, 1.0 / 16), 20)
        ms = t["ms"]
        plain_ms = cuda_ms(lambda: roi_align_batched_plain(df, dr, 1.0 / 16), 3)
        bound, by = bound_ms(df.numel() * df.element_size() + dr.numel() * 4
                             + got.numel() * got.element_size(), roi_align_flops(got.numel()))
        print(f"roi_align {str(dtype).split('.')[-1]} features {tuple(df.shape)} rois "
              f"{tuple(dr.shape)}: max abs err {err} (bound {tol} * max|F| = {tol * fmax}); "
              f"kernel {spread(t)} (the tap-by-tap kernel it replaced: "
              f"{REPLACED_FWD_MS[(tuple(feat_hw), r)][dtype == torch.float32]} ms, PERF.md), plain "
              f"twin on the card {plain_ms} ms, bound {bound} ms ({by})")
        results[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by}
    return results


def check_roi_align_backward(rng, feat_hw):
    """The backward kernel against the twin's autograd gradient on CPU
    copies, at a training path's shapes (dOut (B, R_TRAIN, 7, 7, C) onto
    the feat_hw map): every element within the sum-order limit
    (sum_order_tolerance), and two runs bitwise equal (the tile gather sums
    in a fixed order); times of the backward alone.  Not the twin on the
    card: there PyTorch divides by the Python int P through a float32
    reciprocal, so the twin's sample coordinates differ from the kernel's
    (and the CPU twin's) in the last bit, which moves a near-integer tap's
    small weight far more than summation order does."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        _roi_align_bwd_cuda,
        roi_align_batched,
        roi_align_batched_plain,
    )

    h, w = feat_hw
    feats = rng.normal(size=(B, h, w, C_FEAT)).astype(np.float32)
    rois = torch.from_numpy(serving_rois(rng, B, R_TRAIN, (h * 16, w * 16))).cuda()
    grad_out = rng.normal(size=(B, R_TRAIN, 7, 7, C_FEAT)).astype(np.float32)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        f = torch.from_numpy(feats).to(dtype).cuda().requires_grad_(True)
        g = torch.from_numpy(grad_out).to(dtype).cuda()
        (got,) = torch.autograd.grad(roi_align_batched(f, rois, 1.0 / 16), f, g)
        shape, fd = tuple(f.shape), f.dtype
        again = _roi_align_bwd_cuda(g, rois, shape, fd, 1.0 / 16, 7, 2, False)
        torch.cuda.synchronize()
        got, again = got.cpu(), again.cpu()
        f_cpu, g_cpu, r_cpu = f.detach().cpu().requires_grad_(True), g.cpu(), rois.cpu()
        (want,) = torch.autograd.grad(roi_align_batched_plain(f_cpu, r_cpu, 1.0 / 16), f_cpu, g_cpu)
        (limit,) = sum_order_tolerance(
            lambda xs: roi_align_batched_plain(xs[0], r_cpu, 1.0 / 16), [f_cpu], g_cpu, dtype)
        plain_out = roi_align_batched_plain(f, rois, 1.0 / 16)
        gmax = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        ratio = limit_ratio(got, want, limit)
        bitwise = torch.equal(got, again)
        if got.dtype != dtype or not ratio <= 1.0 or not bitwise:
            raise AssertionError(f"roi_align backward {dtype}: max |dF - twin| / limit {ratio}, "
                                 f"max err {err} ({err / gmax} of max|dF|), two runs bitwise "
                                 f"equal {bitwise}")
        t = kernel_ms(lambda: _roi_align_bwd_cuda(g, rois, shape, fd, 1.0 / 16, 7, 2, False), 10)
        ms = t["ms"]
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, f, g, retain_graph=True), 3)
        bound, by = bound_ms(g.numel() * g.element_size() + rois.numel() * 4
                             + f.numel() * f.element_size(), roi_align_flops(g.numel()))
        print(f"roi_align backward {str(dtype).split('.')[-1]} dOut {tuple(g.shape)} -> dF "
              f"{shape}: max |dF - twin| / sum-order limit {ratio} (limit {SUM_ORDER_FACTOR} x "
              f"eps32 x the summed |contributions| of each element"
              f"{' + one bf16 ulp' if dtype == torch.bfloat16 else ''}); max abs err {err} = "
              f"{err / gmax} x max|dF| {gmax}; two runs bitwise equal; kernel {spread(t)}, plain "
              f"twin's autograd backward on the card {plain_ms} ms, bound {bound} ms ({by})")
        results[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by, "limit_ratio": ratio}
        del plain_out
    return results


def fpn_rois(rng, b, r, sides=(16.0, 900.0), frame_hw=FRAME_HW):
    """RoIs with log-uniform sides in `sides` px (clipped to the frame), so
    that every level of the pyramid gets some."""
    x1 = rng.uniform(0, frame_hw[1] - 16, (b, r))
    y1 = rng.uniform(0, frame_hw[0] - 16, (b, r))
    side = np.exp(rng.uniform(np.log(sides[0]), np.log(sides[1]), (b, r)))
    aspect = np.exp(rng.uniform(-0.7, 0.7, (b, r)))
    x2 = np.minimum(x1 + side * aspect, frame_hw[1] - 1)
    y2 = np.minimum(y1 + side / aspect, frame_hw[0] - 1)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def p5_rois(rng, b, r, frame_hw=FRAME_HW):
    """Squares of 450-510 px inside the frame: sqrt(area) >= 448, all on p5."""
    side = rng.uniform(450, 510, (b, r))
    x1 = rng.uniform(0, 1, (b, r)) * (frame_hw[1] - 1 - side)
    y1 = rng.uniform(0, 1, (b, r)) * (frame_hw[0] - 1 - side)
    return np.stack([x1, y1, x1 + side, y1 + side], -1).astype(np.float32)


def level_counts(levels) -> list:
    return [int((levels == i).sum()) for i in range(len(FPN_STRIDES))]


def tap_cells(rois, levels, p=7, sr=2) -> list:
    """Per level p2..p5, the distinct (frame, y, x) cells whose C-channel rows
    the forward must read: the bilinear taps of the samples of the RoIs mapped
    there (zero-weight taps included, as the kernel loads them).  A RoI's
    samples pair every sample row with every sample column, so its taps are
    the product of its y taps and its x taps.  rois (B, R, 4) and levels
    (B, R) on the CPU."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import _sample_coords, _taps

    cells = []
    for lvl, ((h, w), stride) in enumerate(zip(FPN_MAP_HW, FPN_STRIDES)):
        on = levels == lvl
        frame = torch.nonzero(on)[:, 0]
        gy, gx = _sample_coords(rois[on], 1.0 / stride, p, sr, False)
        ylo, yhi, _, _ = _taps(gy, h)
        xlo, xhi, _, _ = _taps(gx, w)
        ys, xs = torch.cat([ylo, yhi], -1), torch.cat([xlo, xhi], -1)
        flat = (frame[:, None, None] * h + ys[:, :, None]) * w + xs[:, None, :]
        cells.append(int(torch.unique(flat).numel()))
    return cells


def p2_rois(rng, b, r, frame_hw=FRAME_HW):
    """RoIs of sqrt(area) 16-110 px (all on p2) with aspects e^-1.5 .. e^1.5:
    the widest span up to ~120 p2 columns, so many take the forward's
    one-row ring (more than 1.5 x P x sr distinct tap columns)."""
    side = np.exp(rng.uniform(np.log(16.0), np.log(110.0), (b, r)))
    aspect = np.exp(rng.uniform(-1.5, 1.5, (b, r)))
    x1 = rng.uniform(0, frame_hw[1] - 16, (b, r))
    y1 = rng.uniform(0, frame_hw[0] - 16, (b, r))
    return np.stack([x1, y1, x1 + side * aspect, y1 + side / aspect], -1).astype(np.float32)


def staged_cells(rois, levels, p=7, sr=2) -> tuple[int, int]:
    """What the forward stages, RoI by RoI on its level: (the tap cells it
    reads, each RoI's distinct tap rows x distinct tap columns, summed; the
    RoIs whose distinct tap columns exceed 1.5 x P x sr, for which the ring
    holds one tap row, kFwdCap 3)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import _sample_coords, _taps

    def distinct(coords, dim):
        lo, hi, _, _ = _taps(coords, dim)
        taps = torch.cat([lo, hi], -1).sort(-1).values
        return 1 + (taps[:, 1:] != taps[:, :-1]).sum(-1)

    cells = one_row = 0
    for lvl, ((h, w), stride) in enumerate(zip(FPN_MAP_HW, FPN_STRIDES)):
        gy, gx = _sample_coords(rois[levels == lvl], 1.0 / stride, p, sr, False)
        ny, nx = distinct(gy, h), distinct(gx, w)
        cells += int((ny * nx).sum())
        one_row += int((nx * 2 > 3 * p * sr).sum())
    return cells, one_row


# The bin-by-bin multiscale forward's device ms (bf16, fp32) at the 16-900 px
# check's shapes, before the staged forward replaced it (PERF.md section 6:
# chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W)
REPLACED_MS_FWD_MS = (0.1349, 0.2321)


def check_multiscale_roi_align(rng, rois_np=None, label="16-900 px RoIs"):
    """The multiscale forward kernel against its twin (CPU copies) at the FPN
    serving shape: every RoI on the twin's level, values within tol * max|F|.
    The kernel's time is the raw entry's device time (kernel_ms); the
    public wrapper's time back to back (cuda_ms), host included, is printed
    beside it.  The bound counts the tap rows the RoIs hit on their levels
    (tap_cells), not the whole maps.  rois_np: (B, R, 4) RoIs (default
    fpn_rois, drawn after the maps, so that every level gets some)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        _multiscale_roi_align_cuda,
        multiscale_roi_align_batched,
        multiscale_roi_align_batched_plain,
        roi_levels,
    )

    maps = [rng.normal(size=(B, h, w, C_FPN)).astype(np.float32) for h, w in FPN_MAP_HW]
    rois = torch.from_numpy(fpn_rois(rng, B, R) if rois_np is None else rois_np)
    want_levels = roi_levels(rois, len(FPN_STRIDES))
    counts = level_counts(want_levels)
    if rois_np is None and min(counts) == 0:
        raise AssertionError(f"multiscale roi_align: a level got no RoI: {counts}")
    if rois_np is not None and max(counts) != sum(counts):
        raise AssertionError(f"multiscale roi_align {label}: RoIs on several levels: {counts}")
    staged, one_row = staged_cells(rois, want_levels)
    cells = tap_cells(rois, want_levels)
    results = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        tm = [torch.from_numpy(m).to(dtype) for m in maps]
        dm, dr = [m.cuda() for m in tm], rois.cuda()
        got = multiscale_roi_align_batched(dm, dr, FPN_STRIDES)
        _out, levels = _multiscale_roi_align_cuda(dm, dr, FPN_STRIDES, 7, 2)
        torch.cuda.synchronize()
        want = multiscale_roi_align_batched_plain(tm, rois, FPN_STRIDES)
        fmax = max(float(m.float().abs().max()) for m in tm)
        err = float((got.cpu().float() - want.float()).abs().max())
        same_levels = torch.equal(levels.cpu().long(), want_levels)
        if not same_levels or not err <= tol * fmax:
            raise AssertionError(f"multiscale roi_align {dtype}: levels equal {same_levels}, "
                                 f"max err {err} > {tol} * {fmax}")
        t = kernel_ms(lambda: _multiscale_roi_align_cuda(dm, dr, FPN_STRIDES, 7, 2), 20)
        wrapper_ms = cuda_ms(lambda: multiscale_roi_align_batched(dm, dr, FPN_STRIDES), 20)
        plain_ms = cuda_ms(lambda: multiscale_roi_align_batched_plain(dm, dr, FPN_STRIDES), 3)
        esize = got.element_size()
        tap_bytes = sum(cells) * C_FPN * esize
        map_bytes = sum(m.numel() * m.element_size() for m in dm)
        nbytes = tap_bytes + dr.numel() * 4 + got.numel() * esize + levels.numel() * 4
        bound, by = bound_ms(nbytes, roi_align_flops(got.numel()))
        replaced = (f"the bin-by-bin kernel it replaced: "
                    f"{REPLACED_MS_FWD_MS[dtype == torch.float32]} ms, PERF.md"
                    if rois_np is None else "the replaced kernel was not timed on this case")
        print(f"roi_align_multiscale {label} {str(dtype).split('.')[-1]} maps "
              f"{[tuple(m.shape) for m in dm]} rois {tuple(dr.shape)}, RoIs per level p2..p5 "
              f"{counts} ({one_row} with a one-row ring): levels equal to the twin's, max abs err "
              f"{err} (bound {tol} * max|F| = {tol * fmax}); kernel {spread(t)} ({replaced}); "
              f"through the public wrapper back to back "
              f"{wrapper_ms} ms (host included); plain twin on the card {plain_ms} ms; bound "
              f"{bound} ms ({by}: {nbytes} B = the rows of the {cells} distinct tap cells on "
              f"p2..p5, {tap_bytes} B of the maps' {map_bytes}, plus the rois, the output and "
              f"the levels once); the kernel stages {staged} tap cells ({staged * C_FPN * esize} "
              f"B: each RoI's distinct tap rows x columns on its level)")
        results[dtype] = {"max_abs_err": err, "ms": t["ms"], "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by}
    return results


# The float32-atomic multiscale backward's device ms (bf16, fp32) at these
# checks' shapes, before the tile gather replaced it (PERF.md section 6:
# chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W)
REPLACED_MS_BWD_MS = {"16-900 px RoIs": (1.084, 0.8399), "every RoI on p5": (1.041, 0.7955)}


def check_multiscale_backward(rng, rois_np, label):
    """The multiscale backward kernel against the twin's autograd gradients
    on CPU copies (see check_roi_align_backward), at dOut (8, 256, 7, 7,
    256): every element of each level within the sum-order limit
    (sum_order_tolerance: the per-level tile gather sums in another order
    than the twin), and two runs bitwise equal; times of the backward
    alone, printed beside the atomic kernel's it replaced (REPLACED_MS_BWD_MS)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        _multiscale_roi_align_bwd_cuda,
        multiscale_roi_align_batched,
        multiscale_roi_align_batched_plain,
        roi_levels,
    )

    maps = [rng.normal(size=(B, h, w, C_FPN)).astype(np.float32) for h, w in FPN_MAP_HW]
    rois = torch.from_numpy(rois_np).cuda()
    counts = level_counts(roi_levels(rois, len(FPN_STRIDES)))
    grad_out = rng.normal(size=(B, rois.shape[1], 7, 7, C_FPN)).astype(np.float32)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        f = [torch.from_numpy(m).to(dtype).cuda().requires_grad_(True) for m in maps]
        g = torch.from_numpy(grad_out).to(dtype).cuda()
        got = torch.autograd.grad(multiscale_roi_align_batched(f, rois, FPN_STRIDES), f, g)
        shapes, fd = [tuple(m.shape) for m in f], f[0].dtype
        again = _multiscale_roi_align_bwd_cuda(g, rois, shapes, fd, FPN_STRIDES, 7, 2)
        torch.cuda.synchronize()
        got = [a.cpu() for a in got]
        bitwise = all(torch.equal(a, b.cpu()) for a, b in zip(got, again))
        f_cpu = [m.detach().cpu().requires_grad_(True) for m in f]
        g_cpu, r_cpu = g.cpu(), rois.cpu()
        want = torch.autograd.grad(multiscale_roi_align_batched_plain(f_cpu, r_cpu, FPN_STRIDES),
                                   f_cpu, g_cpu)
        limits = sum_order_tolerance(
            lambda xs: multiscale_roi_align_batched_plain(xs, r_cpu, FPN_STRIDES), f_cpu, g_cpu,
            dtype)
        plain_out = multiscale_roi_align_batched_plain(f, rois, FPN_STRIDES)
        errs = [float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)]
        gmax = [float(w.float().abs().max()) for w in want]
        ratios = [limit_ratio(a, w, lim) for a, w, lim in zip(got, want, limits)]
        ok = all(a.dtype == dtype for a in got) and all(r <= 1.0 for r in ratios) and bitwise
        if not ok:
            raise AssertionError(f"multiscale backward {label} {dtype}: max |dF - twin| / limit "
                                 f"per level {ratios}, max err per level {errs}, max|dF| {gmax}, "
                                 f"two runs bitwise equal {bitwise}")
        t = kernel_ms(lambda: _multiscale_roi_align_bwd_cuda(
            g, rois, shapes, fd, FPN_STRIDES, 7, 2), 10)
        ms = t["ms"]
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, f, g, retain_graph=True), 3)
        nbytes = (g.numel() * g.element_size() + rois.numel() * 4
                  + sum(m.numel() * m.element_size() for m in f))
        bound, by = bound_ms(nbytes, roi_align_flops(g.numel()))
        print(f"roi_align_multiscale backward {label} {str(dtype).split('.')[-1]} dOut "
              f"{tuple(g.shape)}, RoIs per level p2..p5 {counts}: max |dF - twin| / sum-order "
              f"limit per level {ratios}; max abs err per level {errs} = "
              f"{[e / m if m else 0.0 for e, m in zip(errs, gmax)]} x max|dF| per level {gmax}; "
              f"two runs bitwise equal; kernel {spread(t)} (the float32-atomic kernel it "
              f"replaced: {REPLACED_MS_BWD_MS[label][dtype == torch.float32]} ms, PERF.md), plain "
              f"twin's autograd "
              f"backward on the card {plain_ms} ms, bound {bound} ms ({by}: dOut, the rois and "
              f"each map's gradient once)")
        results[dtype] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by, "limit_ratio": max(ratios)}
        del plain_out
    return results


def bev_points(rng, b, p, grid):
    """(b, p, 5) points and (b, p) valid over the BEV grid: a random cloud
    with points exactly on cell and slice boundaries, invalid lanes, points
    outside x, y and z, 40 points in one voxel, and frame 1 all invalid
    (all zeros)."""
    (x0, x1), (y0, y1), (z0, z1) = grid["x_range"], grid["y_range"], grid["z_range"]
    nx, ny, ns, vh = grid["num_x"], grid["num_y"], grid["num_slices"], grid["voxel_height"]
    pts = np.stack([rng.uniform(x0 - 5, x1 + 5, (b, p)), rng.uniform(y0 - 5, y1 + 5, (b, p)),
                    rng.uniform(z0 - 1, z1 + 1, (b, p)), rng.uniform(0, 1, (b, p)),
                    rng.uniform(0, 0.3, (b, p))], -1).astype(np.float32)
    valid = rng.uniform(size=(b, p)) < 0.9
    n = p // 4  # on the boundaries, including the grid's own edges
    pts[:, :n, 0] = x0 + rng.randint(-1, nx + 2, (b, n)) * ((x1 - x0) / nx)
    pts[:, :n, 1] = y0 + rng.randint(-1, ny + 2, (b, n)) * ((y1 - y0) / ny)
    pts[:, :n, 2] = z0 + rng.randint(-1, ns + 2, (b, n)) * vh
    pts[:, n:n + 40, :3] = [x0 + 1.01, y0 + 1.01, z0 + 0.26]  # one over-full voxel
    valid[:, n:n + 40] = True
    pts[1], valid[1] = 0.0, False
    return pts, valid


def skew_points(rng, b, p, grid):
    """bev_points with frame 0's points all valid and all inside one 8 x 32
    tile of the raster (cells y 24-31, x 64-95), 40 of them in one voxel:
    one tile holds a whole frame, many times the 256 x 4 entries the
    voxelizer's tile block takes a round."""
    pts, valid = bev_points(rng, b, p, grid)
    (x0, x1), (y0, y1), (z0, _) = grid["x_range"], grid["y_range"], grid["z_range"]
    px, py = (x1 - x0) / grid["num_x"], (y1 - y0) / grid["num_y"]
    cx, cy = 64, 24
    pts[0, :, 0] = x0 + (cx + rng.uniform(0.001, 0.999, p) * 32) * px
    pts[0, :, 1] = y0 + (cy + rng.uniform(0.001, 0.999, p) * 8) * py
    pts[0, :, 2] = rng.uniform(z0, z0 + grid["num_slices"] * grid["voxel_height"], p)
    pts[0, :40, :3] = [x0 + (cx + 5.5) * px, y0 + (cy + 2.5) * py, z0 + 0.26]
    valid[0] = True
    return pts, valid


# The scatter-and-finalize voxelizer's device ms at these checks' grids, before
# the binned tile pass replaced it (PERF.md section 6: chip_smoke.py on an
# NVIDIA H100 80GB HBM3, 700.00 W)
REPLACED_VOX_MS = {(400, 350): 0.1872, (800, 700): 0.7251}


def check_voxelize(rng, cfg, frame_scale, p, skew=False):
    """The voxelizer kernel against its twin (CPU copy) and its time: height
    and density channels equal and equal over two runs, meta within 1e-5,
    the all-invalid frame zero.  skew: frame 0's points all in one tile."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import (
        raster_kwargs,
        voxelize_bev,
        voxelize_bev_plain,
    )

    grid = raster_kwargs(cfg, frame_scale)
    pts, valid = (skew_points if skew else bev_points)(rng, B, p, grid)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    dp, dv = tp.cuda(), tv.cuda()
    got = voxelize_bev(dp, dv, **grid)
    again = voxelize_bev(dp, dv, **grid)
    torch.cuda.synchronize()
    got, again = got.cpu(), again.cpu()
    want = voxelize_bev_plain(tp, tv, **grid)
    s = grid["num_slices"]
    exact = torch.equal(got[..., :s + 1], want[..., :s + 1])
    repeat = torch.equal(got[..., :s + 1], again[..., :s + 1])
    err = float((got - want).abs().max())
    meta_err = float((got[..., s + 1:] - want[..., s + 1:]).abs().max())
    if not exact or not repeat or not meta_err <= 1e-5 or bool(got[1].any()):
        raise AssertionError(f"voxelize_bev {tuple(got.shape)} skew {skew}: height/density equal "
                             f"{exact}, equal over two runs {repeat}, meta err {meta_err}, "
                             f"all-invalid frame zero {not bool(got[1].any())}")
    if skew and not float(want[0, 24:32, 64:96, s].max()) == 1.0:
        raise AssertionError("voxelize_bev skew: the over-full voxel is not capped at 1.0")
    t = kernel_ms(lambda: voxelize_bev(dp, dv, **grid), 20)
    ms = t["ms"]
    plain_ms = cuda_ms(lambda: voxelize_bev_plain(dp, dv, **grid), 3)
    # float32 operations: ~11 a point (subtract, scale, floor per axis; the
    # height), ~2 per slice and ~50 for the two divisions and tanhs a column
    n_cols = got.numel() // got.shape[-1]
    flops = dv.numel() * 11 + n_cols * (2 * s + 50)
    bound, by = bound_ms(dp.numel() * 4 + dv.numel() + got.numel() * 4, flops)
    hw = tuple(got.shape[1:3])
    replaced = (f"the scatter-and-finalize kernel it replaced: {REPLACED_VOX_MS[hw]} ms, PERF.md"
                if not skew else "the replaced kernel was not timed on this case")
    print(f"voxelize_bev points {tuple(dp.shape)} -> {tuple(got.shape)}"
          f"{' (frame 0: every point in one tile)' if skew else ''}: height and density "
          f"channels equal, and equal over two runs; meta channels max err {meta_err} (limit "
          f"1e-5), filled cells {int((want[..., s] > 0).sum())}; kernel {spread(t)} ({replaced}), "
          f"plain twin on the card {plain_ms} ms, bound {bound} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def scale_terminators(model, value=0.25):
    """Residual-terminator BN scales to `value`, as bench.py does for random
    weights, so res101's activations stay finite."""
    import torch

    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith(".bn3"):
                m.weight.fill_(value)
    return model


def iou_plus1(a, b):
    import torch

    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2])
          - torch.maximum(a[:, None, 0], b[None, :, 0]) + 1).clamp(min=0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3])
          - torch.maximum(a[:, None, 1], b[None, :, 1]) + 1).clamp(min=0)
    inter = iw * ih
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def split_thresh(scores, valid) -> float:
    """A threshold in the widest gap among the middle third of the valid
    rois' scores (pad slots repeat the top box), so about half pass and none
    sits within backend noise of it."""
    s = np.sort(scores[valid].numpy().ravel())
    lo, hi = s.size // 3, max(s.size // 3 + 1, 2 * s.size // 3)
    i = lo + int(np.argmax(np.diff(s[lo:hi + 1])))
    return float((s[i] + s[i + 1]) / 2)


def feature_err(got, want):
    """(max |card - CPU|, max |CPU|) over a feature map or a pyramid."""
    gs, ws = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    return (max(float((g.cpu() - w).abs().max()) for g, w in zip(gs, ws)),
            max(float(w.abs().max()) for w in ws))


def check_slice(cfg_base):
    """res101 float32 on one 256x320 frame: card against CPU."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import filter_detections

    cfg = cfg_from_list(cfg_base, ("COMPUTE_DTYPE", "float32"))
    cpu = scale_terminators(build_detector(cfg, 2, "cpu", seed=1))
    gpu = scale_terminators(build_detector(cfg, 2, "cuda", seed=1))
    rng = np.random.RandomState(2)
    h, w = SLICE_HW
    x = torch.from_numpy(rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8))
    win = torch.tensor([[0.0, float(w), 0.0, float(h)]])
    with torch.inference_mode():
        c_feat = cpu.features(x)
        c_rpn = cpu.rpn_scores(c_feat)
        c_out = cpu.forward_test(x, win)
        g_feat = gpu.features(x.cuda())
        g_rpn = gpu.rpn_scores(g_feat)
        g_out = {k: v.cpu() for k, v in gpu.forward_test(x.cuda(), win.cuda()).items()}
        # second stage on the CPU's rois (pinned), so the comparison isolates it
        g_cls, g_boxes = gpu.classify_rois(g_feat, c_out["rois"].cuda(), win.cuda())
    feat_err, feat_max = feature_err(g_feat, c_feat)
    fg_err = float((g_rpn["fg_prob"].cpu() - c_rpn["fg_prob"]).abs().max())
    delta_err = float((g_rpn["deltas"].cpu() - c_rpn["deltas"]).abs().max())
    cls_err = float((g_cls.cpu() - c_out["cls_prob"]).abs().max())
    box_err = float((g_boxes.cpu() - c_out["bbox_pred"]).abs().max())
    cr = c_out["rois"][0][c_out["roi_valid"][0]]
    gr = g_out["rois"][0][g_out["roi_valid"][0]]
    matched = int((iou_plus1(cr, gr).max(dim=1).values >= 0.99).sum())
    fm = "p2..p5" if cfg.use_fpn else "C4"
    print(f"slice {'FPN ' if cfg.use_fpn else ''}res101 fp32 {h}x{w}: {fm} max err {feat_err} "
          f"(max|{fm}| {feat_max}); "
          f"fg_prob {fg_err}; deltas {delta_err}; proposals matched {matched}/{len(cr)} "
          f"at IoU >= 0.99; pinned cls_prob {cls_err}; pinned boxes {box_err} px")
    checks = {
        f"{fm} features": feat_err <= 1e-4 * feat_max,
        "fg_prob": fg_err <= 2e-3,
        "deltas": delta_err <= 2e-3,
        "proposals": len(cr) > 0 and matched >= 0.95 * len(cr),
        "cls_prob": cls_err <= 3e-3 * float(c_out["cls_prob"].abs().max()),
        "boxes": box_err <= 0.15,
    }
    kw = dict(num_classes=2, bbox_elem=4, max_dets=100,
              thresh=split_thresh(c_out["cls_prob"][..., 1], c_out["roi_valid"]), nms_thresh=0.6)
    cf = filter_detections(c_out["cls_prob"], c_out["bbox_pred"], c_out["roi_valid"], **kw)
    gf = filter_detections(*(g_out[k].cuda() for k in ("cls_prob", "bbox_pred", "roi_valid")), **kw)
    cb = cf["boxes"][0, 1][cf["valid"][0, 1]]
    gb = gf["boxes"][0, 1][gf["valid"][0, 1]].cpu()
    det_match = len(cb) == len(gb) and (
        len(cb) == 0 or bool((iou_plus1(cb, gb).max(dim=1).values >= 0.99).all()))
    print(f"slice final detections: cpu {len(cb)}, card {len(gb)}, matched {det_match}")
    checks["detections"] = det_match
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slice card vs CPU out of tolerance: {failed}")


def run_serving(cfg, smi, need=("nms", "roi_align"), never=()):
    """The image serving path: warm-up batch, then 3 batches, counted; the
    kernels in `need` must have launched and those in `never` not."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import (
        detect_batch,
        evaluate,
        filter_batch,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

    batches = 3
    db = SyntheticDataset(cfg, num_frames=batches * B, num_classes=2, image_hw=FRAME_HW,
                          mode="val", seed=101)
    loader = BatchLoader(db, cfg, batch_size=B, device="cuda", augment=False, shuffle=False,
                         seed=0)
    model = scale_terminators(build_detector(cfg, 2, "cuda", seed=0))
    warm = loader.peek()  # the first evaluated batch, run once to warm up
    filter_batch(model, detect_batch(model, warm), cfg.test.thresh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = evaluate(model, loader, db, batches * B, cfg.test.thresh)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    ms = np.asarray(res["detect_ms"]) + np.asarray(res["filter_ms"])
    name = "FPN serving" if cfg.use_fpn else "serving"
    print(f"{name} res101 bf16 {FRAME_HW[0]}x{FRAME_HW[1]} batch {B} ({smi}): "
          f"detect ms/batch {res['detect_ms']}, filter ms/batch {res['filter_ms']}, "
          f"mean {float(ms.mean())} ms/batch, {B * len(ms) / (float(ms.sum()) / 1e3)} frames/s, "
          f"peak memory {peak / 2**30} GiB, random-weight mAP {res['mAP']}")
    print(f"{name}: outputs finite {res['finite']}, fewest proposals in a frame "
          f"{res['min_proposals']}, kernel launches {launches}")
    if not res["finite"]:
        raise AssertionError(f"{name}: non-finite outputs")
    if not res["min_proposals"] or res["min_proposals"] <= 0:
        raise AssertionError(f"{name}: a frame has no valid proposal")
    if not all(launches[k] > 0 for k in need) or any(launches[k] for k in never):
        raise AssertionError(f"{name}: launches {launches}, needed {need}, never {never}")
    return launches


TRAIN_LEAVES = (
    "rpn.rpn_cls_score_net.weight", "rpn.rpn_bbox_pred_net.weight",
    "predictors.cls_score_net.weight", "predictors.bbox_pred_net.weight",
    "tail.layer4.0.conv1.weight",
)
FPN_TRAIN_LEAVES = TRAIN_LEAVES[:4] + (
    "tail.t_fc1.weight", "fpn.latlayer2.weight", "fpn.aalayer2.weight",
    "backbone.layer4.0.conv1.weight",
)
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box")


def train_slice_batch(cfg, cpu, rng):
    """One training frame for the train slice and its GT, jittered copies of
    some of the CPU model's proposals (so proposals are sampled as fg):
    image: a random 256x320 frame, (1, G, 5) GT; lidar: a synthetic 400 x 350
    x 15 raster (the voxelizer's twin), (1, G, 8) 7-DoF GT on the proposals'
    footprints and their 3D anchors' z and h, turned by up to 0.3 rad."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs, voxelize_bev

    lidar = cfg.net_type == "lidar"
    if lidar:
        frame = SyntheticDataset(cfg, num_frames=1, mode="train", seed=7).frame(0)
        pts = torch.from_numpy(frame["points"])[None]
        x = voxelize_bev(pts, torch.ones(pts.shape[:2], dtype=torch.bool),
                         **raster_kwargs(cfg, float(cfg.train.scales[0])))
        win = torch.from_numpy(frame["window"])[None]
    else:
        h, w = SLICE_HW
        x = torch.from_numpy(rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8))
        win = torch.tensor([[0.0, float(w), 0.0, float(h)]])
    with torch.no_grad():
        feat = cpu.features(x)
        fm = cpu.rpn_map(feat)
        anchors, anchors_3d = cpu.anchor_grids(fm.shape[1], fm.shape[2], "cpu", "train")
        rois, _scores, valid, src = cpu._propose_batch(cpu.rpn_scores(feat), anchors, win, "train")
    pick = torch.nonzero(valid[0])[:, 0][::9][:6]
    props, n = rois[0][pick], len(pick)
    mask = torch.zeros((1, cfg.static.max_gt), dtype=torch.bool)
    mask[0, :n] = True
    if not lidar:
        gt = torch.zeros((1, cfg.static.max_gt, 5))
        gt[0, :n, :4] = props + torch.from_numpy(rng.uniform(-2, 2, (n, 4)).astype(np.float32))
        gt[0, :n, 4] = 1
        return x, win, gt, mask
    a3d = anchors_3d[src[0][pick]]
    jitter = lambda lo, hi, *shape: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, (n,) + shape).astype(np.float32))
    gt = torch.zeros((1, cfg.static.max_gt, 8))
    gt[0, :n, 0:2] = (props[:, :2] + props[:, 2:]) / 2 + jitter(-1, 1, 2)
    gt[0, :n, 2] = a3d[:, 2]
    gt[0, :n, 3:5] = (props[:, 2:] - props[:, :2]) * jitter(0.9, 1.1, 2)
    gt[0, :n, 5] = a3d[:, 5]
    gt[0, :n, 6] = jitter(-0.3, 0.3)
    gt[0, :n, 7] = 1
    return x, win, gt, mask


def check_train_slice(cfg_base):
    """res101 float32 training forward and backward on one frame (image
    256x320, or a 400 x 350 x 15 BEV raster with 7-DoF GT): card against
    CPU, on the same draws; the card's second stage pinned to the CPU's
    proposal lanes (its boxes still come from the card's deltas)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import TrainDraws
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import (
        create_train_state,
        draw_train_keys,
    )

    cfg = cfg_from_list(cfg_base, (
        "COMPUTE_DTYPE", "float32", "TRAIN.ROI_BATCH_SIZE", "64",
        "STATIC.NMS_PRE_TRAIN", "1024", "TRAIN.RPN_POST_NMS_TOP_N", "256",
    ))
    cpu, _ = create_train_state(cfg, 2, "cpu", seed=1)
    gpu, _ = create_train_state(cfg, 2, "cuda", seed=1)
    scale_terminators(cpu), scale_terminators(gpu)
    rng = np.random.RandomState(3)
    x, win, gt, mask = train_slice_batch(cfg, cpu, rng)
    batch = {"data": x, "gt_boxes": gt, "gt_mask": mask, "window": win}
    draws = draw_train_keys(cpu, batch, torch.Generator().manual_seed(4))
    c_losses, c_aux = cpu.forward_train(x, gt, mask, win, draws)
    c_losses["total_loss"].backward()
    pin = (c_aux.proposal_src.cuda(), c_aux.proposal_valid.cuda())
    g_draws = TrainDraws(*(None if t is None else t.cuda() for t in draws))
    g_losses, g_aux = gpu.forward_train(x.cuda(), gt.cuda(), mask.cuda(), win.cuda(), g_draws,
                                        proposals=pin)
    g_losses["total_loss"].backward()
    torch.cuda.synchronize()

    checks = {
        "anchor samples": torch.equal(g_aux.anchor_targets.sel.cpu(), c_aux.anchor_targets.sel)
        and torch.equal(g_aux.anchor_targets.labels.cpu(), c_aux.anchor_targets.labels),
        "roi labels": torch.equal(g_aux.proposal_targets.labels.cpu(), c_aux.proposal_targets.labels),
    }
    loss_err = {}
    for k in LOSSES:
        c, g = float(c_losses[k].detach()), float(g_losses[k].detach())
        loss_err[k] = abs(g - c) / max(abs(c), 1e-12)
        checks[f"loss {k}"] = loss_err[k] <= 1e-3 and np.isfinite(g)
    grad_err = {}
    c_params, g_params = dict(cpu.named_parameters()), dict(gpu.named_parameters())
    last_layer3 = f"backbone.layer3.{len(cpu.backbone.layer3) - 1}.conv3.weight"
    for name in (FPN_TRAIN_LEAVES if cfg.use_fpn else TRAIN_LEAVES) + (last_layer3,):
        cg, gg = c_params[name].grad, g_params[name].grad
        scale = float(cg.abs().max())
        grad_err[name] = float((gg.cpu() - cg).abs().max()) / scale
        checks[f"grad {name}"] = scale > 0 and grad_err[name] <= 1e-3
    labels = c_aux.proposal_targets.labels
    kind = "BEV " if cfg.net_type == "lidar" else "FPN " if cfg.use_fpn else ""
    print(f"train slice {kind}{cfg.net_variant} fp32 {tuple(x.shape)}: losses cpu "
          f"{ {k: float(c_losses[k].detach()) for k in LOSSES} }, relative errors {loss_err} "
          f"(rpn losses unpinned, second stage pinned); sampled RoIs fg {int((labels > 0).sum())} "
          f"bg {int((labels == 0).sum())}; gradient error / max|g| per leaf {grad_err}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train slice card vs CPU out of tolerance: {failed}")


def run_training(cfg, smi, need=("nms", "roi_align", "roi_align_bwd")):
    """The training path: warm-up step, then TRAIN_STEPS steps, counted; the
    kernels in `need` must have launched.  Image frames are 512x960; a lidar
    config's loader rasterizes synthetic LiDAR frames on the card."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import create_train_state, train

    db = SyntheticDataset(cfg, num_frames=4 * B, num_classes=2, image_hw=FRAME_HW, seed=0)
    loader = BatchLoader(db, cfg, batch_size=B, device="cuda", seed=0)
    model, optimizer = create_train_state(cfg, 2, "cuda", seed=0)
    scale_terminators(model)
    generator = torch.Generator(device="cuda").manual_seed(0)
    warm = train(model, optimizer, loader, 1, generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = train(model, optimizer, loader, TRAIN_STEPS, generator)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    ms = np.asarray(res["ms"])
    finite = all(np.isfinite(v) for losses in warm["losses"] + res["losses"] for v in losses.values())
    lidar = cfg.net_type == "lidar"
    name = "BEV training" if lidar else "FPN training" if cfg.use_fpn else "training"
    frames = (f"raster {tuple(loader.peek()['data'].shape)}" if lidar
              else f"{FRAME_HW[0]}x{FRAME_HW[1]}")
    print(f"{name} {cfg.net_variant} {cfg.compute_dtype} {frames} batch {B} ({smi}): "
          f"warm-up step {warm['ms'][0]} ms; ms/step {res['ms']}; mean {float(ms.mean())} ms, "
          f"median {float(np.median(ms))} ms, {B / (float(ms.mean()) / 1e3)} frames/s, "
          f"peak memory {peak / 2**30} GiB")
    for i, losses in enumerate(res["losses"]):
        print(f"  step {i + 1}: " + ", ".join(f"{k} {v}" for k, v in losses.items()))
    print(f"{name}: losses finite {finite}, kernel launches {launches}")
    if not finite:
        raise AssertionError(f"{name}: a non-finite loss")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"{name}: a kernel never launched: {launches}")
    return launches


def measure_anchor_targets(cfg, smi):
    """anchor_target alone (plain torch: the IoU of every anchor with every
    GT box, labels, sampling, regression targets) at the FPN training shape:
    8 frames x 768,000 anchors x 64 GT boxes.  Times by CUDA events; peak
    memory above what was allocated before the call."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import (
        build_anchor_grid,
        feat_stride,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.iou import bbox_overlaps
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.targets import (
        anchor_target,
        effective_rpn_overlaps,
    )

    s = feat_stride(cfg)
    fh, fw = -(-FRAME_HW[0] // s), -(-FRAME_HW[1] // s)
    anchors = torch.from_numpy(build_anchor_grid(cfg, fh, fw, float(cfg.train.scales[0]))[0]).cuda()
    rng = np.random.RandomState(9)
    g = cfg.static.max_gt
    gt = np.zeros((B, g, 5), np.float32)
    gt[..., :4] = np.stack([random_boxes(rng, g) for _ in range(B)])
    gt[..., 4] = 1
    gt = torch.from_numpy(gt).cuda()
    mask = torch.ones((B, g), dtype=torch.bool, device="cuda")
    win = torch.tensor([[0.0, FRAME_HW[1], 0.0, FRAME_HW[0]]] * B, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = anchors.shape[0]
    kf, kb = (torch.rand((B, n), generator=gen, device="cuda") for _ in range(2))
    pos, neg = effective_rpn_overlaps(cfg)
    c = cfg.train

    def run():
        return anchor_target(anchors, gt, mask, win, kf, kb, rpn_batchsize=c.rpn_batchsize,
                             fg_fraction=c.rpn_fg_fraction, positive_overlap=pos,
                             negative_overlap=neg, clobber_positives=c.rpn_clobber_positives)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    at = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(run, 5)
    iou_ms = cuda_ms(lambda: bbox_overlaps(anchors, gt[..., :4]), 5)
    fg = int((at.labels == 1).sum())
    print(f"anchor_target ({B}, {n} anchors, {g} GT) ({smi}): {ms} ms, peak memory above the "
          f"inputs {peak / 2**30} GiB; bbox_overlaps alone {iou_ms} ms for the "
          f"({B}, {n}, {g}) float32 IoU tensor ({B * n * g * 4 / 2**30} GiB); {fg} fg anchors "
          f"sampled")
    return {"anchor_target_ms": ms, "bbox_overlaps_ms": iou_ms, "peak_gib": peak / 2**30}


def bev_aabb(boxes7):
    """BEV footprint x1y1x2y2 (center +- l/2, w/2) of (N, 7) boxes, as the
    lidar NMS sees them."""
    import torch

    half = boxes7[:, 3:5] / 2
    return torch.cat([boxes7[:, :2] - half, boxes7[:, :2] + half], dim=1)


def check_bev_slice(cfg_base):
    """res101 float32 on one synthetic 400 x 350 LiDAR frame: card (the
    voxelizer, NMS and RoI-align kernels) against CPU (their twins)."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import filter_detections
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs, voxelize_bev

    cfg = cfg_from_list(cfg_base, ("COMPUTE_DTYPE", "float32"))
    cpu = scale_terminators(build_detector(cfg, 2, "cpu", seed=1))
    gpu = scale_terminators(build_detector(cfg, 2, "cuda", seed=1))
    frame = SyntheticDataset(cfg, num_frames=1, mode="val", seed=7).frame(0)
    pts = torch.from_numpy(frame["points"])[None]
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    grid = raster_kwargs(cfg, float(cfg.train.scales[0]))
    win = torch.from_numpy(frame["window"])[None]
    with torch.inference_mode():
        c_x = voxelize_bev(pts, valid, **grid)
        g_x = voxelize_bev(pts.cuda(), valid.cuda(), **grid)
        c_feat = cpu.features(c_x)
        c_rpn = cpu.rpn_scores(c_feat)
        c_out = cpu.forward_test(c_x, win)
        g_feat = gpu.features(g_x)
        g_rpn = gpu.rpn_scores(g_feat)
        g_out = {k: v.cpu() for k, v in gpu.forward_test(g_x, win.cuda()).items()}
        # second stage on the CPU's rois and 3D anchors (pinned)
        g_cls, g_boxes = gpu.classify_rois(g_feat, c_out["rois"].cuda(), win.cuda(),
                                           c_out["anchors_3d"].cuda())
    s = cfg.lidar.num_slices
    raster_equal = torch.equal(g_x[..., :s + 1].cpu(), c_x[..., :s + 1])
    meta_err = float((g_x[..., s + 1:].cpu() - c_x[..., s + 1:]).abs().max())
    feat_err = float((g_feat.cpu() - c_feat).abs().max())
    feat_max = float(c_feat.abs().max())
    fg_err = float((g_rpn["fg_prob"].cpu() - c_rpn["fg_prob"]).abs().max())
    cls_err = float((g_cls.cpu() - c_out["cls_prob"]).abs().max())
    box_err = float((g_boxes.cpu() - c_out["bbox_pred"]).abs().max())
    cr = c_out["rois"][0][c_out["roi_valid"][0]]
    gr = g_out["rois"][0][g_out["roi_valid"][0]]
    matched = int((iou_plus1(cr, gr).max(dim=1).values >= 0.99).sum())
    print(f"BEV slice res101 fp32 {tuple(c_x.shape)}: raster height/density equal {raster_equal}, "
          f"meta err {meta_err}; C4 max err {feat_err} (max|C4| {feat_max}); fg_prob {fg_err}; "
          f"proposals matched {matched}/{len(cr)} at IoU >= 0.99; pinned cls_prob {cls_err}; "
          f"pinned 7-DoF boxes {box_err} voxels")
    checks = {
        "raster": raster_equal and meta_err <= 1e-5,
        "C4 features": feat_err <= 1e-4 * feat_max,
        "fg_prob": fg_err <= 2e-3,
        "proposals": len(cr) > 0 and matched >= 0.95 * len(cr),
        "cls_prob": cls_err <= 3e-3 * float(c_out["cls_prob"].abs().max()),
        "boxes": box_err <= 0.15,
    }
    kw = dict(num_classes=2, bbox_elem=7, max_dets=100, is_lidar=True,
              thresh=split_thresh(c_out["cls_prob"][..., 1], c_out["roi_valid"]), nms_thresh=0.6)
    cf = filter_detections(c_out["cls_prob"], c_out["bbox_pred"], c_out["roi_valid"], **kw)
    gf = filter_detections(*(g_out[k].cuda() for k in ("cls_prob", "bbox_pred", "roi_valid")), **kw)
    cb = cf["boxes"][0, 1][cf["valid"][0, 1]]
    gb = gf["boxes"][0, 1][gf["valid"][0, 1]].cpu()
    det_match = len(cb) == len(gb) and (
        len(cb) == 0 or bool((iou_plus1(bev_aabb(cb), bev_aabb(gb)).max(dim=1).values >= 0.99).all()))
    print(f"BEV slice final detections: cpu {len(cb)}, card {len(gb)}, matched {det_match}")
    checks["detections"] = det_match and len(cb) > 0
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"BEV slice card vs CPU out of tolerance: {failed}")


def run_bev_serving(cfg, smi, need=("voxelize_bev", "nms", "roi_align")):
    """The BEV serving path: warm-up batch, then 3 batches, counted; the
    kernels in `need` must have launched.  Returns the launches and the
    batch's ms, frames/s and peak memory."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import (
        detect_batch,
        evaluate,
        filter_batch,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

    batches = 3
    db = SyntheticDataset(cfg, num_frames=batches * B, num_classes=2, mode="val", seed=101)
    loader = BatchLoader(db, cfg, batch_size=B, device="cuda", augment=False, shuffle=False,
                         seed=0)
    model = scale_terminators(build_detector(cfg, 2, "cuda", seed=0))
    warm = loader.peek()  # the first evaluated batch, run once to warm up
    filter_batch(model, detect_batch(model, warm), cfg.test.thresh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = evaluate(model, loader, db, batches * B, cfg.test.thresh)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    # the peeked batch was rasterized before the counts were reset
    raster = np.asarray(res["raster_ms"][1:])
    ms = np.asarray(res["detect_ms"][1:]) + np.asarray(res["filter_ms"][1:]) + raster
    shape = tuple(warm["data"].shape)
    name = "rotated BEV serving" if cfg.test.rotated_nms else "BEV serving"
    print(f"{name} {cfg.net_variant} {cfg.compute_dtype} raster {shape} batch {B} "
          f"({smi}): voxelize ms/batch {res['raster_ms']}, detect ms/batch {res['detect_ms']}, "
          f"filter ms/batch {res['filter_ms']}; batches 2-3 mean {float(ms.mean())} ms/batch, "
          f"{B * len(ms) / (float(ms.sum()) / 1e3)} frames/s; peak memory {peak / 2**30} GiB; "
          f"random-weight mAP ({res['eval_type']} @ {res['iou_thresh']}) {res['mAP']}")
    print(f"{name} (final NMS {'rotated' if cfg.test.rotated_nms else 'axis-aligned'} @ "
          f"{cfg.test.nms_thresh}): outputs finite {res['finite']}, fewest proposals in a frame "
          f"{res['min_proposals']}, kernel launches {launches}")
    if not res["finite"]:
        raise AssertionError(f"{name}: non-finite outputs")
    if not res["min_proposals"] or res["min_proposals"] <= 0:
        raise AssertionError(f"{name}: a frame has no valid proposal")
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"{name}: a kernel never launched: {launches}")
    return launches, {"ms": float(ms.mean()), "fps": B * len(ms) / (float(ms.sum()) / 1e3),
                      "peak_gib": peak / 2**30}


def main() -> int:
    if not (REPO / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = smi_name_power()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN (parity phases)")

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

    phase("build")
    t0 = time.perf_counter()
    path, seconds, log = _build.build()
    _build.library()
    print(f"built {path} in {seconds} s (load {time.perf_counter() - t0} s)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    image_cfg = make_config(IMAGE_OVERRIDES)
    bev_cfg = make_config(BEV_OVERRIDES, BEV_SERVING_OVERRIDES)
    bev_train_cfg = make_config(BEV_OVERRIDES)
    bev_rotated_cfg = make_config(BEV_OVERRIDES, BEV_SERVING_OVERRIDES, ROTATED_OVERRIDES)

    phase("kernels vs plain twins")
    rng = np.random.RandomState(0)
    nms_prop = check_nms("proposals", B, 2048, 0.7, 300, rng)
    nms_filter = check_nms("final filter", 2 * B, 300, 0.6, 100, rng)
    nms_train = check_nms("train proposals", B, 4096, 0.7, 2000, rng)
    nms_bev = check_nms("BEV proposals", B, BEV_ANCHORS, 0.7, 300, rng)
    nms_bev_filter = check_nms("BEV final filter", 2 * B, 300, 0.6, 100, rng)
    nms_rot = check_rotated(2 * B, 300, 0.3, 100, rng)
    roi = check_roi_align(rng, (H_FEAT, W_FEAT))
    roi_bev = check_roi_align(rng, BEV_FEAT_HW)
    roi_bwd = check_roi_align_backward(rng, (H_FEAT, W_FEAT))
    ms_fwd = check_multiscale_roi_align(rng)
    ms_bwd = check_multiscale_backward(rng, fpn_rois(rng, B, R_TRAIN), "16-900 px RoIs")
    ms_bwd_p5 = check_multiscale_backward(rng, p5_rois(rng, B, R_TRAIN), "every RoI on p5")
    vox_waymo = check_voxelize(rng, bev_cfg, 1.0, 180000)
    vox = check_voxelize(rng, bev_cfg, 0.5, bev_cfg.static.max_points)
    # the BEV training path's shapes (NMS_PRE_TRAIN of the 1,100 anchors, 256
    # RoIs a frame on the 25 x 22 map), from a stream of their own so that
    # the checks above keep their inputs
    rng_bev_train = np.random.RandomState(1)
    nms_bev_train = check_nms("BEV train proposals", B, bev_train_cfg.static.nms_pre_train, 0.7,
                              bev_train_cfg.train.rpn_post_nms_top_n, rng_bev_train)
    roi_bev_train = check_roi_align(rng_bev_train, BEV_FEAT_HW, R_TRAIN)
    roi_bwd_bev = check_roi_align_backward(rng_bev_train, BEV_FEAT_HW)
    # every point of one frame in one tile of the raster, and the multiscale
    # forward with every RoI on p2, from a third stream
    rng_skew = np.random.RandomState(2)
    vox_skew = check_voxelize(rng_skew, bev_cfg, 0.5, bev_cfg.static.max_points, skew=True)
    vox_skew_waymo = check_voxelize(rng_skew, bev_cfg, 1.0, 180000, skew=True)
    ms_fwd_p2 = check_multiscale_roi_align(rng_skew, p2_rois(rng_skew, B, R), "every RoI on p2")

    serving_cfg = make_config(IMAGE_OVERRIDES, SERVING_OVERRIDES)

    phase("slice: card vs CPU")
    check_slice(serving_cfg)

    phase("serving path")
    serving = run_serving(serving_cfg, smi)

    phase("training slice: card vs CPU")
    check_train_slice(image_cfg)

    phase("training path")
    training = run_training(image_cfg, smi)

    phase("BEV slice: card vs CPU")
    check_bev_slice(bev_cfg)

    phase("BEV serving path")
    bev_serving, bev_stats = run_bev_serving(bev_cfg, smi)

    phase("BEV training slice: card vs CPU")
    check_train_slice(bev_train_cfg)

    phase("BEV training path")
    bev_training = run_training(bev_train_cfg, smi,
                                need=("voxelize_bev", "nms", "roi_align", "roi_align_bwd"))

    phase("rotated BEV serving path")
    bev_rotated, rot_stats = run_bev_serving(
        bev_rotated_cfg, smi, need=("voxelize_bev", "nms", "nms_rotated", "roi_align"))
    # the final filter's NMS moves from the axis-aligned kernel to the rotated one
    if not (bev_rotated["nms_rotated"] == bev_serving["nms"] - bev_rotated["nms"] > 0):
        raise AssertionError(f"rotated BEV serving: launches {bev_rotated} against the "
                             f"axis-aligned path's {bev_serving}")
    print(f"rotated vs axis-aligned BEV serving, one call ({smi}): {rot_stats['ms']} vs "
          f"{bev_stats['ms']} ms/batch, {rot_stats['fps']} vs {bev_stats['fps']} frames/s, peak "
          f"memory {rot_stats['peak_gib']} vs {bev_stats['peak_gib']} GiB; filter NMS launches "
          f"moved: nms {bev_serving['nms']} -> {bev_rotated['nms']}, nms_rotated "
          f"{bev_rotated['nms_rotated']}")

    fpn_cfg = make_config(IMAGE_OVERRIDES, FPN_OVERRIDES)
    fpn_serving_cfg = make_config(IMAGE_OVERRIDES, FPN_OVERRIDES, SERVING_OVERRIDES)

    phase("FPN slices: card vs CPU")
    # at init the top-scored anchors of the stride-4 grid are mostly large
    # boxes clipped to the frame, which NMS folds together: a wider
    # candidate pool keeps more proposals to compare
    check_slice(make_config(IMAGE_OVERRIDES, FPN_OVERRIDES, SERVING_OVERRIDES,
                            ("STATIC.NMS_PRE_TEST", "6000")))
    check_train_slice(fpn_cfg)

    phase("FPN serving path")
    fpn_serving = run_serving(fpn_serving_cfg, smi, need=("nms", "roi_align_multiscale"),
                              never=("roi_align",))

    phase("FPN training path")
    fpn_training = run_training(fpn_cfg, smi, need=(
        "nms", "roi_align_multiscale", "roi_align_multiscale_bwd"))
    measure_anchor_targets(fpn_cfg, smi)

    paths = {"serving": serving, "training": training, "bev_serving": bev_serving,
             "fpn_serving": fpn_serving, "fpn_training": fpn_training,
             "bev_training": bev_training, "bev_rotated_serving": bev_rotated}

    def entry(name, source, replaces, path, measured):
        return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
                "replaces": f"faster_rcnn_pytorch_multimodal_tpu/{replaces}",
                "launches": paths[path][name],
                "launches_by_path": {k: v[name] for k, v in paths.items()},
                **measured, "library_ms": None}

    nms_err = max(r["max_abs_err"] for r in (nms_prop, nms_filter, nms_train, nms_bev,
                                             nms_bev_filter, nms_bev_train))
    kernels = {"kernels": [
        entry("voxelize_bev", "voxelize.cu", "ops/voxelize.py:39", "bev_training", vox),
        entry("nms", "nms.cu", "ops/nms.py:53", "bev_training",
              {**nms_bev_train, "max_abs_err": nms_err}),
        entry("roi_align", "roi_align.cu", "ops/roi_align.py:122", "bev_training",
              roi_bev_train[torch.bfloat16]),
        entry("roi_align_bwd", "roi_align.cu", "ops/roi_align.py:122 (VJP)", "bev_training",
              roi_bwd_bev[torch.bfloat16]),
        entry("roi_align_multiscale", "roi_align.cu", "ops/roi_align.py:208", "fpn_serving",
              ms_fwd[torch.bfloat16]),
        entry("roi_align_multiscale_bwd", "roi_align.cu", "ops/roi_align.py:208 (VJP)",
              "fpn_training", ms_bwd[torch.bfloat16]),
        entry("nms_rotated", "nms.cu", "ops/rotated_iou.py:93 (via ops/nms.py:164)",
              "bev_rotated_serving",
              {k: nms_rot[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}),
    ]}
    print("timed at the shapes of the path each entry's launches come from: voxelize_bev "
          "(8, 32768) -> (8, 400, 350, 15) (the points counting-sorted by 8 x 32 tiles of the "
          "raster, then one block a tile sums its list in shared memory and writes its cells "
          "once: no zeroed raster, no full-raster scratch); nms (8, 1024) -> 1024 slots @ 0.7 (BEV training; "
          "the IoU mask kernel, then the keep scan in 64-row blocks staged by TMA bulk copies; "
          "max_abs_err over every NMS shape); roi_align bf16 (8, 25, 22, 1024) x 256 (one warp a "
          "RoI and 128 channels: each distinct tap cell staged once by cp.async into a ring of "
          "tap rows, x-then-y sums in registers); "
          "roi_align_bwd bf16 dOut (8, 256, 7, 7, 1024) -> (8, 25, 22, 1024) (the tile gather: "
          "2 x 4 cells a block, sums in registers, no atomics, bitwise repeatable); "
          "roi_align_multiscale bf16 p2..p5 of 512x960 x (8, 300) rois of 16-900 px (the "
          "single-level forward's staged body on each RoI's level); "
          "roi_align_multiscale_bwd bf16 dOut (8, 256, 7, 7, 256) (the same tile gather over the "
          "tiles of the four levels, 4 x 4 cells on p2 and p3, 2 x 4 on p4 and p5, after a pass "
          "that lists each frame's RoIs by level: no atomics, no float32 accumulator, bitwise "
          "repeatable); nms_rotated (16, 300) -> 100 "
          "@ 0.3 (the rotated mask kernel and the same block scan; max_abs_err: its IoU kernel "
          "against the twin's IoU); library_ms null: no "
          "single PyTorch call computes these functions (torchvision's nms, roi_align and "
          "MultiScaleRoIAlign are not installed)")
    print(f"also: voxelize_bev (8, 180000) -> 800 x 700: {vox_waymo}; frame 0 in one tile: "
          f"(8, 32768) -> 400 x 350 {vox_skew}, (8, 180000) -> 800 x 700 {vox_skew_waymo}; "
          f"roi_align_multiscale every RoI on p2: bf16 {ms_fwd_p2[torch.bfloat16]}, fp32 "
          f"{ms_fwd_p2[torch.float32]}; nms (8, 2048) -> 300: "
          f"{nms_prop}; (16, 300) -> 100: {nms_filter}; (8, 4096) -> 2000: {nms_train}; "
          f"BEV (8, 1100) -> 300: {nms_bev}; BEV (16, 300) -> 100: {nms_bev_filter}; "
          f"roi_align (8, 32, 60, 1024) x 300: fp32 {roi[torch.float32]}, bf16 "
          f"{roi[torch.bfloat16]}; (8, 25, 22, 1024) x 300: fp32 {roi_bev[torch.float32]}, bf16 "
          f"{roi_bev[torch.bfloat16]}; x 256 fp32 {roi_bev_train[torch.float32]}; roi_align "
          f"backward onto (8, 32, 60, 1024): fp32 {roi_bwd[torch.float32]}, bf16 "
          f"{roi_bwd[torch.bfloat16]}; onto (8, 25, 22, 1024) fp32 {roi_bwd_bev[torch.float32]}; "
          f"roi_align_multiscale fp32 {ms_fwd[torch.float32]}; its backward fp32 "
          f"{ms_bwd[torch.float32]}; backward with every RoI on p5: fp32 "
          f"{ms_bwd_p5[torch.float32]}, bf16 {ms_bwd_p5[torch.bfloat16]}; rotated_iou (16, 300)^2 "
          f"kernel {nms_rot['iou_ms']} ms; nms_rotated problems with a kept lane's pair near the "
          f"threshold {nms_rot['near_problems']}")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
