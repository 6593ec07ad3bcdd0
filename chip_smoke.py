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
     (16, 300) -> 100 @ 0.6 (BEV serving) must keep identical lanes; RoI
     align at features (8, 32, 60, 1024) and (8, 25, 22, 1024) x 300 rois
     within 1e-5 * max|F| (float32) and 1e-2 * max|F| (bfloat16, rounded
     output); the RoI-align backward at (8, 32, 60, 1024) x 256 rois within
     1e-5 * max|dF| (float32) and 1e-2 * max|dF| (bfloat16) of the twin's
     autograd gradient (float32 atomics add in a different order on every
     run); the BEV voxelizer at (8, 32768) points -> 400 x 350 x 15 and
     (8, 180000) -> 800 x 700 x 15, with points on cell and slice
     boundaries, invalid lanes, points out of range, over-full voxels and an
     all-invalid frame: height and density channels equal, the meta
     channels within 1e-5 (float sums in atomic order).  Forward results are
     compared with the twins on CPU copies, the backward with the twin on
     the card; times (CUDA events) with the twins on the card, beside the
     least time the card could take (the larger of bytes over 3.35 TB/s and
     float32 operations over 67 TFLOP/s).
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
Each path (5, 7, 9) runs with the launch counts set to 0 just before it and
read just after.  Then one JSON line describing the kernels (each kernel's
`launches` is the count on the newest path that runs it: BEV serving, or
training for the RoI-align backward; `launches_by_path` has all three), the
nvidia-smi name/power line, and the result line {"ok": true, "device": ...}.

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
# the raster grid follows TRAIN.SCALES[0] in the loader; serving sets both
BEV_SERVING_OVERRIDES = SERVING_OVERRIDES + ("TEST.SCALES", "(0.5,)", "COMPUTE_DTYPE", "bfloat16")


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


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


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
    ms = cuda_ms(lambda: nms(db, ds, thr, max_out, dv), 50)
    plain_ms = cuda_ms(lambda: nms_plain(db, ds, thr, max_out, dv), 2)
    m = idx.shape[-1]
    pairs = nms_pairs(scores, valid, want_idx.numpy(), want_ok.numpy())
    bound, by = bound_ms(g * n * (16 + 4 + 1) + g * m * (4 + 1), pairs * IOU_FLOPS)
    print(f"nms {name} ({g}, {n}) -> {max_out} @ {thr}: identical keeps "
          f"({int(ok.sum())} kept); kernel {ms} ms, plain twin on the card {plain_ms} ms, "
          f"bound {bound} ms ({by}; {pairs} IoU pairs)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


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


def check_roi_align(rng, feat_hw):
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        roi_align_batched,
        roi_align_batched_plain,
    )

    h, w = feat_hw
    feats = rng.normal(size=(B, h, w, C_FEAT)).astype(np.float32)
    rois = torch.from_numpy(serving_rois(rng, B, R, (h * 16, w * 16)))
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
        ms = cuda_ms(lambda: roi_align_batched(df, dr, 1.0 / 16), 20)
        plain_ms = cuda_ms(lambda: roi_align_batched_plain(df, dr, 1.0 / 16), 3)
        bound, by = bound_ms(df.numel() * df.element_size() + dr.numel() * 4
                             + got.numel() * got.element_size(), roi_align_flops(got.numel()))
        print(f"roi_align {str(dtype).split('.')[-1]} features {tuple(df.shape)} rois "
              f"{tuple(dr.shape)}: max abs err {err} (bound {tol} * max|F| = {tol * fmax}); "
              f"kernel {ms} ms, plain twin on the card {plain_ms} ms, bound {bound} ms ({by})")
        results[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by}
    return results


def check_roi_align_backward(rng):
    """The backward kernel against the twin's autograd gradient, both on the
    card, at the training shapes; times of the backward alone."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        _roi_align_bwd_cuda,
        roi_align_batched,
        roi_align_batched_plain,
    )

    feats = rng.normal(size=(B, H_FEAT, W_FEAT, C_FEAT)).astype(np.float32)
    rois = torch.from_numpy(serving_rois(rng, B, R_TRAIN)).cuda()
    grad_out = rng.normal(size=(B, R_TRAIN, 7, 7, C_FEAT)).astype(np.float32)
    results = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        f = torch.from_numpy(feats).to(dtype).cuda().requires_grad_(True)
        g = torch.from_numpy(grad_out).to(dtype).cuda()
        (got,) = torch.autograd.grad(roi_align_batched(f, rois, 1.0 / 16), f, g)
        plain_out = roi_align_batched_plain(f, rois, 1.0 / 16)
        (want,) = torch.autograd.grad(plain_out, f, g, retain_graph=True)
        torch.cuda.synchronize()
        want = want.float()
        gmax = float(want.abs().max())
        err = float((got.float() - want).abs().max())
        if got.dtype != dtype or not err <= tol * gmax:
            raise AssertionError(f"roi_align backward {dtype}: max err {err} > {tol} * {gmax}")
        shape, fd = tuple(f.shape), f.dtype
        ms = cuda_ms(lambda: _roi_align_bwd_cuda(g, rois, shape, fd, 1.0 / 16, 7, 2, False), 10)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, f, g, retain_graph=True), 3)
        bound, by = bound_ms(g.numel() * g.element_size() + rois.numel() * 4
                             + f.numel() * f.element_size(), roi_align_flops(g.numel()))
        print(f"roi_align backward {str(dtype).split('.')[-1]} dOut {tuple(g.shape)} -> dF "
              f"{shape}: max abs err {err} (bound {tol} * max|dF| = {tol * gmax}); kernel "
              f"{ms} ms, plain twin's autograd backward on the card {plain_ms} ms, "
              f"bound {bound} ms ({by})")
        results[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": by}
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


def check_voxelize(rng, cfg, frame_scale, p):
    """The voxelizer kernel against its twin (CPU copy) and its time."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import (
        raster_kwargs,
        voxelize_bev,
        voxelize_bev_plain,
    )

    grid = raster_kwargs(cfg, frame_scale)
    pts, valid = bev_points(rng, B, p, grid)
    tp, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    dp, dv = tp.cuda(), tv.cuda()
    got = voxelize_bev(dp, dv, **grid)
    torch.cuda.synchronize()
    got = got.cpu()
    want = voxelize_bev_plain(tp, tv, **grid)
    s = grid["num_slices"]
    exact = torch.equal(got[..., :s + 1], want[..., :s + 1])
    err = float((got - want).abs().max())
    meta_err = float((got[..., s + 1:] - want[..., s + 1:]).abs().max())
    if not exact or not meta_err <= 1e-5 or bool(got[1].any()):
        raise AssertionError(f"voxelize_bev {tuple(got.shape)}: height/density equal {exact}, "
                             f"meta err {meta_err}, all-invalid frame zero {not bool(got[1].any())}")
    ms = cuda_ms(lambda: voxelize_bev(dp, dv, **grid), 20)
    plain_ms = cuda_ms(lambda: voxelize_bev_plain(dp, dv, **grid), 3)
    # float32 operations: ~11 a point (subtract, scale, floor per axis; the
    # height), ~2 per slice and ~50 for the two divisions and tanhs a column
    n_cols = got.numel() // got.shape[-1]
    flops = dv.numel() * 11 + n_cols * (2 * s + 50)
    bound, by = bound_ms(dp.numel() * 4 + dv.numel() + got.numel() * 4, flops)
    print(f"voxelize_bev points {tuple(dp.shape)} -> {tuple(got.shape)}: height and density "
          f"channels equal, meta channels max err {meta_err} (limit 1e-5), filled cells "
          f"{int((want[..., s] > 0).sum())}; kernel {ms} ms, plain twin on the card {plain_ms} ms, "
          f"bound {bound} ms ({by})")
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


def split_thresh(scores) -> float:
    """A threshold in the widest gap among the middle third of the scores,
    so about half pass and none sits within backend noise of it."""
    s = np.sort(scores.numpy().ravel())
    lo, hi = s.size // 3, max(s.size // 3 + 1, 2 * s.size // 3)
    i = lo + int(np.argmax(np.diff(s[lo:hi + 1])))
    return float((s[i] + s[i + 1]) / 2)


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
    feat_err = float((g_feat.cpu() - c_feat).abs().max())
    feat_max = float(c_feat.abs().max())
    fg_err = float((g_rpn["fg_prob"].cpu() - c_rpn["fg_prob"]).abs().max())
    delta_err = float((g_rpn["deltas"].cpu() - c_rpn["deltas"]).abs().max())
    cls_err = float((g_cls.cpu() - c_out["cls_prob"]).abs().max())
    box_err = float((g_boxes.cpu() - c_out["bbox_pred"]).abs().max())
    cr = c_out["rois"][0][c_out["roi_valid"][0]]
    gr = g_out["rois"][0][g_out["roi_valid"][0]]
    matched = int((iou_plus1(cr, gr).max(dim=1).values >= 0.99).sum())
    print(f"slice res101 fp32 {h}x{w}: C4 max err {feat_err} (max|C4| {feat_max}); "
          f"fg_prob {fg_err}; deltas {delta_err}; proposals matched {matched}/{len(cr)} "
          f"at IoU >= 0.99; pinned cls_prob {cls_err}; pinned boxes {box_err} px")
    checks = {
        "C4 features": feat_err <= 1e-4 * feat_max,
        "fg_prob": fg_err <= 2e-3,
        "deltas": delta_err <= 2e-3,
        "proposals": len(cr) > 0 and matched >= 0.95 * len(cr),
        "cls_prob": cls_err <= 3e-3 * float(c_out["cls_prob"].abs().max()),
        "boxes": box_err <= 0.15,
    }
    kw = dict(num_classes=2, bbox_elem=4, max_dets=100,
              thresh=split_thresh(c_out["cls_prob"][..., 1]), nms_thresh=0.6)
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


def run_serving(cfg, smi):
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
    print(f"serving res101 bf16 {FRAME_HW[0]}x{FRAME_HW[1]} batch {B} ({smi}): "
          f"detect ms/batch {res['detect_ms']}, filter ms/batch {res['filter_ms']}, "
          f"mean {float(ms.mean())} ms/batch, {B * len(ms) / (float(ms.sum()) / 1e3)} frames/s, "
          f"peak memory {peak / 2**30} GiB, random-weight mAP {res['mAP']}")
    print(f"serving: outputs finite {res['finite']}, fewest proposals in a frame "
          f"{res['min_proposals']}, kernel launches {launches}")
    if not res["finite"]:
        raise AssertionError("serving: non-finite outputs")
    if not res["min_proposals"] or res["min_proposals"] <= 0:
        raise AssertionError("serving: a frame has no valid proposal")
    if not all(launches[k] > 0 for k in ("nms", "roi_align")):
        raise AssertionError(f"serving: a kernel never launched: {launches}")
    return launches


TRAIN_LEAVES = (
    "rpn.rpn_cls_score_net.weight", "rpn.rpn_bbox_pred_net.weight",
    "predictors.cls_score_net.weight", "predictors.bbox_pred_net.weight",
    "tail.layer4.0.conv1.weight",
)
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box")


def check_train_slice(cfg_base):
    """res101 float32 training forward and backward on one 256x320 frame:
    card against CPU, on the same draws; the card's second stage pinned to
    the CPU's proposal lanes (its boxes still come from the card's deltas)."""
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
    h, w = SLICE_HW
    x = torch.from_numpy(rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8))
    win = torch.tensor([[0.0, float(w), 0.0, float(h)]])
    # GT: jittered copies of some CPU proposals, so proposals are sampled as fg
    with torch.no_grad():
        feat = cpu.features(x)
        anchors = cpu.anchors(feat.shape[1], feat.shape[2], "cpu", "train")
        rois, _scores, valid, _src = cpu._propose_batch(cpu.rpn_scores(feat), anchors, win, "train")
    props = rois[0][valid[0]][::9][:6]
    n = len(props)
    gt = torch.zeros((1, cfg.static.max_gt, 5))
    gt[0, :n, :4] = props + torch.from_numpy(rng.uniform(-2, 2, (n, 4)).astype(np.float32))
    gt[0, :n, 4] = 1
    mask = torch.zeros((1, cfg.static.max_gt), dtype=torch.bool)
    mask[0, :n] = True
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
    for name in TRAIN_LEAVES + (last_layer3,):
        cg, gg = c_params[name].grad, g_params[name].grad
        scale = float(cg.abs().max())
        grad_err[name] = float((gg.cpu() - cg).abs().max()) / scale
        checks[f"grad {name}"] = scale > 0 and grad_err[name] <= 1e-3
    labels = c_aux.proposal_targets.labels
    print(f"train slice {cfg.net_variant} fp32 {h}x{w}: losses cpu "
          f"{ {k: float(c_losses[k].detach()) for k in LOSSES} }, relative errors {loss_err} "
          f"(rpn losses unpinned, second stage pinned); sampled RoIs fg {int((labels > 0).sum())} "
          f"bg {int((labels == 0).sum())}; gradient error / max|g| per leaf {grad_err}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train slice card vs CPU out of tolerance: {failed}")


def run_training(cfg, smi):
    """The training path: warm-up step, then TRAIN_STEPS steps, counted."""
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
    print(f"training {cfg.net_variant} {cfg.compute_dtype} {FRAME_HW[0]}x{FRAME_HW[1]} batch {B} ({smi}): "
          f"warm-up step {warm['ms'][0]} ms; ms/step {res['ms']}; mean {float(ms.mean())} ms, "
          f"median {float(np.median(ms))} ms, {B / (float(ms.mean()) / 1e3)} frames/s, "
          f"peak memory {peak / 2**30} GiB")
    for i, losses in enumerate(res["losses"]):
        print(f"  step {i + 1}: " + ", ".join(f"{k} {v}" for k, v in losses.items()))
    print(f"training: losses finite {finite}, kernel launches {launches}")
    if not finite:
        raise AssertionError("training: a non-finite loss")
    if not all(launches[k] > 0 for k in ("nms", "roi_align", "roi_align_bwd")):
        raise AssertionError(f"training: a kernel never launched: {launches}")
    return launches


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
              thresh=split_thresh(c_out["cls_prob"][..., 1]), nms_thresh=0.6)
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


def run_bev_serving(cfg, smi):
    """The BEV serving path: warm-up batch, then 3 batches, counted."""
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
    print(f"BEV serving {cfg.net_variant} {cfg.compute_dtype} raster {shape} batch {B} "
          f"({smi}): voxelize ms/batch {res['raster_ms']}, detect ms/batch {res['detect_ms']}, "
          f"filter ms/batch {res['filter_ms']}; batches 2-3 mean {float(ms.mean())} ms/batch, "
          f"{B * len(ms) / (float(ms.sum()) / 1e3)} frames/s; peak memory {peak / 2**30} GiB; "
          f"random-weight mAP ({res['eval_type']} @ {res['iou_thresh']}) {res['mAP']}")
    print(f"BEV serving: outputs finite {res['finite']}, fewest proposals in a frame "
          f"{res['min_proposals']}, kernel launches {launches}")
    if not res["finite"]:
        raise AssertionError("BEV serving: non-finite outputs")
    if not res["min_proposals"] or res["min_proposals"] <= 0:
        raise AssertionError("BEV serving: a frame has no valid proposal")
    if not all(launches[k] > 0 for k in ("voxelize_bev", "nms", "roi_align")):
        raise AssertionError(f"BEV serving: a kernel never launched: {launches}")
    return launches


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

    phase("kernels vs plain twins")
    rng = np.random.RandomState(0)
    nms_prop = check_nms("proposals", B, 2048, 0.7, 300, rng)
    nms_filter = check_nms("final filter", 2 * B, 300, 0.6, 100, rng)
    nms_train = check_nms("train proposals", B, 4096, 0.7, 2000, rng)
    nms_bev = check_nms("BEV proposals", B, BEV_ANCHORS, 0.7, 300, rng)
    nms_bev_filter = check_nms("BEV final filter", 2 * B, 300, 0.6, 100, rng)
    roi = check_roi_align(rng, (H_FEAT, W_FEAT))
    roi_bev = check_roi_align(rng, BEV_FEAT_HW)
    roi_bwd = check_roi_align_backward(rng)
    vox_waymo = check_voxelize(rng, bev_cfg, 1.0, 180000)
    vox = check_voxelize(rng, bev_cfg, 0.5, bev_cfg.static.max_points)

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
    bev_serving = run_bev_serving(bev_cfg, smi)

    paths = {"serving": serving, "training": training, "bev_serving": bev_serving}

    def entry(name, source, replaces, path, measured):
        return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{source}",
                "replaces": f"faster_rcnn_pytorch_multimodal_tpu/{replaces}",
                "launches": paths[path][name],
                "launches_by_path": {k: v[name] for k, v in paths.items()},
                **measured, "library_ms": None}

    nms_err = max(r["max_abs_err"] for r in (nms_prop, nms_filter, nms_train, nms_bev, nms_bev_filter))
    kernels = {"kernels": [
        entry("voxelize_bev", "voxelize.cu", "ops/voxelize.py:39", "bev_serving", vox),
        entry("nms", "nms.cu", "ops/nms.py:53", "bev_serving", {**nms_bev, "max_abs_err": nms_err}),
        entry("roi_align", "roi_align.cu", "ops/roi_align.py:122", "bev_serving",
              roi_bev[torch.bfloat16]),
        entry("roi_align_bwd", "roi_align.cu", "ops/roi_align.py:122 (VJP)", "training",
              roi_bwd[torch.bfloat16]),
    ]}
    print("timed at: voxelize_bev (8, 32768) -> (8, 400, 350, 15); nms (8, 1100) -> 300; "
          "roi_align bf16 (8, 25, 22, 1024) x 300; roi_align_bwd bf16 dOut (8, 256, 7, 7, 1024); "
          "library_ms null: no single PyTorch call computes these functions "
          "(torchvision's nms and roi_align are not installed)")
    print(f"also: voxelize_bev (8, 180000) -> 800 x 700: {vox_waymo}; nms (8, 2048) -> 300: "
          f"{nms_prop}; (16, 300) -> 100: {nms_filter}; (8, 4096) -> 2000: {nms_train}; "
          f"BEV (16, 300) -> 100: {nms_bev_filter}; roi_align (8, 32, 60, 1024): "
          f"fp32 {roi[torch.float32]}, bf16 {roi[torch.bfloat16]}; (8, 25, 22, 1024) fp32 "
          f"{roi_bev[torch.float32]}; roi_align backward fp32 {roi_bwd[torch.float32]}")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
