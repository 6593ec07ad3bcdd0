#!/usr/bin/env python3
"""Drive the PyTorch port of the detector on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints what it found; any failure raises, so the script exits
non-zero and never prints its last line):
  1. device: torch/CUDA versions, the card's name and power limit; TF32 off
     for the parity phases.
  2. build: compile csrc/*.cu with nvcc (seconds and ptxas resource lines).
  3. kernels vs their plain PyTorch twins at the shapes of both paths: NMS
     at (8, 2048) -> 300 @ 0.7, (16, 300) -> 100 @ 0.6 (serving) and
     (8, 4096) -> 2000 @ 0.7 (training) must keep identical lanes; RoI
     align at features (8, 32, 60, 1024) x 300 rois within 1e-5 * max|F|
     (float32) and 1e-2 * max|F| (bfloat16, rounded output); the RoI-align
     backward at the same features x 256 rois within 1e-5 * max|dF| (float32)
     and 1e-2 * max|dF| (bfloat16) of the twin's autograd gradient (float32
     atomics add in a different order on every run).  Forward results are
     compared with the twins on CPU copies, the backward with the twin on
     the card; times (CUDA events) with the twins on the card.
  4. the serving slice at res101, float32, one 256x320 frame: card (kernels)
     against CPU (twins).
  5. the serving path: bench.image_config's res101 at test settings,
     compute dtype bfloat16, SyntheticDataset 512x960, batch 8, one warm-up
     batch then 3 batches through inference.evaluate.  Outputs must be
     finite, every frame must have proposals, and NMS and RoI align must
     have launched.
  6. the training slice at res101, float32, one 256x320 frame, ROI_BATCH_SIZE
     64, NMS_PRE_TRAIN 1024 -> 256: card against CPU on the same random
     draws, the card's second stage pinned to the CPU's proposal lanes.
     Equal anchor and RoI samples, the four losses within rtol 1e-3, the
     gradients of six trainable leaves within 1e-3 * max|g| of each leaf.
  7. the training path: bench.image_config (res101, bf16), SyntheticDataset
     512x960 through the BatchLoader, batch 8, one warm-up step then 10
     steps of training.solver.train.  Every loss finite at every step; NMS,
     RoI align and its backward must have launched.
Then one JSON line describing the kernels, the nvidia-smi name/power line,
and the result line {"ok": true, "device": {...}}.

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
SLICE_HW = (256, 320)
TRAIN_STEPS = 10


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
    print(f"nms {name} ({g}, {n}) -> {max_out} @ {thr}: identical keeps "
          f"({int(ok.sum())} kept); kernel {ms} ms, plain twin on the card {plain_ms} ms")
    return err, ms, plain_ms


def serving_rois(rng, b, r):
    """Proposal-like rois on a 512x960 frame, with some straddling the edge,
    some outside it and some smaller than one feature cell."""
    rois = np.stack([random_boxes(rng, r) for _ in range(b)])
    rois[:, :20, :2] -= 100.0
    rois[:, 20:30] += 2000.0
    rois[:, 30:40, 2:] = rois[:, 30:40, :2] + rng.uniform(1, 12, (b, 10, 2))
    return rois.astype(np.float32)


def check_roi_align(rng):
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
        roi_align_batched,
        roi_align_batched_plain,
    )

    feats = rng.normal(size=(B, H_FEAT, W_FEAT, C_FEAT)).astype(np.float32)
    rois = torch.from_numpy(serving_rois(rng, B, R))
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
        print(f"roi_align {str(dtype).split('.')[-1]} features {tuple(df.shape)} rois "
              f"{tuple(dr.shape)}: max abs err {err} (bound {tol} * max|F| = {tol * fmax}); "
              f"kernel {ms} ms, plain twin on the card {plain_ms} ms")
        results[dtype] = (err, ms, plain_ms)
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
        print(f"roi_align backward {str(dtype).split('.')[-1]} dOut {tuple(g.shape)} -> dF "
              f"{shape}: max abs err {err} (bound {tol} * max|dF| = {tol * gmax}); kernel "
              f"{ms} ms, plain twin's autograd backward on the card {plain_ms} ms")
        results[dtype] = (err, ms, plain_ms)
        del plain_out
    return results


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

    from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list
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

    from faster_rcnn_pytorch_multimodal_tpu.data import BatchLoader, SyntheticDataset
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
    loader = BatchLoader(db, cfg, batch_size=B, augment=False, shuffle=False, seed=0)
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

    from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list
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

    from faster_rcnn_pytorch_multimodal_tpu.data import BatchLoader, SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import create_train_state, train

    db = SyntheticDataset(cfg, num_frames=4 * B, num_classes=2, image_hw=FRAME_HW, seed=0)
    loader = BatchLoader(db, cfg, batch_size=B, seed=0)
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

    phase("kernels vs plain twins")
    rng = np.random.RandomState(0)
    nms_prop = check_nms("proposals", B, 2048, 0.7, 300, rng)
    nms_filter = check_nms("final filter", 2 * B, 300, 0.6, 100, rng)
    nms_train = check_nms("train proposals", B, 4096, 0.7, 2000, rng)
    roi = check_roi_align(rng)
    roi_bwd = check_roi_align_backward(rng)

    from bench import image_config  # jax-free: imports only the config module
    from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list

    cfg = cfg_from_list(
        image_config(),
        ("STATIC.NMS_PRE_TEST", "2048", "TEST.RPN_POST_NMS_TOP_N", "300"),
    )

    phase("slice: card vs CPU")
    check_slice(cfg)

    phase("serving path")
    serving = run_serving(cfg, smi)

    phase("training slice: card vs CPU")
    check_train_slice(image_config())

    phase("training path")
    training = run_training(image_config(), smi)

    def by_path(name):
        return {"serving": serving[name], "training": training[name]}

    err_bf16, ms_bf16, plain_bf16 = roi[torch.bfloat16]
    berr_bf16, bms_bf16, bplain_bf16 = roi_bwd[torch.bfloat16]
    kernels = {"kernels": [
        {"name": "nms", "route": "cuda", "source": f"{PKG}/csrc/nms.cu",
         "replaces": "faster_rcnn_pytorch_multimodal_tpu/ops/nms.py:53",
         "launches": training["nms"], "launches_by_path": by_path("nms"),
         "max_abs_err": max(nms_prop[0], nms_filter[0], nms_train[0]),
         "ms": nms_train[1], "plain_ms": nms_train[2]},
        {"name": "roi_align", "route": "cuda", "source": f"{PKG}/csrc/roi_align.cu",
         "replaces": "faster_rcnn_pytorch_multimodal_tpu/ops/roi_align.py:122",
         "launches": training["roi_align"], "launches_by_path": by_path("roi_align"),
         "max_abs_err": err_bf16, "ms": ms_bf16, "plain_ms": plain_bf16},
        {"name": "roi_align_bwd", "route": "cuda", "source": f"{PKG}/csrc/roi_align.cu",
         "replaces": "faster_rcnn_pytorch_multimodal_tpu/ops/roi_align.py:122 (VJP)",
         "launches": training["roi_align_bwd"], "launches_by_path": by_path("roi_align_bwd"),
         "max_abs_err": berr_bf16, "ms": bms_bf16, "plain_ms": bplain_bf16},
    ]}
    print(f"nms serving shapes: (8, 2048) kernel {nms_prop[1]} ms, plain {nms_prop[2]} ms; "
          f"(16, 300) kernel {nms_filter[1]} ms, plain {nms_filter[2]} ms; "
          f"roi_align fp32: err {roi[torch.float32][0]}, kernel {roi[torch.float32][1]} ms, "
          f"plain {roi[torch.float32][2]} ms; roi_align backward fp32: err "
          f"{roi_bwd[torch.float32][0]}, kernel {roi_bwd[torch.float32][1]} ms, "
          f"plain {roi_bwd[torch.float32][2]} ms")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
