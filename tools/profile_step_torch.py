#!/usr/bin/env python
"""Section profile of the port's train step (the port of tools/profile_step.py).

Times nested prefixes of the training forward plus backward on one batch,
each after warm-up between CUDA events (the host clock on the CPU; the
median of 3 windows of 3 calls), so each section's cost falls out by
difference:

  backbone                     features() forward + backward (BEV: the K3
                               raster of the batch's points first)
  + rpn head and its losses    ... + rpn_scores, anchor_target, the RPN losses
  + proposals (K1)             ... + the train-phase proposal layer (NMS)
  + targets                    ... + the RoIs rebuilt, proposal_target
  full train step              make_train_step: the RoI head (K2, K2-bwd; on
                               FPN K2-FPN and its backward), its losses and
                               the optimizer's update

At full width: res101 bf16, batch 8, the JAX bench's configs (image 512x960,
bev 400 x 350 x 15, fpn: the image config with the FPN backbone), the
residual terminators at 0.25 (chip_smoke.scale_terminators, as bench.py
does for random weights).  Prints each section's ms a step and frames/s
with the card's name and power limit, and beside them, from torch.profiler
over one more call, the device's busy ms and the kernels a step: the
CUDA-event ms of a host-bound section is the host's pace, its busy ms the
device's work.

Usage: python tools/profile_step_torch.py [image|bev|fpn] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Dict

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

WARMUP = 3
REPS = 3  # calls a timed window
WINDOWS = 3
PROFILED = 1  # calls under torch.profiler, a section
CONFIGS = {
    "image": (chip_smoke.IMAGE_OVERRIDES,),
    "bev": (chip_smoke.BEV_OVERRIDES,),
    "fpn": (chip_smoke.IMAGE_OVERRIDES, chip_smoke.FPN_OVERRIDES),
}
SECTIONS = ("backbone", "+ rpn head and its losses", "+ proposals (K1)", "+ targets",
            "full train step")


def _maps(feat):
    return feat if isinstance(feat, tuple) else (feat,)


def _images(model, batch):
    """The batch's images, or for a BEV batch its raster, made here from
    the points by voxelize_bev (K3)."""
    if "points" not in batch:
        return batch["data"]
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs, voxelize_bev

    cfg = model.cfg
    return voxelize_bev(batch["points"], batch["point_valid"],
                        **raster_kwargs(cfg, float(cfg.train.scales[0])))


def _rpn(model, batch, draws):
    feat = model.features(_images(model, batch))
    rpn_out, grids, _at, losses = model.rpn_train(
        feat, batch["gt_boxes"], batch["gt_mask"], batch["window"], draws)
    return feat, rpn_out, grids, losses["rpn_cross_entropy"] + losses["rpn_loss_box"]


def backbone(model, batch, draws):
    return sum((m.float() ** 2).sum() for m in _maps(model.features(_images(model, batch)))) * 1e-6


def rpn_head(model, batch, draws):
    return _rpn(model, batch, draws)[3]


def proposals(model, batch, draws):
    _feat, rpn_out, grids, loss = _rpn(model, batch, draws)
    model.select_proposals(rpn_out, grids[0], batch["window"])  # eager: it runs
    return loss


def targets(model, batch, draws):
    _feat, rpn_out, grids, loss = _rpn(model, batch, draws)
    src, valid = model.select_proposals(rpn_out, grids[0], batch["window"])
    b = batch["gt_boxes"].shape[0]
    dc = batch.get("gt_boxes_dc")
    if dc is None:
        dc = batch["gt_boxes"].new_zeros((b, 1, 4))
        dc_mask = batch["gt_mask"].new_zeros((b, 1))
    else:
        dc_mask = batch["dc_mask"]
    pt = model.sample_rois(rpn_out, grids, batch["window"], src, valid, batch["gt_boxes"],
                           batch["gt_mask"], dc, dc_mask, draws)
    return loss + 1e-6 * (pt.bbox_targets.float().sum() + pt.rois.float().sum())


PREFIXES = (backbone, rpn_head, proposals, targets)


def _timed(fn: Callable[[], object], device, reps: int, windows: int) -> float:
    """Median over `windows` of the mean ms of fn() over `reps` calls in a
    row, between CUDA events on a card (the host clock on the CPU)."""
    import torch

    means = []
    for _ in range(windows):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            stop.synchronize()
            means.append(start.elapsed_time(stop) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            means.append((time.perf_counter() - t0) * 1e3 / reps)
    return float(np.median(means))


def _device_work(fn: Callable[[], object], reps: int) -> Dict[str, float]:
    """torch.profiler over `reps` calls of fn() on a card: the kernels a
    call, their summed device ms a call (the device's busy time) and the
    span of the first kernel's start to the last one's end a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not events:
        return {"kernels": float("nan"), "kernel_ms": float("nan"), "span_ms": float("nan")}
    busy = sum(e.time_range.end - e.time_range.start for e in events)
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    return {"kernels": len(events) / reps, "kernel_ms": busy / 1e3 / reps,
            "span_ms": span / 1e3 / reps}


def setup(cfg, device, image_hw=chip_smoke.FRAME_HW, batch_size=chip_smoke.B, seed=0,
          scale=True):
    """The model (chip_smoke.scale_terminators with `scale`), its optimizer,
    one device batch (a BEV batch keeps its raw points: the sections make
    the raster) and the step's draws, from `seed`."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as S

    db = SyntheticDataset(cfg, num_frames=2 * batch_size, num_classes=2, image_hw=image_hw,
                          seed=seed)
    host = BatchLoader(db, cfg, batch_size, device=device, seed=seed, rasterize=False).next()
    batch = S.batch_to_device(host, device)
    model, optimizer = S.create_train_state(cfg, 2, device, seed=seed)
    if scale:
        chip_smoke.scale_terminators(model)
    g = torch.Generator(device=device).manual_seed(seed)
    draws = S.draw_train_keys(model, dict(batch, data=_images(model, batch)), g)
    return model, optimizer, batch, draws


def profile(cfg, device, image_hw=chip_smoke.FRAME_HW, batch_size=chip_smoke.B, seed=0,
            warmup=WARMUP, reps=REPS, windows=WINDOWS, scale=True) -> Dict[str, dict]:
    """Each section's ms a step (the median of `windows` means over `reps`
    calls, after `warmup`), its kernel launches over the timed calls, on a
    card its device work (_device_work over PROFILED more calls: kernels a
    step, their busy ms, their span) and its losses (the first call's: the prefixes' scalar; the full
    step's loss dict, on the initial weights).  The prefixes update
    nothing; the full section runs make_train_step last."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as S

    device = torch.device(device)
    model, optimizer, batch, draws = setup(cfg, device, image_hw, batch_size, seed, scale)
    model.train()
    out: Dict[str, dict] = {}

    def run(name, call):
        first = call()
        for _ in range(warmup - 1):
            call()
        _build.reset_launch_counts()
        ms = _timed(call, device, reps, windows)
        out[name] = {"ms": ms, "reps": reps * windows, "launches": dict(_build.LAUNCH_COUNTS),
                     "losses": first}
        if device.type == "cuda":
            out[name].update(_device_work(call, PROFILED))

    for name, fn in zip(SECTIONS, PREFIXES):
        def call(fn=fn):
            optimizer.zero_grad()
            loss = S.compute_call(model, fn, batch, draws)
            loss.backward()
            return float(loss.detach())

        with S.frozen_running_stats(model):
            run(name, call)

    step = S.make_train_step(model, optimizer)
    full = dict(batch)
    if "points" in full:
        def full_call():
            b = dict(full, data=_images(model, full))
            return {k: float(v) for k, v in step(b, draws)[0].items()}
    else:
        def full_call():
            return {k: float(v) for k, v in step(full, draws)[0].items()}
    run(SECTIONS[-1], full_call)
    return out


def report(which: str, cfg, res: Dict[str, dict], smi: str, batch_size: int) -> str:
    lines = [f"section profile ({which}, {cfg.net_variant} {cfg.compute_dtype}, b{batch_size}; "
             f"{smi}):"]
    prev = {"ms": 0.0, "kernel_ms": 0.0, "kernels": 0.0}
    for name in SECTIONS:
        r = res[name]
        per_step = {k: v / r["reps"] for k, v in r["launches"].items() if v}
        line = (f"  {name:28s} {batch_size * 1e3 / r['ms']:8.1f} f/s {r['ms']:9.3f} ms/step "
                f"(section {r['ms'] - prev['ms']:+9.3f} ms)")
        if "kernel_ms" in r:
            line += (f"; device busy {r['kernel_ms']:.3f} ms (section "
                     f"{r['kernel_ms'] - prev['kernel_ms']:+.3f}) in a {r['span_ms']:.3f} ms span, "
                     f"{r['kernels']:.0f} kernels (section {r['kernels'] - prev['kernels']:+.0f})")
        lines.append(line + f"; hand-written kernels a step {per_step}")
        prev = {k: r.get(k, 0.0) for k in prev}
    return "\n".join(lines)


def main(argv=None) -> Dict[str, dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("which", nargs="?", default="image", choices=tuple(CONFIGS))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to run (the card unless the CPU is asked for)")
    args = p.parse_args(argv)
    cfg = chip_smoke.make_config(*CONFIGS[args.which])
    smi = chip_smoke.smi_name_power() if args.device == "cuda" else "CPU"
    res = profile(cfg, args.device)
    print(report(args.which, cfg, res, smi, chip_smoke.B))
    if not all(np.isfinite(v) for r in res.values()
               for v in (r["losses"].values() if isinstance(r["losses"], dict)
                         else [r["losses"]])):
        raise SystemExit(f"profile {args.which}: a non-finite loss")
    return res


if __name__ == "__main__":
    main()
