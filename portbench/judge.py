"""What decides `correct`: the program's outputs of the timed path against
the plain reference's, number by number, each beside its limit.

A record is what the timed path produced, gathered by the harness (or, for
the control, by the reference computed in a lower precision in the
program's place):

  training  "losses" [{loss: float}] of the first steps, "grad_norms"
            {leaf: |g|} of the first step's gradient as the optimizer got it
            (its momentum buffer less the decay), "change1_norms" {leaf: |dp|}
            after the first step and "change_norms" after the first steps,
            "proposals" [dict] of each step: what the
            proposal layer saw (fg, deltas, window) and chose (rois, scores,
            valid, src), "rasters" [raster] (LiDAR) of those steps
  serving   "batches" [(pool index, forward outputs, filtered detections,
            proposals)] of a sample of the window's batches drawn from the
            seed, the proposals being what the proposal layer saw and chose
            for that batch; (LiDAR) "raster" of the first warm-up batch (pool
            batch 0)

The reference follows the program's choices where a choice among
near-equal numbers decides: which proposals the NMS keeps out of scores
that random weights leave nearly tied, and which RoIs the targets sample
(by the IoUs of the program's proposal boxes).  Those stages are checked by
themselves: `rpn_gap` holds the scores the proposal layer saw to the
reference's, `nms_miss` its choice to the reference's choice on the same
scores and deltas (exact), and in serving `roi_gap` its boxes to the
reference's decode of the same lanes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import ops
from portbench.reference.model import SGD, Detector, make_weights

SETUP_STEPS = 3
FROZEN_SHARE = 1e-3  # leaves whose reference gradient is below this share of the median's


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of training step `step`'s draws, for the program and the reference."""
    return torch.Generator(device=device).manual_seed(ops.seed_of(seed, 0xD7A3, step))


def sample_ordinals(seed: int, low: int, count: int) -> List[int]:
    """The window's batches whose outputs serving is judged on, drawn from the seed."""
    rng = np.random.RandomState(ops.seed_of(seed, 0x5A3B1E) % 2 ** 32)
    return sorted(rng.choice(low, size=count, replace=False).tolist())


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    s = top / x.detach().abs().amax().clamp(min=1e-12)
    return (x.detach() * s).to(dtype).float() / s


class _GradFp8(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to float8 e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Fp8:
    """The control's arithmetic: every convolution's and dense layer's
    operands rounded to float8 e4m3 and, in the backward, its output's
    gradient to e5m2, each with a per-tensor scale (its largest magnitude
    to the format's largest); accumulation in float32.  The LiDAR raster,
    float32 in the configuration, from points rounded to bfloat16."""

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x + (_round(x, torch.float8_e4m3fn, 448.0) - x.detach())

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return _GradFp8.apply(y)

    def points(self, p: torch.Tensor) -> torch.Tensor:
        return p.to(torch.bfloat16).float()


fp8 = Fp8()


def weights(det: Detector, seed: int, device, served_dtype=None) -> Dict[str, torch.Tensor]:
    """The seed's float32 weights; for serving rounded to the served dtype."""
    w = make_weights(det.arch, seed, device)
    if served_dtype is not None:
        w = {k: v.to(served_dtype).float() for k, v in w.items()}
    return w


def _frames(det: Detector, batch: dict, device, q=None):
    """A pool batch on the device: (data, gt, gt_mask, window); data is the
    reference's own raster for LiDAR."""
    gt, mask = batch["gt_boxes"].to(device), batch["gt_mask"].to(device)
    window = batch["window"].to(device)
    if det.lidar:
        points = batch["points"].to(device)
        data = ops.voxelize(points if q is None else q.points(points),
                            batch["point_valid"].to(device), **det.raster_grid())
    else:
        data = batch["data"].to(device)
    return data, gt, mask, window


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    """The worst leaf's | |prog| - |ref| | over the larger of |ref| and the
    median leaf's |ref|."""
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def _cuts(b: int, chunk: int, used_b: int) -> List[int]:
    return sorted(set(range(0, b, chunk)) | {used_b, b})


def reference_train(det: Detector, pool: List[dict], seed: int, device, pinned=None, q=None,
                    chunk: int = 4, half: bool = False) -> dict:
    """The reference's first SETUP_STEPS steps on the pool's first batches: a
    record (see the module docstring).  `pinned` (a record's "proposals")
    makes it follow those proposals; `half` plants a fault: the losses and
    their means over the first half of each batch only."""
    P = weights(det, seed, device)
    start = {k: v.detach().clone() for k, v in P.items()}
    opt = SGD(det.cfg, det.arch, P)
    rec = {"losses": [], "proposals": [], "rasters": []}
    for step in range(SETUP_STEPS):
        data, gt, mask, window = _frames(det, pool[step % len(pool)], device, q)
        if det.lidar:
            rec["rasters"].append(data)
        b, hw = gt.shape[0], tuple(data.shape[1:3])
        d = det.draws(step_generator(seed, step, device), b, hw)
        anchors, _ = det.grid(*det.feature_hw(hw), "TRAIN")
        used_b = b // 2 if half else b
        den = det.denoms(det.anchor_targets(anchors, gt[:used_b], mask[:used_b], window[:used_b],
                                            type(d)(*(t[:used_b] for t in d))), used_b)
        totals: Dict[str, float] = {}
        props = []
        cuts = _cuts(b, chunk, used_b)
        for f0, f1 in zip(cuts, cuts[1:]):
            sl = slice(f0, f1)
            pin = None if pinned is None else {k: v[sl].to(device)
                                               for k, v in pinned[step].items()}
            with torch.set_grad_enabled(f0 < used_b):
                losses, prop = det.train_losses(
                    P, (data[sl], gt[sl], mask[sl], window[sl]), type(d)(*(t[sl] for t in d)),
                    pin, q, den)
            props.append(prop)
            if f0 < used_b:
                losses["total_loss"].backward()
                for k, v in losses.items():
                    totals[k] = totals.get(k, 0.0) + float(v.detach())
        rec["losses"].append(totals)
        rec["proposals"].append({k: torch.cat([p[k] for p in props]) for k in props[0]})
        grads = opt.step(P)
        if step == 0:
            rec["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
            rec["change1_norms"] = {k: float((P[k].detach() - start[k]).norm())
                                    for k in opt.keys}
    rec["change_norms"] = {k: float((P[k].detach() - start[k]).norm()) for k in opt.keys}
    return rec


def _nms_miss(det: Detector, prop: dict, hw, phase: str, device) -> float:
    """The share of the kept proposals in which the proposal layer's choice
    differs from the reference's top-k and greedy NMS on the same fg scores
    and deltas (the reference's anchors and window)."""
    fg, deltas, window = (prop[k].to(device) for k in ("fg", "deltas", "window"))
    anchors, _ = det.grid(*det.feature_hw(hw), phase)
    _, _, valid, src = det.propose(fg, deltas, anchors, window, phase)
    want = [set(s[v].tolist()) for s, v in zip(src, valid)]
    got = [set(s[v].tolist()) for s, v in zip(prop["src"], prop["valid"])]
    return sum(len(w ^ g) for w, g in zip(want, got)) / max(1, sum(len(w) for w in want))


def judge_train(det: Detector, pool: List[dict], seed: int, device, rec: dict) -> Dict[str, float]:
    """The training numbers of a record against the float32 reference, which
    follows the record's proposals."""
    ref = reference_train(det, pool, seed, device, pinned=rec["proposals"])
    gaps = [abs(p["total_loss"] - r["total_loss"]) / abs(r["total_loss"])
            for p, r in zip(rec["losses"], ref["losses"])]
    out = {"loss_gap": max(gaps), "first_loss_gap": gaps[0]}
    out["grad_gap"] = _leaf_gap(rec["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    med = float(np.median(list(ref["grad_norms"].values())))
    moved = [k for k, g in ref["grad_norms"].items() if g >= FROZEN_SHARE * med]
    out["update_gap"] = _leaf_gap(rec["change_norms"], ref["change_norms"], moved)
    # the first update alone: what the optimizer wrote into the parameters
    # before any later step's gradient can part the two trajectories
    out["update1_gap"] = _leaf_gap(rec["change1_norms"], ref["change1_norms"], moved)
    # the first step's: later steps' scores follow weights that F1's gradient
    # path can move far apart on some seeds (PERF.md, Findings)
    out["rpn_gap"] = float((rec["proposals"][0]["fg"].to(device)
                            - ref["proposals"][0]["fg"]).abs().max())
    hw = tuple(ref["rasters"][0].shape[1:3]) if det.lidar else tuple(pool[0]["data"].shape[1:3])
    out["nms_miss"] = max(_nms_miss(det, p, hw, "TRAIN", device) for p in rec["proposals"])
    if det.lidar:
        out["raster_gap"] = max(float((p.to(r.device) - r).abs().max())
                                for p, r in zip(rec["rasters"], ref["rasters"]))
    return out


def _box_scales(det: Detector, rois, a3):
    """Per-element scale of a class's box: the RoI's diagonal for positions and
    sizes, the anchor's height for z and h, 1 for the heading."""
    w, h = rois[..., 2] - rois[..., 0] + 1.0, rois[..., 3] - rois[..., 1] + 1.0
    diag = torch.sqrt(w ** 2 + h ** 2)
    if not det.lidar:
        return diag[..., None].expand(rois.shape[:-1] + (4,))
    hz = a3[..., 5]
    one = torch.ones_like(diag)
    return torch.stack([diag, diag, hz, diag, diag, hz, one], -1)


def reference_serve(det: Detector, pool: List[dict], seed: int, device, served_dtype,
                    picks: List[int], q=None) -> dict:
    """The reference (or, with q, the control) in the program's place on the
    pool batches `picks`: a serving record."""
    P = weights(det, seed, device, served_dtype)
    rec = {"batches": []}
    with torch.no_grad():
        if det.lidar:
            rec["raster"] = _frames(det, pool[0], device, q)[0]
        for idx in picks:
            data, _, _, window = _frames(det, pool[idx], device, q)
            out = det.serve(P, data, window, q)
            prop = out.pop("proposals")
            rec["batches"].append((idx, out, {k: v.cpu() for k, v in det.filter(out).items()},
                                   prop))
    return rec


def _roi_gap(det: Detector, prop: dict, deltas, hw, phase: str, device) -> float:
    """The worst kept proposal's box against the reference's decode of the
    same anchor lane (the reference's deltas, anchors and window), over the
    anchor's diagonal: the scale by which the decode multiplies a delta.
    (Over the decoded box's own diagonal, a large anchor's box clipped to a
    sliver in the frame's corner turned the same delta error into a gap up
    to 20x larger on some seeds: PERF.md, section 2.)"""
    src, valid = prop["src"].to(device), prop["valid"].to(device)
    anchors, _ = det.grid(*det.feature_hw(hw), phase)
    a = anchors[src]
    want = ops.clip_boxes(ops.bbox_transform_inv(a, ops.gather_lanes(deltas, src)),
                          prop["window"].to(device))
    diag = torch.sqrt((a[..., 2] - a[..., 0] + 1.0) ** 2 + (a[..., 3] - a[..., 1] + 1.0) ** 2)
    gap = ((prop["rois"].to(device) - want).abs().amax(-1) / diag)[valid]
    return float(gap.max()) if gap.numel() else 0.0


PROPOSE_MISSING = ("nothing was recorded of the port's proposal layer for a judged batch: the "
                   "benchmark reads it at models.detector.propose (PERF.md, Open questions)")


def judge_serve(det: Detector, pool: List[dict], seed: int, device, served_dtype,
                rec: dict) -> Dict[str, float]:
    """The serving numbers of a record, over each sampled batch: its proposal
    stage (the scores the proposal layer saw, its choice on them, its
    boxes), its class probabilities and boxes against the float32 reference
    over the same RoIs, its filtered detections against the reference's
    filter of its outputs; LiDAR: the raster."""
    P = weights(det, seed, device, served_dtype)
    nums = {"prob_gap": 0.0, "box_gap": 0.0, "filter_miss": 0.0, "rpn_gap": 0.0,
            "nms_miss": 0.0, "roi_gap": 0.0}
    with torch.no_grad():
        if det.lidar:
            data = _frames(det, pool[0], device)[0]
            nums["raster_gap"] = float((rec["raster"].to(device) - data).abs().max())
        for idx, out, filt, prop in rec["batches"]:
            if prop is None:
                raise ValueError(PROPOSE_MISSING)
            data, _, _, window = _frames(det, pool[idx], device)
            hw = tuple(data.shape[1:3])
            out = {k: v.to(device) for k, v in out.items()}
            valid = out["roi_valid"]
            a3 = out.get("anchors_3d")
            if a3 is not None:  # each RoI's 3D anchor must be one of the grid's
                grid = det.grid(*det.feature_hw(hw), "TEST")[1]
                known = (a3[..., None, :] == grid[None, None]).all(-1).any(-1)
                if not bool(known[valid].all()):
                    nums["box_gap"] = float("inf")
            ref = det.serve(P, data, window, rois=out["rois"], anchors_3d=a3)
            seen = ref["proposals"]
            nums["rpn_gap"] = max(nums["rpn_gap"],
                                  float((prop["fg"].to(device) - seen["fg"]).abs().max()))
            miss = _nms_miss(det, prop, hw, "TEST", device)
            if not torch.equal(prop["rois"].to(device), out["rois"]):
                miss = 1.0  # the second stage pooled other boxes than the proposal layer chose
            nums["nms_miss"] = max(nums["nms_miss"], miss)
            nums["roi_gap"] = max(nums["roi_gap"],
                                  _roi_gap(det, prop, seen["deltas"], hw, "TEST", device))
            dp = (out["cls_prob"] - ref["cls_prob"]).abs()[valid]
            nums["prob_gap"] = max(nums["prob_gap"], float(dp.max()) if dp.numel() else 0.0)
            b, s = valid.shape
            scale = _box_scales(det, out["rois"], a3)
            db = ((out["bbox_pred"] - ref["bbox_pred"]).reshape(b, s, det.k, det.elem).abs()
                  / scale[:, :, None, :])[valid]
            if db.numel():
                nums["box_gap"] = max(nums["box_gap"], float(db.max()))
            nums["filter_miss"] = max(nums["filter_miss"], _filter_miss(det.filter(out), filt))
    return nums


def _filter_miss(want: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]) -> float:
    """The share of the expected detections (frame, class, RoI, box, score) that
    the program's filtered detections do not hold exactly, and the share of
    the program's that were not expected, the larger."""
    def rows(d):
        d = {k: v.cpu() for k, v in d.items()}
        out = set()
        for f, c, m in zip(*torch.nonzero(d["valid"], as_tuple=True)):
            f, c, m = int(f), int(c), int(m)
            out.add((f, c, int(d["src_idx"][f, c, m]), float(d["scores"][f, c, m]),
                     tuple(d["boxes"][f, c, m].tolist())))
        return out

    w, g = rows(want), rows(got)
    if not w and not g:
        return 0.0
    return max(len(w - g) / max(len(w), 1), len(g - w) / max(len(g), 1))
