"""DEBUG draw switches (ref lib/model/config.py:19-31): the port of
faster_rcnn_pytorch_multimodal_tpu/utils/debug_draw.py.

The anchors, the anchor targets and the proposal targets of frame 0 of a
batch, drawn onto that frame.  Computing and drawing are apart:
`anchor_boxes`, `anchor_target_boxes` and `proposal_target_boxes` return the
boxes and their classes, computed with torch on the batch's (or the
model's) device, so that DRAW_PROPOSAL_T's proposals (`train_proposals`) go
through NMS (K1) on the card; `draw_anchors`, `draw_anchor_targets` and
`draw_proposal_targets` write them as PNGs through PIL, imported at the
call (as utils/visualization does).  The Solver calls the three draws on the first batch of `train`,
with the weights of that step (JAX solver.py:341-358, :531-536).

As in JAX: the anchor grid is built at frame scale 1.0 over the floor of
the frame over the feature stride; the anchor targets use the train-phase
RPN overlaps; the proposal targets run `features` with the running
statistics (eval mode), the train-phase proposals and proposal_target
without the GT boxes among the RoIs.  JAX draws the sampling keys from
PRNGKey(0); here they come from a generator seeded 0, or the caller gives
them (`keys`: the fg and bg uniform keys, (1, N) for the anchors, (B, R)
for the RoIs).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.utils import visualization as viz

Boxes = Dict[str, Tuple[np.ndarray, np.ndarray]]  # group -> ((n, 4) boxes, (n,) classes)

BG_COLOR, FG_COLOR, GT_COLOR = (255, 64, 64), (64, 255, 64), (255, 255, 255)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _on(v, device, dtype=None) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    return t.to(device=device, dtype=dtype or t.dtype)


def _keys(keys, shape, device) -> Tuple[torch.Tensor, torch.Tensor]:
    if keys is not None:
        return tuple(_on(k, device, torch.float32) for k in keys)
    g = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.rand(shape, generator=g, device=device) for _ in range(2))


def _grid(cfg, data_shape) -> np.ndarray:
    """The BEV (or 2D) anchors over frame 0's feature map at frame scale 1."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import (
        build_anchor_grid,
        feat_stride,
    )

    stride = feat_stride(cfg)
    anchors, _ = build_anchor_grid(cfg, data_shape[1] // stride, data_shape[2] // stride, 1.0)
    return anchors


def _gt_bev(cfg, gt: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x1, y1, x2, y2, cls]: image GT as it is, lidar GT's BEV
    envelope and class."""
    if cfg.net_type != "lidar":
        return gt
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.iou import bbox_3d_to_bev_aabb

    return torch.cat([bbox_3d_to_bev_aabb(gt[..., :7]), gt[..., 7:8]], dim=-1)


def _gt_group(cfg, batch, device) -> Tuple[np.ndarray, np.ndarray]:
    gt = _host(_gt_bev(cfg, _on(batch["gt_boxes"][0], device, torch.float32)))
    mask = _host(batch["gt_mask"][0]).astype(bool)
    return gt[mask, :4], gt[mask, 4].astype(np.int64)


def anchor_boxes(cfg, batch: Mapping, max_draw: int = 256) -> Boxes:
    """DEBUG.DRAW_ANCHORS: every len // max_draw-th anchor of frame 0's grid
    (class -1: no class)."""
    anchors = _grid(cfg, batch["data"].shape)
    sub = anchors[:: max(1, len(anchors) // max_draw)]
    return {"anchors": (sub, np.full(len(sub), -1, np.int64))}


def anchor_target_boxes(cfg, batch: Mapping, device=None, keys=None) -> Boxes:
    """DEBUG.DRAW_ANCHOR_T: frame 0's sampled anchors, bg (class 0) and fg
    (class 1), and its GT boxes (BEV envelopes for lidar) with their
    classes; anchor_target on `device` (default the batch data's)."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.targets import (
        anchor_target,
        effective_rpn_overlaps,
    )

    data = batch["data"]
    device = torch.device(device) if device is not None else (
        data.device if isinstance(data, torch.Tensor) else torch.device("cpu"))
    anchors = _on(_grid(cfg, data.shape), device)
    gt = _gt_bev(cfg, _on(batch["gt_boxes"][:1], device, torch.float32))
    fg_keys, bg_keys = _keys(keys, (1, anchors.shape[0]), device)
    pos_ov, neg_ov = effective_rpn_overlaps(cfg)
    at = anchor_target(
        anchors, gt, _on(batch["gt_mask"][:1], device, torch.bool),
        _on(batch["window"][:1], device, torch.float32), fg_keys, bg_keys,
        rpn_batchsize=cfg.train.rpn_batchsize, fg_fraction=cfg.train.rpn_fg_fraction,
        positive_overlap=pos_ov, negative_overlap=neg_ov,
        clobber_positives=cfg.train.rpn_clobber_positives,
    )
    labels = _host(at.labels[0])
    sel = _host(anchors[at.sel[0]])
    return {"bg": (sel[labels == 0.0], np.zeros(int((labels == 0.0).sum()), np.int64)),
            "fg": (sel[labels == 1.0], np.ones(int((labels == 1.0).sum()), np.int64)),
            "gt": _gt_group(cfg, batch, device)}


def train_proposals(cfg, model, batch: Mapping):
    """The train-phase proposals of a batch from the model's current weights
    on its device (its compute dtype; the running statistics, no update):
    (rois (B, P, 4), valid (B, P), src (B, P) anchor lanes, anchors_3d
    (B, P, 7) for lidar else None)."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import eval_mode, model_device
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import compute_call

    device = model_device(model)
    with eval_mode(model), torch.no_grad():
        feat = compute_call(model, "features", _on(batch["data"], device))
        rpn_out = compute_call(model, "rpn_scores", feat)
        m = model.rpn_map(feat)
        anchors, anchors_3d = model.anchor_grids(m.shape[1], m.shape[2], device, "train")
        rois, _scores, valid, src = model._propose_batch(
            rpn_out, anchors, _on(batch["window"], device, torch.float32), "train")
    return rois, valid, src, anchors_3d[src] if cfg.net_type == "lidar" else None


def proposal_target_boxes(cfg, model, batch: Mapping, keys=None, proposals=None) -> Boxes:
    """DEBUG.DRAW_PROPOSAL_T: frame 0's sampled second-stage RoIs, bg (class
    0) and fg (their class), and its GT boxes: proposal_target on the
    model's device over train_proposals, or over the given `proposals`
    (train_proposals' tuple, from another device: a check pins them)."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import model_device
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.targets import proposal_target

    device = model_device(model)
    lidar = cfg.net_type == "lidar"
    gt = _on(batch["gt_boxes"], device, torch.float32)
    gt_mask = _on(batch["gt_mask"], device, torch.bool)
    b = gt.shape[0]
    if proposals is None:
        proposals = train_proposals(cfg, model, batch)
    rois, valid, _src, roi_a3d = (None if t is None else t.to(device) for t in proposals)
    with torch.no_grad():
        fg_keys, bg_keys = _keys(keys, tuple(valid.shape), device)
        tc = cfg.train
        dc = batch.get("gt_boxes_dc")
        dc_mask = batch.get("dc_mask")
        pt = proposal_target(
            rois, valid, _gt_bev(cfg, gt), gt_mask,
            _on(dc, device, torch.float32) if dc is not None else torch.zeros((b, 1, 4),
                                                                              device=device),
            _on(dc_mask, device, torch.bool) if dc_mask is not None else torch.zeros(
                (b, 1), dtype=torch.bool, device=device),
            fg_keys, bg_keys,
            torch.tensor(tc.lidar_bbox_normalize_means if lidar else tc.image_bbox_normalize_means,
                         device=device),
            torch.tensor(tc.lidar_bbox_normalize_stds if lidar else tc.image_bbox_normalize_stds,
                         device=device),
            num_classes=model.num_classes, num_bbox_elem=cfg.num_bbox_elem,
            roi_batch_size=tc.roi_batch_size, fg_fraction=tc.fg_fraction,
            fg_thresh=tc.fg_thresh, bg_thresh_hi=tc.bg_thresh_hi, bg_thresh_lo=tc.bg_thresh_lo,
            ignore_dc=tc.ignore_dc, dc_thresh=tc.dc_thresh,
            anchors_3d=roi_a3d, true_gt_boxes=gt if lidar else None,
        )
    labels, ok, boxes = _host(pt.labels[0]), _host(pt.valid[0]), _host(pt.rois[0])
    bg, fg = (labels == 0) & ok, (labels > 0) & ok
    return {"bg": (boxes[bg], labels[bg].astype(np.int64)),
            "fg": (boxes[fg], labels[fg].astype(np.int64)),
            "gt": _gt_group(cfg, batch, device)}


# -- the PNG writers ---------------------------------------------------------------


def _canvas(cfg, frame: np.ndarray) -> np.ndarray:
    if cfg.net_type == "lidar":
        return viz.bev_to_rgb(frame).astype(np.float32)
    if frame.dtype == np.uint8:  # loaders ship raw frames
        return frame.astype(np.float32)[:, :, ::-1]
    disp = frame * np.asarray(cfg.pixel_stddevs) + np.asarray(cfg.pixel_means)
    return disp[:, :, ::-1]


def _draw_boxes(canvas, boxes, color):
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.clip(canvas, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for b in boxes:
        draw.rectangle([float(b[0]), float(b[1]), float(b[2]), float(b[3])],
                       outline=color, width=1)
    return np.asarray(img).astype(np.float32)


def _save(cfg, batch, groups, out_dir: str, name: str) -> str:
    canvas = _canvas(cfg, _host(batch["data"][0]))
    for boxes, color in groups:
        canvas = _draw_boxes(canvas, boxes, color)
    path = os.path.join(out_dir, name)
    viz.save_image(canvas, path)
    return path


def draw_anchors(cfg, batch: Mapping, out_dir: str, max_draw: int = 256,
                 boxes: Optional[Boxes] = None) -> str:
    """DEBUG.DRAW_ANCHORS: a subsample of the anchor grid over frame 0,
    written to out_dir/anchors.png."""
    boxes = boxes or anchor_boxes(cfg, batch, max_draw)
    return _save(cfg, batch, [(boxes["anchors"][0], (80, 160, 255))], out_dir, "anchors.png")


def draw_anchor_targets(cfg, batch: Mapping, out_dir: str,
                        boxes: Optional[Boxes] = None) -> str:
    """DEBUG.DRAW_ANCHOR_T: fg anchors green, a subsample of the bg ones
    red, GT white (out_dir/anchor_targets.png)."""
    boxes = boxes or anchor_target_boxes(cfg, batch)
    bg = boxes["bg"][0]
    return _save(cfg, batch, [(bg[:: max(1, len(bg) // 64)], BG_COLOR),
                              (boxes["fg"][0], FG_COLOR), (boxes["gt"][0], GT_COLOR)],
                 out_dir, "anchor_targets.png")


def draw_proposal_targets(cfg, model, batch: Mapping, out_dir: str,
                          boxes: Optional[Boxes] = None) -> str:
    """DEBUG.DRAW_PROPOSAL_T: the second stage's sampled RoIs, fg green, bg
    red, GT white, on frame 0 (out_dir/proposal_targets.png)."""
    boxes = boxes or proposal_target_boxes(cfg, model, batch)
    return _save(cfg, batch, [(boxes["bg"][0], BG_COLOR), (boxes["fg"][0], FG_COLOR),
                              (boxes["gt"][0], GT_COLOR)], out_dir, "proposal_targets.png")
