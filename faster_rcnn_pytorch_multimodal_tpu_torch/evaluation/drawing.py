"""Frame drawing for the Solver's val cycle and tools/demo_torch.py.

A copy of faster_rcnn_pytorch_multimodal_tpu/evaluation/drawing.py: one
frame's per-class detection lists (ops.filter.to_per_class_lists) and GT
drawn on the network-space frame (the normalized or raw image, or the BEV
raster), ordered and coloured by UC.SORT_TYPE, and `proposal_recall`, the
RPN-only val metric.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from faster_rcnn_pytorch_multimodal_tpu_torch.utils import visualization as viz


def draw_frame_detections(
    cfg,
    data: np.ndarray,
    boxes_j: List[np.ndarray],
    classes: Sequence[str],
    path: str,
    gt_boxes: Optional[np.ndarray] = None,
    uc_j: Optional[List[Dict[str, np.ndarray]]] = None,
) -> np.ndarray:
    """Draw one frame's detections (and GT), save to `path`, and return the
    drawn canvas (HWC uint8) for tensorboard image summaries.

    data: the network-space frame — (H, W, 3) normalized image for image
      nets, (H, W, C) BEV raster for lidar nets.
    boxes_j: per-class list; boxes_j[j] is (n_j, E+1) [box..., score] in
      network frame space (scaled pixels / voxel grid).
    gt_boxes: (G, 5|8) network-space GT rows (last column = class).
    """
    raw_uint8 = np.asarray(data).dtype == np.uint8
    data = np.asarray(data, np.float32)
    sort_key = cfg.uc.sort_type
    num_classes = len(classes)
    if cfg.net_type == "lidar":
        dets = [boxes_j[j] for j in range(1, num_classes) if len(boxes_j[j])]
        canvas = viz.draw_detections_bev(
            data,
            np.vstack(dets) if dets else np.zeros((0, 8)),
            gt7=gt_boxes,
            sort_key=sort_key,
        )
    else:
        disp = (
            data
            if raw_uint8
            else data * np.asarray(cfg.pixel_stddevs) + np.asarray(cfg.pixel_means)
        )
        canvas = disp[:, :, ::-1]  # BGR blob -> RGB canvas
        if gt_boxes is not None and len(gt_boxes):
            canvas = viz.draw_bounding_boxes(canvas, gt_boxes, classes=classes)
        for j in range(1, num_classes):
            if len(boxes_j[j]):
                # per-class uc arrives as a dict of (n_j, ·) arrays; the
                # drawer wants one dict per detection
                uc_rows = None
                if uc_j and uc_j[j]:
                    n = len(boxes_j[j])
                    uc_rows = [
                        {k: v[i] for k, v in uc_j[j].items()} for i in range(n)
                    ]
                canvas = viz.draw_detections_image(
                    canvas,
                    boxes_j[j],
                    class_name=classes[j],
                    uncertainties=uc_rows,
                    sort_key=sort_key,
                )
    viz.save_image(canvas, path)
    # HWC uint8 for the tensorboard image summary (ref logs GT-drawn val
    # frames into TB via lib/utils/visualization.py:71 draw_summary hooks)
    return np.clip(np.asarray(canvas), 0, 255).astype(np.uint8)


def proposal_recall(
    rois: np.ndarray,
    roi_valid: np.ndarray,
    gt_boxes: np.ndarray,
    gt_mask: np.ndarray,
    iou_thresh: float = 0.5,
) -> tuple:
    """RPN-only validation metric: fraction of GT boxes covered by at least
    one proposal at `iou_thresh` (the reference's RPN-only val path NMSes
    proposals and inspects them by hand, ref train_val.py:424-435; recall is
    the scalar worth logging).

    rois (B, P, 4) axis-aligned network-space boxes, roi_valid (B, P),
    gt_boxes (B, G, >=4) (BEV AABB for lidar callers), gt_mask (B, G).
    Returns (covered, total).
    """
    covered = 0
    total = 0
    for b in range(rois.shape[0]):
        r = rois[b][np.asarray(roi_valid[b], bool)]
        g = gt_boxes[b][np.asarray(gt_mask[b], bool)][:, :4]
        total += len(g)
        if not len(g) or not len(r):
            continue
        # pairwise IoU, +1 pixel convention (matches ops.iou.bbox_overlaps)
        ix1 = np.maximum(r[:, None, 0], g[None, :, 0])
        iy1 = np.maximum(r[:, None, 1], g[None, :, 1])
        ix2 = np.minimum(r[:, None, 2], g[None, :, 2])
        iy2 = np.minimum(r[:, None, 3], g[None, :, 3])
        iw = np.clip(ix2 - ix1 + 1.0, 0.0, None)
        ih = np.clip(iy2 - iy1 + 1.0, 0.0, None)
        inter = iw * ih
        area_r = (r[:, 2] - r[:, 0] + 1.0) * (r[:, 3] - r[:, 1] + 1.0)
        area_g = (g[:, 2] - g[:, 0] + 1.0) * (g[:, 3] - g[:, 1] + 1.0)
        iou = inter / np.maximum(area_r[:, None] + area_g[None, :] - inter, 1e-9)
        covered += int((iou.max(axis=0) >= iou_thresh).sum())
    return covered, total
