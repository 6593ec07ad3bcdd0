"""Final-detection filtering: per-class threshold -> NMS -> gather.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/filter.py:33-145: the image
path and the lidar path, whose NMS runs on the axis-aligned BEV footprint
center +- (l, w) / 2 and ignores the heading (:61-78).  The rotated-NMS
option (TEST.ROTATED_NMS) needs the rotated IoU kernel, which is not ported:
it raises.  The JAX package vmaps a per-class NMS over classes, one frame at
a time; here every (frame, class) pair is one problem of a single batched
NMS launch.  `to_per_class_lists` is the host-side numpy conversion, copied.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms


def filter_detections(
    cls_prob: torch.Tensor,
    pred_boxes: torch.Tensor,
    roi_valid: torch.Tensor,
    *,
    num_classes: int,
    bbox_elem: int,
    max_dets: int = 100,
    thresh: float = 0.5,
    nms_thresh: float = 0.6,
    is_lidar: bool = False,
    rotated_nms: bool = False,
) -> Dict[str, torch.Tensor]:
    """cls_prob (..., S, K), pred_boxes (..., S, E*K), roi_valid (..., S);
    E is 4 for image boxes, 7 ([xc, yc, zc, l, w, h, ry]) with is_lidar.

    Returns a dict of (..., K, M, .) tensors, M = min(S, max_dets): boxes
    (E), scores, valid and src_idx (index into the S rois).  Class 0
    (background) lanes are always invalid.
    """
    if rotated_nms:
        raise NotImplementedError(
            "filter_detections: rotated NMS (TEST.ROTATED_NMS) needs the rotated IoU "
            "kernel, which is not ported")
    if bbox_elem != (7 if is_lidar else 4):
        raise ValueError(f"filter_detections: bbox_elem {bbox_elem} with is_lidar={is_lidar}")
    k = cls_prob.shape[-1]
    if k != num_classes:
        raise ValueError(f"filter_detections: {k} class columns, num_classes {num_classes}")
    scores = cls_prob.transpose(-1, -2)  # (..., K, S)
    boxes = pred_boxes.reshape(pred_boxes.shape[:-1] + (k, bbox_elem)).transpose(-2, -3)
    not_bg = torch.arange(k, device=cls_prob.device) > 0
    valid = roi_valid[..., None, :] & (scores > thresh) & not_bg[:, None]
    if is_lidar:
        half_l, half_w = boxes[..., 3] / 2.0, boxes[..., 4] / 2.0
        nms_boxes = torch.stack([boxes[..., 0] - half_l, boxes[..., 1] - half_w,
                                 boxes[..., 0] + half_l, boxes[..., 1] + half_w], dim=-1)
    else:
        nms_boxes = boxes[..., :4]
    keep, keep_valid = nms(nms_boxes.contiguous(), scores, nms_thresh, max_dets, valid=valid)
    keep = keep.long()
    kept_scores = torch.gather(scores, -1, keep)
    return {
        "boxes": torch.gather(boxes, -2, keep[..., None].expand(keep.shape + (bbox_elem,))),
        "scores": torch.where(keep_valid, kept_scores, torch.zeros_like(kept_scores)),
        "valid": keep_valid,
        "src_idx": keep,
    }


def clamp_image_boxes(
    pred_boxes: torch.Tensor, info: torch.Tensor, bbox_elem: int = 4
) -> torch.Tensor:
    """Clamp per-class image boxes to the unscaled frame.
    info = [xmin, xmax, ymin, ymax, ..., scale]."""
    scale = info[-1]
    w = (info[1] - info[0]) / scale - 1.0
    h = (info[3] - info[2]) / scale - 1.0
    b = pred_boxes.reshape(pred_boxes.shape[:-1] + (-1, bbox_elem))
    b = torch.stack(
        [
            torch.clamp(b[..., 0], min=0.0),
            torch.clamp(b[..., 1], min=0.0),
            torch.minimum(b[..., 2], w),
            torch.minimum(b[..., 3], h),
        ],
        dim=-1,
    )
    return b.reshape(pred_boxes.shape)


def to_per_class_lists(
    filtered: Dict[str, np.ndarray],
    uncertainties: Dict[str, np.ndarray],
    num_classes: int,
    bbox_elem: int,
) -> Tuple[list, list]:
    """Host-side, one frame: padded (K, M, .) arrays -> the reference's
    ragged layout (all_boxes[j] = (n_j, E+1) [box..., score]; all_uc[j] a
    dict of the uncertainty rows of the kept detections)."""
    all_boxes = [np.empty((0, bbox_elem + 1), np.float32) for _ in range(num_classes)]
    all_uc = [{} for _ in range(num_classes)]
    boxes = np.asarray(filtered["boxes"])
    scores = np.asarray(filtered["scores"])
    valid = np.asarray(filtered["valid"])
    src = np.asarray(filtered["src_idx"])
    for j in range(1, num_classes):
        v = valid[j]
        if not v.any():
            continue
        all_boxes[j] = np.hstack(
            [boxes[j][v], scores[j][v][:, None]]
        ).astype(np.float32)
        uc_j = {}
        for key, tensor in uncertainties.items():
            t = np.asarray(tensor)
            sel = t[src[j][v]]
            if key in ("a_bbox_var", "e_bbox_var") and t.ndim == 2 and t.shape[1] == num_classes * bbox_elem:
                sel = t[src[j][v], j * bbox_elem : (j + 1) * bbox_elem]
            elif sel.ndim == 1:
                sel = sel[:, None]
            uc_j[key] = sel
        all_uc[j] = uc_j
    return all_boxes, all_uc
