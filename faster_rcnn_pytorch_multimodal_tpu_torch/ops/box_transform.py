"""Box encode/decode and clipping on tensors, polymorphic over leading dims.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/box_transform.py:21-88 (2D),
:96-157 (`_roi_bev_geometry`, `lidar_3d_bbox_transform` and its inverse)
and :166-214 (the uncertainty inverse transforms).  Keeps the reference's diagonal-normalized dx/dy (divided by
sqrt(w^2 + h^2), not by w and h) and the +1 widths (parity waiver 2):
checkpoints are only compatible with this variant.
"""

from __future__ import annotations

import torch


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor) -> torch.Tensor:
    """Encode GT boxes w.r.t. example RoIs -> (..., 4) [dx, dy, dw, dh]."""
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_diag = torch.sqrt(ex_w**2 + ex_h**2)
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h

    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h

    return torch.stack(
        [
            (gt_cx - ex_cx) / ex_diag,
            (gt_cy - ex_cy) / ex_diag,
            torch.log(gt_w / ex_w),
            torch.log(gt_h / ex_h),
        ],
        dim=-1,
    )


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode (..., 4K) deltas against (..., 4) boxes -> (..., 4K) x1y1x2y2."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    diag = torch.sqrt(w**2 + h**2)
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    pred_cx = d[..., 0] * diag[..., None] + cx[..., None]
    pred_cy = d[..., 1] * diag[..., None] + cy[..., None]
    pred_w = torch.exp(d[..., 2]) * w[..., None]
    pred_h = torch.exp(d[..., 3]) * h[..., None]

    out = torch.stack(
        [
            pred_cx - 0.5 * pred_w,
            pred_cy - 0.5 * pred_h,
            pred_cx + 0.5 * pred_w,
            pred_cy + 0.5 * pred_h,
        ],
        dim=-1,
    )
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Clamp (..., 4K) boxes to window [xmin, xmax, ymin, ymax]: x to
    [xmin, xmax - 1], y to [ymin, ymax - 1].

    `window` is (4,) or carries the boxes' leading batch dims, e.g. (B, 4)
    for (B, S, 4K) boxes.
    """
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    # window (..., 4) -> (..., 1, ..., 1) per bound, broadcast against b[..., i]
    pad = (1,) * (b.dim() - 1 - (window.dim() - 1))

    def bound(i: int, sub: float) -> torch.Tensor:
        return (window[..., i] - sub).reshape(window.shape[:-1] + pad)

    x_lo, x_hi = bound(0, 0.0), bound(1, 1.0)
    y_lo, y_hi = bound(2, 0.0), bound(3, 1.0)
    x1 = torch.clamp(b[..., 0], x_lo, x_hi)
    y1 = torch.clamp(b[..., 1], y_lo, y_hi)
    x2 = torch.clamp(b[..., 2], x_lo, x_hi)
    y2 = torch.clamp(b[..., 3], y_lo, y_hi)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)


def _roi_bev_geometry(rois: torch.Tensor):
    """(lengths, widths, ctr_x, ctr_y, diag) of BEV RoIs [x1, y1, x2, y2]."""
    lengths = rois[..., 2] - rois[..., 0] + 1.0
    widths = rois[..., 3] - rois[..., 1] + 1.0
    ctr_x = rois[..., 0] + lengths / 2.0
    ctr_y = rois[..., 1] + widths / 2.0
    diag = torch.sqrt(lengths**2 + widths**2)
    return lengths, widths, ctr_x, ctr_y, diag


def lidar_3d_bbox_transform(
    ex_rois: torch.Tensor, ex_anchors: torch.Tensor, gt_rois: torch.Tensor
) -> torch.Tensor:
    """Encode 7-DoF GT (..., 7) [xc, yc, zc, l, w, h, ry] against (BEV RoI
    (..., 4), 3D anchor (..., 7)) pairs -> (..., 7) targets: xy offsets over
    the RoI's diagonal, log l and w over the RoI's +1 lengths, z and h
    against the anchor, the raw GT heading."""
    lengths, widths, cx, cy, diag = _roi_bev_geometry(ex_rois)
    anc_z = ex_anchors[..., 2]
    anc_h = ex_anchors[..., 5]
    return torch.stack(
        [
            (gt_rois[..., 0] - cx) / diag,
            (gt_rois[..., 1] - cy) / diag,
            (gt_rois[..., 2] - anc_z) / anc_h,
            torch.log(gt_rois[..., 3] / lengths),
            torch.log(gt_rois[..., 4] / widths),
            torch.log(gt_rois[..., 5] / anc_h),
            gt_rois[..., 6],
        ],
        dim=-1,
    )


def lidar_3d_bbox_transform_inv(
    rois: torch.Tensor, anchors_3d: torch.Tensor, deltas: torch.Tensor
) -> torch.Tensor:
    """Decode (..., 7K) deltas -> (..., 7K) [xc, yc, zc, l, w, h, ry] in
    voxel units: (ctr, l, w) from the BEV RoI, (z, h) from its 3D anchor,
    the heading as predicted."""
    lengths, widths, cx, cy, diag = _roi_bev_geometry(rois)
    heights = anchors_3d[..., 5]
    cz = anchors_3d[..., 2]
    d = deltas.reshape(deltas.shape[:-1] + (-1, 7))
    pred = torch.stack(
        [
            d[..., 0] * diag[..., None] + cx[..., None],
            d[..., 1] * diag[..., None] + cy[..., None],
            d[..., 2] * heights[..., None] + cz[..., None],
            torch.exp(d[..., 3]) * lengths[..., None],
            torch.exp(d[..., 4]) * widths[..., None],
            torch.exp(d[..., 5]) * heights[..., None],
            d[..., 6],
        ],
        dim=-1,
    )
    return pred.reshape(deltas.shape)


# -- uncertainty inverse transforms: a delta-space std -> a box-space variance


def uncertainty_transform_inv(boxes: torch.Tensor, uncertainty: torch.Tensor) -> torch.Tensor:
    """Image boxes (..., 4) and a delta-space std (..., 4K) -> box-space
    variances (..., 4K): x and y scaled by the box's +1 width and height,
    w and h through exp(u) - 1, then squared.  The 4-element layout of the
    JAX package (its reference strides by 7 here, which the JAX package
    does not copy; carried as it is)."""
    lengths = boxes[..., 2] - boxes[..., 0] + 1.0
    widths = boxes[..., 3] - boxes[..., 1] + 1.0
    u = uncertainty.reshape(uncertainty.shape[:-1] + (-1, 4))
    out = torch.stack(
        [
            u[..., 0] * lengths[..., None],
            u[..., 1] * widths[..., None],
            torch.exp(u[..., 2]) - 1.0,
            torch.exp(u[..., 3]) - 1.0,
        ],
        dim=-1,
    )
    return (out**2).reshape(uncertainty.shape)


def lidar_3d_uncertainty_transform_inv(
    rois: torch.Tensor, anchors_3d: torch.Tensor, uncertainty: torch.Tensor
) -> torch.Tensor:
    """BEV RoIs (..., 4), their 3D anchors (..., 7) and a delta-space std
    (..., 7K) -> 7-DoF variances (..., 7K): x, y by the RoI's +1 lengths, z
    by the anchor's height, l, w, h through exp(u) - 1, the heading as it
    is, then squared."""
    lengths = rois[..., 2] - rois[..., 0] + 1.0
    widths = rois[..., 3] - rois[..., 1] + 1.0
    heights = anchors_3d[..., 5]
    u = uncertainty.reshape(uncertainty.shape[:-1] + (-1, 7))
    out = torch.stack(
        [
            u[..., 0] * lengths[..., None],
            u[..., 1] * widths[..., None],
            u[..., 2] * heights[..., None],
            torch.exp(u[..., 3]) - 1.0,
            torch.exp(u[..., 4]) - 1.0,
            torch.exp(u[..., 5]) - 1.0,
            u[..., 6],
        ],
        dim=-1,
    )
    return (out**2).reshape(uncertainty.shape)
