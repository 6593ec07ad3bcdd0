"""Pairwise box IoU with the reference's +1 pixel areas, and the BEV
envelope of rotated boxes.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/iou.py:14 `bbox_overlaps`
and :40 `bbox_3d_to_bev_aabb`.
The anchor and proposal targets depend on the +1 convention.  At the C4
training shapes this is (32 * 60 * 25) anchors x 64 GT boxes a frame, an
elementwise broadcast that plain torch runs at memory speed; no kernel.
"""

from __future__ import annotations

import torch


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """IoU of (..., N, 4) boxes vs (..., K, 4) query boxes -> (..., N, K)."""
    areas = (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)
    qareas = (query_boxes[..., 2] - query_boxes[..., 0] + 1.0) * (
        query_boxes[..., 3] - query_boxes[..., 1] + 1.0
    )
    b = boxes[..., :, None, :]
    q = query_boxes[..., None, :, :]
    iw = torch.clamp(
        torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0]) + 1.0, min=0.0
    )
    ih = torch.clamp(
        torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1]) + 1.0, min=0.0
    )
    inter = iw * ih
    return inter / (areas[..., :, None] + qareas[..., None, :] - inter)


def bbox_3d_to_bev_aabb(boxes7: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV envelope (x1, y1, x2, y2) of rotated 7-DoF boxes:
    half-extents (|l cos ry| + |w sin ry|) / 2 and (|l sin ry| + |w cos ry|) / 2."""
    x, y = boxes7[..., 0], boxes7[..., 1]
    l, w = boxes7[..., 3], boxes7[..., 4]
    ry = boxes7[..., 6]
    c, s = torch.abs(torch.cos(ry)), torch.abs(torch.sin(ry))
    ex = (l * c + w * s) / 2.0
    ey = (l * s + w * c) / 2.0
    return torch.stack([x - ex, y - ey, x + ex, y + ey], dim=-1)
