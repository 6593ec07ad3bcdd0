"""2D and 3D anchor generation (host-side numpy).

Port of faster_rcnn_pytorch_multimodal_tpu/ops/anchors.py:26-154, copied.
Anchor grids depend only on static shapes, so they are computed once on the
host and cached on the device by the detector.  Bit-exact with the JAX
package, including numpy's round-half-even in the ratio enumeration (parity
waiver 1).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def _whctrs(anchor: np.ndarray) -> Tuple[float, float, float, float]:
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr) -> np.ndarray:
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack(
        (
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        )
    )


def generate_anchors(
    base_size: int = 16,
    ratios: Sequence[float] = (0.5, 1, 2),
    scales: Sequence[float] = (8, 16, 32),
) -> np.ndarray:
    """Enumerate (ratio x scale) reference windows around (0,0,15,15)."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    w, h, xc, yc = _whctrs(base)
    size = w * h
    ws_r = np.round(np.sqrt(size / ratios))
    hs_r = np.round(ws_r * ratios)
    ratio_anchors = _mkanchors(ws_r, hs_r, xc, yc)
    out = []
    for ra in ratio_anchors:
        w, h, xc, yc = _whctrs(ra)
        out.append(_mkanchors(w * scales, h * scales, xc, yc))
    return np.vstack(out)


def generate_anchors_pre(
    height: int,
    width: int,
    feat_stride: int,
    anchor_scales: Sequence[float] = (8, 16, 32),
    anchor_ratios: Sequence[float] = (0.5, 1, 2),
    frame_scale: float = 1.0,
) -> Tuple[np.ndarray, int]:
    """Shift the base anchors over the H x W feature grid.

    Returns (K*A, 4) float32 anchors ordered anchor-fastest (row-major over
    (y, x, A)), so the RPN tensor reshapes line up.
    """
    scales = np.asarray(anchor_scales, dtype=np.float64) * frame_scale
    anchors = generate_anchors(ratios=anchor_ratios, scales=scales)
    a = anchors.shape[0]
    shift_x = np.arange(0, width) * feat_stride
    shift_y = np.arange(0, height) * feat_stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack((sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()), axis=1)
    k = shifts.shape[0]
    all_anchors = (anchors[None, :, :] + shifts[:, None, :]).reshape(k * a, 4)
    return all_anchors.astype(np.float32), int(k * a)


def generate_3d_anchors(
    height: int,
    width: int,
    feat_stride: int,
    anchor_sizes_lwh: Sequence[Sequence[float]] = ((4.73, 2.08, 1.77),),
    anchor_scales: Sequence[float] = (1.0,),
    anchor_rotations: Sequence[float] = (0.0, math.pi / 2),
    voxel_len: float = 0.1,
    frame_scale: float = 1.0,
) -> Tuple[int, np.ndarray]:
    """BEV-grid 3D anchors, N x [x, y, z, l, w, h, ry] in voxel-grid units.

    Centers tile every `feat_stride` voxel cells over [0, W*stride - 1) x
    [0, H*stride - 1); (l, w) go from meters to voxels with
    voxel_len / frame_scale; z sits at half the (metric) anchor height.
    Lanes are ordered (y, x, size, rotation), row-major."""
    if len(anchor_scales) != 1:
        raise ValueError("generate_3d_anchors: a single 3D anchor scale is supported")
    x_max = width * feat_stride - 1
    y_max = height * feat_stride - 1
    eff_voxel_len = voxel_len / frame_scale
    sizes = (
        np.asarray(anchor_sizes_lwh, dtype=np.float64)
        / np.array([eff_voxel_len, eff_voxel_len, 1.0])
        * anchor_scales[0]
    )
    rotations = np.asarray(anchor_rotations, dtype=np.float64)
    x_centers = np.arange(0, x_max, feat_stride, dtype=np.float64)
    y_centers = np.arange(0, y_max, feat_stride, dtype=np.float64)
    yy, xx, ss, rr = np.meshgrid(
        y_centers, x_centers, np.arange(len(sizes)), np.arange(len(rotations)), indexing="ij"
    )
    flat = np.stack([xx.ravel(), yy.ravel(), ss.ravel(), rr.ravel()], axis=1)
    out = np.zeros((flat.shape[0], 7), dtype=np.float32)
    out[:, 0] = flat[:, 0]
    out[:, 1] = flat[:, 1]
    out[:, 2] = sizes[0][2] / 2.0
    out[:, 3:6] = sizes[flat[:, 2].astype(np.int64)]
    out[:, 6] = rotations[flat[:, 3].astype(np.int64)]
    return flat.shape[0], out


def anchors_3d_to_bev_aabb(anchors_3d: np.ndarray) -> np.ndarray:
    """Axis-aligned BEV footprint (x1, y1, x2, y2) of 3D anchors: the pi/2
    heading swaps the (l, w) extents."""
    x, y = anchors_3d[:, 0], anchors_3d[:, 1]
    l, w = anchors_3d[:, 3], anchors_3d[:, 4]
    swap = np.abs(np.sin(anchors_3d[:, 6])) > 0.5
    ex = np.where(swap, w, l)
    ey = np.where(swap, l, w)
    return np.stack(
        [x - ex / 2.0, y - ey / 2.0, x + ex / 2.0, y + ey / 2.0], axis=1
    ).astype(np.float32)
