"""Detection drawing (image and BEV) with uncertainty-sorted colours.

A copy of faster_rcnn_pytorch_multimodal_tpu/utils/visualization.py: the
GT overlay, image and BEV detection boxes coloured by the min-max
normalized uncertainty named by UC.SORT_TYPE (green certain, red
uncertain), the BEV raster as RGB, and `save_image`.  PIL is imported at
the call, so the module imports without it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

_CLASS_COLORS = [
    (255, 255, 255),
    (230, 70, 60),
    (80, 200, 90),
    (70, 120, 230),
    (230, 200, 60),
    (180, 90, 210),
]


def _font():
    from PIL import ImageFont

    try:
        return ImageFont.load_default()
    except Exception:
        return None


def draw_bounding_boxes(
    image: np.ndarray,
    gt_boxes: np.ndarray,
    classes: Optional[List[str]] = None,
) -> np.ndarray:
    """GT overlay (ref lib/utils/visualization.py:71-89).

    image: (H, W, 3) uint8/float RGB; gt_boxes: (N, 5) [x1,y1,x2,y2,cls].
    """
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.clip(image, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for box in np.atleast_2d(gt_boxes):
        if len(box) < 5:
            continue
        cls = int(box[4])
        color = _CLASS_COLORS[cls % len(_CLASS_COLORS)]
        draw.rectangle([box[0], box[1], box[2], box[3]], outline=color, width=2)
        label = classes[cls] if classes and cls < len(classes) else str(cls)
        draw.text((box[0] + 2, box[1] + 2), label, fill=color, font=_font())
    return np.asarray(img)


def normalize_uncertainty(values: np.ndarray) -> np.ndarray:
    """Min-max normalize for color mapping (ref db.py:260-303)."""
    v = np.asarray(values, np.float64).ravel()
    if len(v) == 0:
        return v
    lo, hi = v.min(), v.max()
    return (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)


def _uc_scalar(uc_row: Dict[str, np.ndarray], sort_key: str) -> float:
    u = uc_row.get(sort_key)
    if u is None:
        return 0.0
    return float(np.mean(u))


# matplotlib tab10 cycle (ref tools/demo_all_bboxes.py per-class colors)
TAB10 = (
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207),
)


def draw_detections_image(
    image: np.ndarray,
    dets: np.ndarray,
    uncertainties: Optional[List[Dict]] = None,
    sort_key: str = "",
    class_name: str = "det",
    color: Optional[tuple] = None,
) -> np.ndarray:
    """Detections (N, 5) [x1,y1,x2,y2,score] on an RGB image; when a
    sort_key is given the box color encodes the normalized uncertainty
    (green=certain -> red=uncertain, ref db.py uncertainty-sorted draw).
    A fixed `color` overrides both (per-class color cycles)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(np.clip(image, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    dets = np.atleast_2d(dets)
    if not dets.size:
        return np.asarray(img)
    if sort_key and uncertainties:
        uc = normalize_uncertainty(
            np.array([_uc_scalar(u, sort_key) for u in uncertainties])
        )
    else:
        uc = np.zeros(len(dets))
    for row, u in zip(dets, uc):
        c = color or (int(255 * u), int(255 * (1 - u)), 40)
        draw.rectangle([row[0], row[1], row[2], row[3]], outline=c, width=2)
        draw.text(
            (row[0] + 2, max(row[1] - 10, 0)),
            f"{class_name} {row[4]:.2f}",
            fill=c,
            font=_font(),
        )
    return np.asarray(img)


def bev_to_rgb(bev: np.ndarray) -> np.ndarray:
    """BEV raster -> displayable RGB: max height over slices = R,
    intensity = G, density = B (ref README draw modes / db.py:369-403)."""
    s = bev.shape[2] - 3
    height = bev[:, :, :s].max(axis=2)
    density = bev[:, :, s]
    intensity = bev[:, :, s + 1]
    out = np.stack(
        [
            normalize_uncertainty(height).reshape(height.shape),
            np.clip(intensity, 0, 1),
            np.clip(density, 0, 1),
        ],
        axis=2,
    )
    return (out * 255).astype(np.uint8)


def draw_detections_bev(
    bev: np.ndarray,
    dets7: np.ndarray,
    gt7: Optional[np.ndarray] = None,
    uncertainties: Optional[List[Dict]] = None,
    sort_key: str = "",
) -> np.ndarray:
    """Rotated detection boxes on the BEV raster (voxel-grid coords).

    dets7: (N, 8) [xc,yc,zc,l,w,h,ry,score]; gt7 optional (G, 7+)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(bev_to_rgb(bev))
    draw = ImageDraw.Draw(img)

    def corners(b):
        c, s = np.cos(b[6]), np.sin(b[6])
        dx = np.array([b[3], b[3], -b[3], -b[3]]) / 2
        dy = np.array([b[4], -b[4], -b[4], b[4]]) / 2
        # raster is (y, x): draw (x, y) pixel coords as (col=x, row=y)
        xs = dx * c - dy * s + b[0]
        ys = dx * s + dy * c + b[1]
        return list(zip(xs.tolist(), ys.tolist()))

    if gt7 is not None:
        for g in np.atleast_2d(gt7):
            if len(g) >= 7:
                draw.polygon(corners(g), outline=(255, 255, 255))
    dets7 = np.atleast_2d(dets7)
    if dets7.size:
        if sort_key and uncertainties:
            uc = normalize_uncertainty(
                np.array([_uc_scalar(u, sort_key) for u in uncertainties])
            )
        else:
            uc = np.zeros(len(dets7))
        for row, u in zip(dets7, uc):
            color = (int(255 * u), int(255 * (1 - u)), 40)
            draw.polygon(corners(row), outline=color)
    return np.asarray(img)


def save_image(image: np.ndarray, path: str):
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(np.clip(image, 0, 255).astype(np.uint8)).save(path)
