"""Host-side augmentation (numpy): the port's copy of
faster_rcnn_pytorch_multimodal_tpu/data/augment.py, every function, with
every draw from the caller's RandomState in the same order and with the same
shapes, so that a frame's augmentation is bitwise the JAX package's.  The
per-point LiDAR transforms run through the port's native library
(native/pc_ops.py, which has no numpy fallback).  Mirrors the reference's
minibatch transforms (ref lib/roi_data_layer/minibatch.py:295-425, 563-676).

LiDAR augmentations operate on RAW points (meters) + 7-DoF boxes BEFORE the
on-device voxelization; image augmentations on HWC uint8/float arrays +
x1y1x2y2 boxes.  Probabilities and formulas match the reference, including
its quirks (swap_x_y does NOT swap l/w — ref :360-377 has those lines
commented out; flips negate ry).

The reference's physics-based rain simulation (test-time sensor fault
injection, ref :397-425) is kept as a product feature.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.native import pc_ops


def rotate_points_along_z(points: np.ndarray, angle: float) -> np.ndarray:
    """(N, 3+C) points rotated by `angle` around +z (ref minibatch.py:695-713)."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], dtype=points.dtype)
    out = points.copy()
    out[:, :3] = points[:, :3] @ rot
    return out


def augment_lidar_frame(
    points: np.ndarray,
    boxes: np.ndarray,
    ignore: np.ndarray,
    cfg: Config,
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Training-time LiDAR augmentation (ref minibatch.py:295-395).

    points: (P, 3+C) meters; boxes: (G, 7) [xc,yc,zc,l,w,h,ry] meters;
    ignore: (G,) bool (set True for boxes pushed out of range).
    Returns (points, boxes, ignore) — copies, inputs untouched.
    """
    lc = cfg.lidar
    points = points.copy()
    boxes = boxes.copy()
    ignore = ignore.copy()

    flip_y = lc.en_aug_flips and rng.choice([True, False], p=[0.5, 0.5])
    flip_x = lc.en_aug_flips and rng.choice([True, False], p=[0.5, 0.5])
    gauss = lc.en_aug_gauss_distort and rng.choice([True, False], p=[0.3, 0.7])
    dropout = lc.en_aug_dropout and rng.choice([True, False], p=[0.3, 0.7])
    rotate = lc.en_aug_rotate and rng.choice([True, False], p=[0.3, 0.7])
    swap = lc.en_aug_swap_x_y and rng.choice([True, False], p=[0.3, 0.7])

    # per-point transforms run through the native library; the decision
    # draws and box math stay on the loader RNG so the stream is
    # resume-deterministic
    if gauss:  # ref :310-321
        sigmas = [rng.uniform(0.0, 0.07), rng.uniform(0.0, 0.07), rng.uniform(0.0, 0.05)]
        points = pc_ops.pc_gauss_distort(points, sigmas, int(rng.randint(1 << 31)))

    if dropout:  # ref :323-327
        p_keep = rng.uniform(0.8, 1.0)
        points = pc_ops.pc_dropout(points, float(p_keep), int(rng.randint(1 << 31)))

    if rotate:  # ref :337-352
        ang = rng.uniform(-np.pi / 2, np.pi / 2)
        points = pc_ops.pc_rotate_z(points, float(ang))
        if len(boxes):
            boxes[:, :3] = rotate_points_along_z(boxes[:, :3], ang)
            boxes[:, 6] += ang
            ignore |= ~_in_range(boxes, lc)

    if swap:  # ref :354-377 — note l/w deliberately NOT swapped
        x_mean = (lc.x_range[1] - lc.x_range[0]) / 2.0
        bx, by = boxes[:, 0].copy(), boxes[:, 1].copy()
        boxes[:, 0] = by - lc.y_range[0]
        boxes[:, 1] = bx - x_mean
        boxes[:, 6] = -boxes[:, 6] + np.pi / 2.0
        points = pc_ops.pc_swap_xy(points, float(lc.y_range[0]), float(x_mean))
        if len(boxes):
            ignore |= ~_in_range(boxes, lc)

    if flip_y:  # ref :379-388
        points = pc_ops.pc_flip_y(points)
        y_mean = (lc.y_range[0] + lc.y_range[1]) / 2.0
        boxes[:, 1] = -(boxes[:, 1] - y_mean) + y_mean
        boxes[:, 6] = -boxes[:, 6]

    if flip_x:  # ref :390-395
        points = pc_ops.pc_flip_x(points, float(lc.x_range[1]))
        x_mean = (lc.x_range[0] + lc.x_range[1]) / 2.0
        boxes[:, 0] = -(boxes[:, 0] - x_mean) + x_mean
        boxes[:, 6] = -boxes[:, 6]

    return points, boxes, ignore


def _in_range(boxes: np.ndarray, lc) -> np.ndarray:
    return (
        (boxes[:, 0] >= lc.x_range[0]) & (boxes[:, 0] < lc.x_range[1])
        & (boxes[:, 1] >= lc.y_range[0]) & (boxes[:, 1] < lc.y_range[1])
        & (boxes[:, 2] >= lc.z_range[0]) & (boxes[:, 2] < lc.z_range[1])
    )


def rain_sim(
    points: np.ndarray,
    rain_rate: float,
    lidar_max_range: float,
    rng: np.random.RandomState,
) -> np.ndarray:
    """Test-time physics-based rain attenuation (ref minibatch.py:397-421):
    gaussian range noise growing with distance, intensity attenuation
    exp(-2*alpha*R^beta*z), and removal of returns whose received power
    falls below the max-range noise floor."""
    points = points.copy()
    z = np.sqrt(np.sum(points[:, 0:3] ** 2, axis=1))
    rho = 0.9 / np.pi
    big_r = rain_rate**0.6
    p_min = rho / (np.pi * lidar_max_range**2)
    sigma = 0.02 * z * (1 - np.exp(-rain_rate)) ** 2
    shift = rng.normal(np.zeros_like(sigma), sigma)
    z = z + shift
    points[:, 0:3] += np.repeat(shift[:, None], 3, axis=1) / 3.0
    delta = np.exp(-2 * 0.01 * big_r * z)
    p_n = (rho / (z * z + np.finfo(np.float64).eps)) * delta
    points[:, 3] = points[:, 3] * delta
    return points[p_n >= p_min]


def test_dropout(points: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Test-time fixed 20% point dropout (ref minibatch.py:422-425)."""
    return points[0.8 > rng.rand(len(points))]


def flip_boxes_h(boxes: np.ndarray, w: int) -> np.ndarray:
    """x1y1x2y2 boxes mirrored about the vertical axis of a width-w image."""
    out = boxes.copy()
    if len(out):
        out[:, 0] = w - 1 - boxes[:, 2]
        out[:, 2] = w - 1 - boxes[:, 0]
    return out


def flip_image_boxes(
    image: np.ndarray, boxes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip (ref minibatch.py USE_FLIPPED path)."""
    return image[:, ::-1].copy(), flip_boxes_h(boxes, image.shape[1])


def photometric_distort(
    image: np.ndarray, rng: np.random.RandomState
) -> np.ndarray:
    """Photometric jitter (brightness/contrast/per-channel gain/noise);
    kept as a cheap standalone in addition to the full pipeline below."""
    img = image.astype(np.float32)
    if rng.rand() < 0.5:
        img = img + rng.uniform(-16, 16)
    if rng.rand() < 0.5:
        img = (img - img.mean()) * rng.uniform(0.8, 1.2) + img.mean()
    if rng.rand() < 0.3:
        img = img * rng.uniform(0.9, 1.1, size=(1, 1, img.shape[2]))
    if rng.rand() < 0.3:
        img = img + rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255)


# ---------------------------------------------------------------------------
# Full image augmentation pipeline (parity with the reference's imgaug
# Sequential, ref minibatch.py:563-597) — numpy/cv2, no imgaug dependency.
# ---------------------------------------------------------------------------


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    import cv2

    k = max(3, int(2 * round(3 * sigma) + 1))
    return cv2.GaussianBlur(img, (k, k), sigma)


def _photometric_stage(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """SomeOf((0,2)) of [one-of-blurs/sharpen, per-channel gaussian noise,
    hue+saturation shift] in random order (ref minibatch.py:565-578)."""
    import cv2

    ops = []

    def blur_or_sharpen(x):
        choice = rng.randint(4)
        if choice == 0:  # GaussianBlur sigma (0.5, 2.5)
            return _gaussian_blur(x, rng.uniform(0.5, 2.5))
        if choice == 1:  # AverageBlur k (1, 3)
            k = rng.randint(1, 4)
            return cv2.blur(x, (k, k)) if k > 1 else x
        if choice == 2:  # MedianBlur k (1, 3) — odd kernels only
            k = rng.choice([1, 3])
            return (
                cv2.medianBlur(np.clip(x, 0, 255).astype(np.uint8), int(k)).astype(
                    np.float32
                )
                if k > 1
                else x
            )
        # Sharpen alpha (0, 1), lightness (0.75, 1.5)
        alpha = rng.uniform(0.0, 1.0)
        light = rng.uniform(0.75, 1.5)
        blurred = _gaussian_blur(x, 1.0)
        sharp = x + (x - blurred) * light
        return (1 - alpha) * x + alpha * sharp

    def noise(x):
        scale = rng.uniform(0.0, 0.1 * 255)
        return x + rng.normal(0, scale, x.shape).astype(np.float32)

    def hue_sat(x):
        # AddToHueAndSaturation((-5, 5)) — shift H and S in HSV space
        hsv = cv2.cvtColor(
            np.clip(x, 0, 255).astype(np.uint8), cv2.COLOR_BGR2HSV
        ).astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + rng.randint(-5, 6)) % 180
        hsv[..., 1] = np.clip(hsv[..., 1] + rng.randint(-5, 6), 0, 255)
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR).astype(
            np.float32
        )

    ops = [blur_or_sharpen, noise, hue_sat]
    n_apply = rng.randint(0, 3)  # SomeOf((0, 2))
    for idx in rng.permutation(3)[:n_apply]:
        img = ops[int(idx)](img)
    return img


def _affine_params(rng: np.random.RandomState):
    """Sometimes(0.3) affine with the reference's ranges
    (ref minibatch.py:579-586)."""
    if rng.rand() >= 0.3:
        return None
    return {
        "scale": (rng.uniform(0.9, 1.2), rng.uniform(0.9, 1.2)),
        "translate": (rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05)),
        "shear": rng.uniform(-0.05, 0.05),
        "cval": rng.uniform(0, 255),
    }


def _affine_matrix(p, w: int, h: int) -> np.ndarray:
    """2x3 matrix about the image center (imgaug Affine convention)."""
    sx, sy = p["scale"]
    shear = np.deg2rad(p["shear"])  # imgaug shear is degrees; range ±0.05deg
    tx, ty = p["translate"][0] * w, p["translate"][1] * h
    cx, cy = w / 2.0, h / 2.0
    # translate(-c) -> scale/shear -> translate(c + t)
    m = np.array(
        [[sx, -np.sin(shear) * sx, 0.0], [0.0, sy * np.cos(shear), 0.0]],
        np.float32,
    )
    m[:, 2] = [cx + tx - m[0, 0] * cx - m[0, 1] * cy, cy + ty - m[1, 0] * cx - m[1, 1] * cy]
    return m


def _transform_boxes_affine(boxes: np.ndarray, m: np.ndarray) -> np.ndarray:
    """x1y1x2y2 boxes -> transform 4 corners -> enclosing AABB (imgaug
    bounding-box semantics)."""
    if not len(boxes):
        return boxes
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack(
        [
            np.stack([x1, y1], -1),
            np.stack([x2, y1], -1),
            np.stack([x2, y2], -1),
            np.stack([x1, y2], -1),
        ],
        axis=1,
    )  # (G, 4, 2)
    ones = np.ones(corners.shape[:2] + (1,), np.float32)
    pts = np.concatenate([corners, ones], axis=-1) @ m.T  # (G, 4, 2)
    out = boxes.copy()
    out[:, 0] = pts[..., 0].min(axis=1)
    out[:, 1] = pts[..., 1].min(axis=1)
    out[:, 2] = pts[..., 0].max(axis=1)
    out[:, 3] = pts[..., 1].max(axis=1)
    return out


def image_augment_pipeline(
    img: np.ndarray,
    boxes: np.ndarray,
    boxes_dc: np.ndarray,
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's train-time imgaug Sequential (ref minibatch.py:
    563-597): photometric SomeOf stage, Sometimes(0.3) affine (boxes move
    with the image), Sometimes(0.25) pixel dropout."""
    import cv2

    img = _photometric_stage(img.astype(np.float32), rng)

    p = _affine_params(rng)
    if p is not None:
        h, w = img.shape[:2]
        m = _affine_matrix(p, w, h)
        order = int(rng.choice([0, 1]))  # nearest | bilinear
        img = cv2.warpAffine(
            img,
            m,
            (w, h),
            flags=cv2.INTER_NEAREST if order == 0 else cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT,
            borderValue=(p["cval"],) * 3,
        )
        boxes = _transform_boxes_affine(boxes, m)
        boxes_dc = _transform_boxes_affine(boxes_dc, m)

    if rng.rand() < 0.25:  # iaa.Dropout((0.01, 0.05), per_channel=0.5)
        rate = rng.uniform(0.01, 0.05)
        if rng.rand() < 0.5:
            mask = rng.rand(*img.shape) >= rate
        else:
            mask = (rng.rand(*img.shape[:2]) >= rate)[..., None]
        img = img * mask

    return np.clip(img, 0, 255), boxes, boxes_dc


def clip_and_ignore_boxes(
    boxes: np.ndarray, ignore: np.ndarray, w: int, h: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Post-augmentation box re-clip + ignore rules (ref minibatch.py:
    614-646): clip to the frame; ignore boxes whose clipped height/width
    drops below 2 px or below 10% of the pre-clip size."""
    boxes = boxes.copy()
    ignore = ignore.copy()
    if not len(boxes):
        return boxes, ignore
    h0 = boxes[:, 3] - boxes[:, 1]
    w0 = boxes[:, 2] - boxes[:, 0]
    boxes[:, 0] = np.clip(boxes[:, 0], 0, w - 1)
    boxes[:, 2] = np.clip(boxes[:, 2], 0, w - 1)
    boxes[:, 1] = np.clip(boxes[:, 1], 0, h - 1)
    boxes[:, 3] = np.clip(boxes[:, 3], 0, h - 1)
    hc = boxes[:, 3] - boxes[:, 1]
    wc = boxes[:, 2] - boxes[:, 0]
    ignore |= hc < 2
    ignore |= wc < 2
    ignore |= (h0 != 0) & (hc / np.where(h0 == 0, 1, h0) < 0.1)
    ignore |= (w0 != 0) & (wc / np.where(w0 == 0, 1, w0) < 0.1)
    return boxes, ignore


def weather_corrupt(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Test-time image weather corruption (ref minibatch.py:648-664 applies
    imgcorruptlike.Spatter severity 5).  Approximated without the
    imagecorruptions dependency: a blurred random field thresholded into
    mud-colored splotches composited over the frame."""
    import cv2

    h, w = img.shape[:2]
    field = rng.rand(h, w).astype(np.float32)
    field = cv2.GaussianBlur(field, (0, 0), max(h, w) / 100.0)
    lo, hi = np.percentile(field, [78, 90])
    splat = np.clip((field - lo) / max(hi - lo, 1e-6), 0, 1)[..., None]
    mud = np.asarray([63.0, 86.0, 112.0], np.float32)  # BGR mud tone
    out = img.astype(np.float32) * (1 - 0.8 * splat) + mud * (0.8 * splat)
    return np.clip(out, 0, 255)


def get_fov_flag(pts_rect: np.ndarray, img_size, calib=None) -> np.ndarray:
    """Keep points projecting inside the camera image
    (ref minibatch.py:678-693).  img_size = (H, W)."""
    if calib is not None:
        pts_img, pts_depth = calib.rect_to_img(pts_rect)
        flag = (
            (pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_size[1])
            & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_size[0])
        )
        return flag & (pts_depth >= 0)
    return pts_rect[:, 2] >= 0
