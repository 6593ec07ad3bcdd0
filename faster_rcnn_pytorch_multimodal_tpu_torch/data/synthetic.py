"""Synthetic dataset for smoke tests, benchmarks, and CI (the port's copy).

A copy of faster_rcnn_pytorch_multimodal_tpu/data/synthetic.py:1-212
(numpy only), so that the same (seed, index) gives the same frames as the
JAX package's:
  * image mode: noisy background + axis-aligned class-colored rectangles,
  * lidar mode: ground-plane point cloud + dense point boxes (vehicles),
    returned as RAW points for the on-device voxelizer.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config

# distinct per-class mean colors (class 0 = background, not drawn)
_CLASS_COLORS = np.array(
    [
        [0, 0, 0],
        [200, 60, 60],
        [60, 200, 60],
        [60, 60, 200],
        [200, 200, 60],
    ],
    dtype=np.float32,
)


class SyntheticDataset:
    """Frames addressable by index; deterministic per (seed, index)."""

    def __init__(
        self,
        cfg: Config,
        num_frames: int = 64,
        num_classes: int = 2,
        seed: int = 0,
        image_hw=(256, 384),
        max_objects: int = 6,
        mode: str = "train",
    ):
        self.cfg = cfg
        self.num_frames = num_frames
        self.num_classes = num_classes
        self.seed = seed
        self.image_hw = image_hw
        self.max_objects = max_objects
        self.mode = mode
        self.name = f"synthetic_{cfg.net_type}_{mode}"
        self.classes = ["__background__"] + [f"class_{i}" for i in range(1, num_classes)]
        # base frames are pure functions of (seed, index): memoize them so
        # repeated epochs pay only the augmentation cost, the way a real
        # dataset pays decode once per page-cached read.  The e2e bench
        # measures the FRAMEWORK pipeline (augment+collate+upload), not
        # procedural noise generation.
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self) -> int:
        return self.num_frames

    def frame(
        self, index: int, augment: bool = False, rng=None, scale=None
    ) -> Dict[str, np.ndarray]:
        # augmentation draws from the LOADER-passed rng (resume-
        # deterministic); the base frame is a pure function of (seed, index)
        if rng is None:
            rng = np.random.RandomState(self.seed * 99991 + index)
        if self.cfg.net_type == "lidar":
            return self._lidar_frame(index, augment, rng)
        return self._image_frame(index, augment, rng, scale)

    # -- image ---------------------------------------------------------

    def _image_base(self, index: int) -> Dict[str, np.ndarray]:
        if index in self._cache:
            return self._cache[index]
        rng = np.random.RandomState(self.seed * 100003 + index)
        h, w = self.image_hw
        img = rng.uniform(60, 120, (h, w, 3)).astype(np.float32)
        n_obj = rng.randint(1, self.max_objects + 1)
        boxes = []
        for _ in range(n_obj):
            bw = rng.uniform(30, w // 3)
            bh = rng.uniform(30, h // 3)
            x1 = rng.uniform(0, w - bw - 1)
            y1 = rng.uniform(0, h - bh - 1)
            cls = rng.randint(1, self.num_classes)
            color = _CLASS_COLORS[cls % len(_CLASS_COLORS)]
            img[int(y1) : int(y1 + bh), int(x1) : int(x1 + bw)] = color + rng.normal(
                0, 8, 3
            )
            boxes.append([x1, y1, x1 + bw, y1 + bh, cls])
        base = {
            "img": np.clip(img, 0, 255).astype(np.uint8),
            "gt": np.asarray(boxes, np.float32),
        }
        if len(self._cache) < 512:
            self._cache[index] = base
        return base

    def _image_frame(
        self, index: int, augment: bool, rng, scale=None
    ) -> Dict[str, np.ndarray]:
        base = self._image_base(index)
        img, gt = base["img"], base["gt"].copy()
        h, w = img.shape[:2]
        if augment and rng.rand() < 0.5:  # horizontal flip (ref USE_FLIPPED)
            img = img[:, ::-1]
            x1 = gt[:, 0].copy()
            gt[:, 0] = w - 1 - gt[:, 2]
            gt[:, 2] = w - 1 - x1
        if scale is not None and float(scale) != 1.0:
            # multi-scale minibatches (loader-sampled TRAIN.SCALES entry)
            import cv2

            img = cv2.resize(
                img, None, fx=float(scale), fy=float(scale),
                interpolation=cv2.INTER_LINEAR,
            )
            gt[:, :4] *= float(scale)
            h, w = img.shape[:2]
        # raw uint8 out; the device normalizes (prep_im_for_blob,
        # ref blob.py:32-54)
        return {
            "data": np.ascontiguousarray(img),
            "gt_boxes": gt,
            "window": np.array([0, w, 0, h], np.float32),
            "filename": f"synthetic_{index:06d}",
        }

    # -- lidar ------------------------------------------------------------

    def _lidar_base(self, index: int) -> Dict[str, np.ndarray]:
        if index in self._cache:
            return self._cache[index]
        cfg = self.cfg
        rng = np.random.RandomState(self.seed * 100003 + index)
        xr, yr, zr = cfg.lidar.x_range, cfg.lidar.y_range, cfg.lidar.z_range

        n_ground = 6000
        gx = rng.uniform(xr[0], xr[1], n_ground)
        gy = rng.uniform(yr[0], yr[1], n_ground)
        gz = rng.normal(zr[0] + 0.15, 0.05, n_ground)
        pts = [np.stack([gx, gy, gz], 1)]

        n_obj = rng.randint(1, self.max_objects + 1)
        boxes = []
        for _ in range(n_obj):
            l, wdt, hgt = 4.5 + rng.uniform(-0.5, 0.5), 2.0 + rng.uniform(-0.2, 0.2), 1.7
            cx = rng.uniform(xr[0] + l, xr[1] - l)
            cy = rng.uniform(yr[0] + l, yr[1] - l)
            cz = zr[0] + hgt / 2.0
            ry = rng.choice([0.0, math.pi / 2]) + rng.uniform(-0.15, 0.15)
            n_pts = 400
            px = rng.uniform(-l / 2, l / 2, n_pts)
            py = rng.uniform(-wdt / 2, wdt / 2, n_pts)
            pz = rng.uniform(-hgt / 2, hgt / 2, n_pts)
            c, s = math.cos(ry), math.sin(ry)
            rx = px * c - py * s + cx
            ryy = px * s + py * c + cy
            pts.append(np.stack([rx, ryy, pz + cz], 1))
            boxes.append([cx, cy, cz, l, wdt, hgt, ry, 1])
        xyz = np.concatenate(pts, 0).astype(np.float32)
        feats = np.stack(
            [rng.uniform(0, 1, len(xyz)), rng.uniform(0, 0.3, len(xyz))], 1
        ).astype(np.float32)
        base = {
            "points": np.concatenate([xyz, feats], 1),
            "gt": np.asarray(boxes, np.float32),
        }
        if len(self._cache) < 512:
            self._cache[index] = base
        return base

    def _lidar_frame(self, index: int, augment: bool, rng) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        xr, yr, zr = cfg.lidar.x_range, cfg.lidar.y_range, cfg.lidar.z_range
        base = self._lidar_base(index)
        points, gt = base["points"].copy(), base["gt"].copy()

        if augment and rng.rand() < 0.5 and cfg.lidar.en_aug_flips:
            points[:, 1] *= -1.0
            gt[:, 1] *= -1.0
            gt[:, 6] *= -1.0

        # GT to voxel-grid space (ref bbox_pc_to_voxel_grid, bbox.py:113-138)
        scale = float(cfg.train.scales[0] if self.mode == "train" else cfg.test.scales[0])
        voxel_len = cfg.lidar.voxel_len / scale
        num_x = int((xr[1] - xr[0]) / voxel_len)
        num_y = int((yr[1] - yr[0]) / voxel_len)
        gt_vg = gt.copy()
        gt_vg[:, 0] = (gt[:, 0] - xr[0]) * (num_x / (xr[1] - xr[0]))
        gt_vg[:, 1] = (gt[:, 1] - yr[0]) * (num_y / (yr[1] - yr[0]))
        gt_vg[:, 2] = gt[:, 2] - zr[0]
        gt_vg[:, 3] = gt[:, 3] * (num_x / (xr[1] - xr[0]))
        gt_vg[:, 4] = gt[:, 4] * (num_y / (yr[1] - yr[0]))

        num_z = cfg.lidar.num_slices
        return {
            "points": points,
            "gt_boxes": gt_vg,
            "window": np.array([0, num_x, 0, num_y], np.float32),
            "info": np.array(
                [0, num_x, 0, num_y, 0, num_z, scale], np.float32
            ),
            "filename": f"synthetic_{index:06d}",
        }
