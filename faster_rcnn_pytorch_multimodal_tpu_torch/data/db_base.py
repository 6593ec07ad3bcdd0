"""Dataset base class: the port's copy of
faster_rcnn_pytorch_multimodal_tpu/data/db_base.py (re-design of ref
lib/datasets/db.py:23-452), numpy only.  Its frames feed the same
BatchLoader as SyntheticDataset's.

Provides: roidb lazy-load + pickle caching, train/val index handling, the
loader-facing `frame(i, augment)` protocol (raw points or image + GT in the
spaces the model expects), results-file writers (image 5-col / lidar 8-col
with trailing uncertainty columns, ref db.py:305-367), and
evaluate_detections dispatch.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.data import augment as aug

# canonical uncertainty keys + column order in det files (the 8-key
# contract of ref filter_predictions.py:113-124 / test.py stack_uncertainties
# insertion order); widths per key live in evaluation.eval_utils.uc_widths
UC_KEYS = (
    "a_entropy",
    "a_mutual_info",
    "a_cls_var",
    "a_bbox_var",
    "e_entropy",
    "e_mutual_info",
    "e_cls_var",
    "e_bbox_var",
)


def _bev_aabb_of_7dof(boxes7: np.ndarray) -> np.ndarray:
    """Graphics-Gems AABB of rotated BEV rectangles (numpy twin of
    ops.iou.bbox_3d_to_bev_aabb; ref lib/utils/bbox.py:256-336)."""
    if not len(boxes7):
        return np.zeros((0, 4), np.float32)
    x, y = boxes7[:, 0], boxes7[:, 1]
    l, w = boxes7[:, 3], boxes7[:, 4]
    ry = boxes7[:, 6]
    c, s = np.abs(np.cos(ry)), np.abs(np.sin(ry))
    ex = (l * c + w * s) / 2.0
    ey = (l * s + w * c) / 2.0
    return np.stack([x - ex, y - ey, x + ex, y + ey], axis=-1)


class DetectionDB:
    """Base for real datasets.  Subclasses set `_classes`, implement
    `_build_roidb(mode)` and `_load_frame_data(entry)`."""

    type = "lidar"  # or 'image'

    def __init__(self, name: str, cfg: Config, mode: str):
        self.name = f"{name}_{cfg.net_type}_{mode}"
        self._db_name = name
        self.cfg = cfg
        self.mode = mode
        self._roidb: Optional[List[Dict]] = None
        self._rng = np.random.RandomState(cfg.rng_seed)

    # -- identity -------------------------------------------------------

    @property
    def classes(self):
        return self._classes

    @property
    def num_classes(self) -> int:
        return len(self._classes)

    def __len__(self) -> int:
        return len(self.roidb)

    # -- roidb cache (ref db.py:62-83, waymo_lidb.py:116-159) ---------------

    def _cache_dir(self) -> str:
        d = self.cfg.cache_dir or os.path.join(self.cfg.data_dir, "cache")
        os.makedirs(d, exist_ok=True)
        return d

    @property
    def roidb(self) -> List[Dict]:
        if self._roidb is None:
            cache = os.path.join(
                self._cache_dir(),
                f"{self._db_name}_{self.mode}_{self.cfg.net_type}_gt_roidb.pkl",
            )
            if os.path.exists(cache):
                with open(cache, "rb") as f:
                    self._roidb = pickle.load(f)
                print(f"{self._db_name} gt roidb loaded from {cache}")
            else:
                self._roidb = self._build_roidb(self.mode)
                with open(cache, "wb") as f:
                    pickle.dump(self._roidb, f, pickle.HIGHEST_PROTOCOL)
                print(f"wrote gt roidb to {cache}")
        return self._roidb

    # -- loader protocol --------------------------------------------------

    def frame(
        self, index: int, augment: bool = False, rng=None, scale=None
    ) -> Dict[str, np.ndarray]:
        """rng: optional per-call RandomState.  The BatchLoader passes one
        seeded from ITS (checkpointed) RNG so the augmentation stream is
        resume-deterministic and frames can be assembled in parallel;
        direct callers fall back to the dataset RNG.

        scale: optional frame-scale override for random multi-scale
        training (ref minibatch.py:113-120 samples one of cfg.TRAIN.SCALES
        per minibatch); None keeps the phase's scales[0]."""
        entry = self.roidb[index]
        rng = self._rng if rng is None else rng
        if self.cfg.net_type == "lidar":
            return self._lidar_frame(entry, augment, rng)
        return self._image_frame(entry, augment, rng, scale)

    def _lidar_frame(self, entry: Dict, augment: bool, rng) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        points = self._load_frame_data(entry)  # (P, >=4) meters
        if points.shape[1] == 4:  # pad elongation channel (non-Waymo)
            points = np.hstack([points, np.zeros((len(points), 1), np.float32)])
        boxes = entry["boxes"].astype(np.float32).copy()  # (G, 7) meters
        classes = entry["gt_classes"].astype(np.float32)
        ignore = entry.get("ignore", np.zeros(len(boxes), bool)).copy()
        boxes_dc = (
            entry.get("boxes_dc", np.zeros((0, 7), np.float32))
            .astype(np.float32)
            .reshape(-1, 7)
            .copy()
        )

        if augment:
            # don't-care boxes ride the same geometric transforms as GT
            n_gt = len(boxes)
            stacked = np.vstack([boxes, boxes_dc])
            stacked_ig = np.concatenate(
                [ignore, np.zeros(len(boxes_dc), bool)]
            )
            points, stacked, stacked_ig = aug.augment_lidar_frame(
                points, stacked, stacked_ig, cfg, rng
            )
            boxes, boxes_dc = stacked[:n_gt], stacked[n_gt:]
            ignore = stacked_ig[:n_gt]
            boxes_dc = boxes_dc[~stacked_ig[n_gt:]]
        if self.mode == "test" or self.mode == "val":
            # sensor fault injection runs through the native library
            # (seeded from the frame's RNG)
            from faster_rcnn_pytorch_multimodal_tpu_torch.native import pc_ops

            if cfg.test.rain_sim_en:
                points = pc_ops.pc_rain_sim(
                    points,
                    float(cfg.test.rain_rate),
                    float(self._lidar_max_range()),
                    int(rng.randint(1 << 31)),
                )
            if cfg.test.dropout_en:
                points = pc_ops.pc_dropout(
                    points, 0.8, int(rng.randint(1 << 31))
                )

        keep = ~ignore[: len(boxes)]
        boxes, classes = boxes[keep], classes[keep]

        scale = float(
            cfg.train.scales[0] if self.mode == "train" else cfg.test.scales[0]
        )
        gt_vg = self._boxes_pc_to_voxel_grid(boxes, scale)
        gt = np.hstack([gt_vg, classes[:, None]]).astype(np.float32)
        # dc boxes feed proposal_target's dc suppression as BEV AABBs
        # (ref proposal_target_layer.py:184-194 uses 4-col overlaps)
        dc_vg = self._boxes_pc_to_voxel_grid(boxes_dc, scale)
        gt_dc = _bev_aabb_of_7dof(dc_vg)

        voxel_len = cfg.lidar.voxel_len / scale
        num_x = int((cfg.lidar.x_range[1] - cfg.lidar.x_range[0]) / voxel_len)
        num_y = int((cfg.lidar.y_range[1] - cfg.lidar.y_range[0]) / voxel_len)
        return {
            "points": points.astype(np.float32),
            "gt_boxes": gt,
            "gt_boxes_dc": gt_dc.astype(np.float32),
            "window": np.array([0, num_x, 0, num_y], np.float32),
            "info": np.array(
                [0, num_x, 0, num_y, 0, cfg.lidar.num_slices, scale], np.float32
            ),
            "filename": entry["filename"],
        }

    def _boxes_pc_to_voxel_grid(self, boxes: np.ndarray, scale: float) -> np.ndarray:
        """ref lib/utils/bbox.py:113-138 (bbox_pc_to_voxel_grid)."""
        cfg = self.cfg
        xr, yr, zr = cfg.lidar.x_range, cfg.lidar.y_range, cfg.lidar.z_range
        voxel_len = cfg.lidar.voxel_len / scale
        sx = 1.0 / voxel_len
        out = boxes.copy()
        if len(out):
            out[:, 0] = (boxes[:, 0] - xr[0]) * sx
            out[:, 1] = (boxes[:, 1] - yr[0]) * sx
            out[:, 2] = boxes[:, 2] - zr[0]
            out[:, 3] = boxes[:, 3] * sx
            out[:, 4] = boxes[:, 4] * sx
        return out

    def boxes_voxel_grid_to_pc(
        self, boxes: np.ndarray, scale: float, aabb: bool = False
    ) -> np.ndarray:
        """Inverse (ref bbox.py:140-162) for writing detections in meters."""
        cfg = self.cfg
        xr, yr, zr = cfg.lidar.x_range, cfg.lidar.y_range, cfg.lidar.z_range
        voxel_len = cfg.lidar.voxel_len / scale
        out = boxes.copy()
        if not len(out):
            return out
        if aabb:
            out[:, 0] = boxes[:, 0] * voxel_len + xr[0]
            out[:, 1] = boxes[:, 1] * voxel_len + yr[0]
            out[:, 2] = boxes[:, 2] * voxel_len + xr[0]
            out[:, 3] = boxes[:, 3] * voxel_len + yr[0]
        else:
            out[:, 0] = boxes[:, 0] * voxel_len + xr[0]
            out[:, 1] = boxes[:, 1] * voxel_len + yr[0]
            out[:, 2] = boxes[:, 2] + zr[0]
            out[:, 3] = boxes[:, 3] * voxel_len
            out[:, 4] = boxes[:, 4] * voxel_len
        return out

    def _image_frame(
        self, entry: Dict, augment: bool, rng, scale=None
    ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        img = self._load_frame_data(entry).astype(np.float32)  # (H, W, 3) BGR
        boxes = entry["boxes"].astype(np.float32).copy()  # (G, 4) x1y1x2y2
        classes = entry["gt_classes"].astype(np.float32)
        ignore = entry.get("ignore", np.zeros(len(boxes), bool)).copy()
        boxes_dc = (
            entry.get("boxes_dc", np.zeros((0, 4), np.float32))
            .astype(np.float32)
            .reshape(-1, 4)
            .copy()
        )

        if augment:
            if cfg.train.use_flipped and rng.rand() < 0.5:
                img, boxes = aug.flip_image_boxes(img, boxes)
                boxes_dc = aug.flip_boxes_h(boxes_dc, img.shape[1])
            img, boxes, boxes_dc = aug.image_augment_pipeline(
                img, boxes, boxes_dc, rng
            )
            # post-augmentation re-clip + ignore rules (ref minibatch.py:
            # 614-646): affines can push boxes out of frame
            h0, w0 = img.shape[:2]
            boxes, ignore = aug.clip_and_ignore_boxes(boxes, ignore, w0, h0)
            boxes_dc, dc_ig = aug.clip_and_ignore_boxes(
                boxes_dc, np.zeros(len(boxes_dc), bool), w0, h0
            )
            boxes_dc = boxes_dc[~dc_ig]
        elif self.mode in ("test", "val") and cfg.test.augment_en:
            # test-time weather corruption (ref minibatch.py:648-664)
            img = aug.weather_corrupt(img, rng)

        keep = ~ignore
        boxes, classes = boxes[keep], classes[keep]

        if scale is None:
            scale = cfg.train.scales[0] if self.mode == "train" else cfg.test.scales[0]
        scale = float(scale)
        if scale != 1.0:
            import cv2

            img = cv2.resize(
                img, None, fx=scale, fy=scale, interpolation=cv2.INTER_LINEAR
            )
            boxes = boxes * scale
            boxes_dc = boxes_dc * scale

        # ship RAW uint8: normalization runs on device (detector.features)
        # — a 4x smaller host->device transfer per batch, and faithful to
        # the reference whose imgaug pipeline operates on uint8 frames
        img = np.clip(img, 0, 255).astype(np.uint8)
        h, w = img.shape[:2]
        gt = np.hstack([boxes, classes[:, None]]).astype(np.float32)
        return {
            "data": img,
            "gt_boxes": gt,
            "gt_boxes_dc": boxes_dc.astype(np.float32),
            "window": np.array([0, w, 0, h], np.float32),
            "filename": entry["filename"],
        }

    # -- results writing (ref db.py:305-367) --------------------------------

    def write_image_results(self, all_boxes, frame_ids, out_dir: str, uncertainties=None):
        """Per-class text files: frame_id score x1 y1 x2 y2 [uc columns]
        (ref db.py:305-334; trailing uncertainty columns in UC_KEYS order)."""
        os.makedirs(out_dir, exist_ok=True)
        for j in range(1, self.num_classes):
            path = os.path.join(out_dir, f"det_{self.mode}_{self.classes[j]}.txt")
            with open(path, "w") as f:
                for i, fid in enumerate(frame_ids):
                    rows = all_boxes[j][i]
                    if not len(rows):
                        continue
                    for r_idx, row in enumerate(np.atleast_2d(rows)):
                        line = (
                            f"{fid} {row[4]:.6f} {row[0]:.2f} {row[1]:.2f} "
                            f"{row[2]:.2f} {row[3]:.2f}"
                        )
                        line += self._uc_columns(uncertainties, j, i, r_idx)
                        f.write(line + "\n")

    def _uc_columns(self, uncertainties, j: int, i: int, r_idx: int) -> str:
        """Trailing uncertainty columns for one det row (UC_KEYS order)."""
        if uncertainties is None or not len(uncertainties[j]) or not uncertainties[j][i]:
            return ""
        out = ""
        for key in UC_KEYS:
            u = uncertainties[j][i].get(key)
            if u is not None:
                out += " " + " ".join(
                    f"{v:.10f}" for v in np.atleast_1d(u[r_idx]).ravel()
                )
        return out

    def write_lidar_results(self, all_boxes, frame_ids, out_dir: str, uncertainties=None):
        """Per-class text files: frame_id score xc yc zc l w h ry [uc...]."""
        os.makedirs(out_dir, exist_ok=True)
        for j in range(1, self.num_classes):
            path = os.path.join(out_dir, f"det_{self.mode}_{self.classes[j]}.txt")
            with open(path, "w") as f:
                for i, fid in enumerate(frame_ids):
                    rows = all_boxes[j][i]
                    if not len(rows):
                        continue
                    for r_idx, row in enumerate(np.atleast_2d(rows)):
                        line = (
                            f"{fid} {row[7]:.6f} "
                            + " ".join(f"{v:.3f}" for v in row[:7])
                        )
                        if uncertainties is not None and len(uncertainties[j][i]):
                            for key in UC_KEYS:
                                u = uncertainties[j][i].get(key)
                                if u is not None:
                                    line += " " + " ".join(
                                        f"{v:.5f}" for v in np.atleast_1d(u[r_idx]).ravel()
                                    )
                        f.write(line + "\n")

    # -- subclass hooks ------------------------------------------------------

    def _build_roidb(self, mode: str) -> List[Dict]:
        raise NotImplementedError

    def _load_frame_data(self, entry: Dict) -> np.ndarray:
        raise NotImplementedError

    def _lidar_max_range(self) -> float:
        return 200.0

    def evaluate_detections(self, detections_per_class, gt_frames, output_dir: str):
        raise NotImplementedError
