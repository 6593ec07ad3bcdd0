"""CADC (Canadian Adverse Driving Conditions) dataset layer: the port's
copy of faster_rcnn_pytorch_multimodal_tpu/data/cadc.py.

The reference consumes CADC converted to KITTI format by
tools/cadc_unpack_all_kitti.py (ref lib/datasets/cadc_lidb.py:33-525), with
one addition over plain KITTI: per-frame scene metadata carrying the
snowfall level, filtered via cfg.{train,test}.cadc_filter_list
(ref cadc_lidb.py:289-333, config.py:393-394).

Layout under <data_dir>/cadc/: same as kitti/ plus scene_meta/<idx>.txt (or
a scene_meta.json mapping idx -> snow level).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import register
from faster_rcnn_pytorch_multimodal_tpu_torch.data.kitti import KittiDB


class CadcDB(KittiDB):
    def __init__(self, cfg: Config, mode: str):
        # bypass KittiDB.__init__ path checks, set up our own
        super(KittiDB, self).__init__("cadc", cfg, mode)
        self._devkit_path = os.path.join(cfg.data_dir, "cadc")
        if not os.path.isdir(self._devkit_path):
            raise FileNotFoundError(f"cadc dataset not found at {self._devkit_path}")
        self._snow_filter = (
            cfg.test.cadc_filter_list if mode == "test" else cfg.train.cadc_filter_list
        )
        self._scene_meta = self._load_scene_meta()

    def _lidar_max_range(self) -> float:
        return self.cfg.limits.cadc_lidar_max_range

    def _load_scene_meta(self) -> Dict[str, str]:
        meta_json = os.path.join(self._devkit_path, "scene_meta.json")
        if os.path.exists(meta_json):
            with open(meta_json) as f:
                return json.load(f)
        meta: Dict[str, str] = {}
        meta_dir = os.path.join(self._devkit_path, "scene_meta")
        if os.path.isdir(meta_dir):
            for fn in os.listdir(meta_dir):
                with open(os.path.join(meta_dir, fn)) as f:
                    meta[os.path.splitext(fn)[0]] = f.read().strip()
        return meta

    def _snow_level(self, idx: str) -> str:
        return self._scene_meta.get(idx, "none").lower()

    def _parse_annotation(self, idx: str) -> Optional[Dict]:
        if self._snow_level(idx) not in self._snow_filter:
            return None  # snowfall-level scene filtering (ref cadc_lidb.py:289-333)
        entry = super()._parse_annotation(idx)
        if entry is not None:
            entry["snow_level"] = self._snow_level(idx)
        return entry

    def _load_frame_data(self, entry: Dict) -> np.ndarray:
        if self.cfg.net_type == "lidar":
            pts = np.fromfile(entry["filename"], dtype=np.float32).reshape(-1, 4)
            # camera-FOV crop via the intrinsic*extrinsic image transform
            # (ref lib/utils/CADC_utils.py:28-48 project_pts z-filter +
            # minibatch.py:258-264 FOV gating); calib optional in fixtures
            calib_file = entry.get("calib_file")
            if calib_file and os.path.exists(calib_file):
                from faster_rcnn_pytorch_multimodal_tpu_torch.utils.cadc_utils import (
                    project_pts,
                )

                uvz = project_pts(calib_file, pts[:, :3])
                h, w = self.cfg.limits.cadc_img_size
                flag = (
                    (uvz[:, 2] > 0)
                    & (uvz[:, 0] >= 0) & (uvz[:, 0] < w)
                    & (uvz[:, 1] >= 0) & (uvz[:, 1] < h)
                )
                pts = pts[flag]
            return pts
        import cv2

        return cv2.imread(entry["filename"]).astype(np.float32)


@register("cadc")
def _make_cadc(db_name: str, cfg: Config, mode: str) -> CadcDB:
    return CadcDB(cfg, mode)
