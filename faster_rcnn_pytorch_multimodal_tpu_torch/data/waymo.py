"""Waymo Open dataset layers (LiDAR BEV + 2D image): the port's copy of
faster_rcnn_pytorch_multimodal_tpu/data/waymo.py.  Image frames decode with
cv2, imported at the call.

Consumes the unpacked format the reference ETL produces
(ref tools/waymo_unpack_combined.py: per-frame .npy point clouds under
<data_dir>/waymo/<mode>/point_clouds/, FRONT .png under images/, and
labels/{lidar_labels,image_labels}.json), and mirrors the reference's
annotation semantics (ref lib/datasets/waymo_lidb.py:331-488,
waymo_imdb.py:256-380):

  * class remap: everything except VEHICLE -> unknown/skipped (VEHICLE-only
    training, ref waymo_lidb.py:383-388),
  * time-of-day scene filtering via cfg.{train,test}.tod_filter_list,
  * boxes outside the configured X/Y/Z range dropped,
  * per-box meta (pts, intensity, elongation, return_ratio, distance) kept
    for difficulty-aware evaluation,
  * Waymo difficulty: level 2 if annotated difficulty == 2 or < 5 lidar
    points, else level 1 (ref waymo_eval.py difficulty handling).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import register
from faster_rcnn_pytorch_multimodal_tpu_torch.data.db_base import DetectionDB

# ref tools/waymo_unpack_combined.py class ids
_CLASS_UNKNOWN, _CLASS_VEHICLE, _CLASS_PEDESTRIAN, _CLASS_SIGN, _CLASS_CYCLIST = range(5)


class WaymoDB(DetectionDB):
    _classes = ("dontcare", "vehicle.car")

    def __init__(self, cfg: Config, mode: str):
        super().__init__("waymo", cfg, mode)
        self._devkit_path = os.path.join(cfg.data_dir, "waymo")
        self._tod_filter = (
            cfg.test.tod_filter_list if mode == "test" else cfg.train.tod_filter_list
        )
        if not os.path.isdir(self._devkit_path):
            raise FileNotFoundError(
                f"waymo dataset not found at {self._devkit_path}; unpack it "
                "with tools/waymo_unpack_combined.py first"
            )

    def _lidar_max_range(self) -> float:
        return self.cfg.limits.waymo_lidar_max_range

    def _index(self, mode: str) -> List[str]:
        sub = "point_clouds" if self.cfg.net_type == "lidar" else "images"
        d = os.path.join(self._devkit_path, mode, sub)
        return sorted(os.listdir(d))

    def _labels(self, mode: str) -> List[Dict]:
        name = (
            "lidar_labels.json"
            if self.cfg.net_type == "lidar"
            else "image_labels.json"
        )
        path = os.path.join(self._devkit_path, mode, "labels", name)
        if not os.path.exists(path):  # combined-ETL variant
            path = os.path.join(self._devkit_path, mode, "labels", "combined_labels.json")
        with open(path) as f:
            return json.loads(f.read())

    def _build_roidb(self, mode: str) -> List[Dict]:
        labels = {l["assoc_frame"]: l for l in self._labels(mode)}
        roidb = []
        skipped = 0
        for fname in self._index(mode):
            stem = os.path.splitext(fname)[0]
            lab = labels.get(stem)
            if lab is None:
                continue
            entry = self._parse_annotation(mode, fname, lab)
            if entry is None:
                skipped += 1
            else:
                roidb.append(entry)
        print(f"waymo {mode}: {len(roidb)} frames ({skipped} filtered)")
        return roidb

    def _parse_annotation(self, mode: str, fname: str, lab: Dict):
        cfg = self.cfg
        tod = lab["scene_type"][0]["tod"]
        if tod not in self._tod_filter:
            return None
        is_lidar = cfg.net_type == "lidar"
        boxes, boxes_dc, classes = [], [], []
        difficulty, num_pts, meta = [], [], []
        for i, bbox in enumerate(lab["box"]):
            cls_id = lab["class"][i]
            # remap (ref waymo_lidb.py:377-388): VEHICLE only
            cat = "vehicle.car" if cls_id == _CLASS_VEHICLE else "dontcare"
            if is_lidar:
                b = [
                    float(bbox["xc"]), float(bbox["yc"]), float(bbox["zc"]),
                    float(bbox["lx"]), float(bbox["wy"]), float(bbox["hz"]),
                    float(bbox["heading"]),
                ]
                if not (
                    cfg.lidar.x_range[0] <= b[0] <= cfg.lidar.x_range[1]
                    and cfg.lidar.y_range[0] <= b[1] <= cfg.lidar.y_range[1]
                    and cfg.lidar.z_range[0] <= b[2] <= cfg.lidar.z_range[1]
                ):
                    continue
            else:
                b = [
                    float(bbox["x1"]), float(bbox["y1"]),
                    float(bbox["x2"]), float(bbox["y2"]),
                ]
            if cat == "dontcare":
                boxes_dc.append(b)
                continue
            boxes.append(b)
            classes.append(self._classes.index(cat))
            m = lab.get("meta", [{}] * len(lab["box"]))[i]
            pts = int(float(m.get("pts", 0)))
            num_pts.append(pts)
            diff = int(lab.get("difficulty", [0] * len(lab["box"]))[i])
            # L2 if annotated difficulty 2 or sparse (<5 pts)
            difficulty.append(2 if (diff == 2 or pts < 5) else 1)
            meta.append(
                {
                    "avg_intensity": float(m.get("avg_intensity", 0.0)),
                    "avg_elongation": float(m.get("avg_elongation", 0.0)),
                    "return_ratio": float(m.get("return_ratio", 0.0)),
                }
            )
        if not boxes:
            return None
        sub = "point_clouds" if is_lidar else "images"
        e = 7 if is_lidar else 4
        return {
            "filename": os.path.join(self._devkit_path, mode, sub, fname),
            "frame_id": lab["assoc_frame"],
            "scene_idx": int(int(lab["assoc_frame"]) / cfg.max_img_per_scene),
            "scene_desc": json.dumps(lab["scene_type"][0]),
            "boxes": np.asarray(boxes, np.float32).reshape(-1, e),
            "boxes_dc": np.asarray(boxes_dc, np.float32).reshape(-1, e),
            "gt_classes": np.asarray(classes, np.int32),
            "ignore": np.zeros(len(boxes), bool),
            "difficulty": np.asarray(difficulty, np.int32),
            "num_pts": np.asarray(num_pts, np.int32),
            "meta": meta,
            "flipped": False,
        }

    def _load_frame_data(self, entry: Dict) -> np.ndarray:
        if self.cfg.net_type == "lidar":
            return np.load(entry["filename"]).astype(np.float32)
        import cv2

        return cv2.imread(entry["filename"]).astype(np.float32)  # BGR

    # -- evaluation (ref waymo_lidb.py:568-611 + waymo_eval.py) ---------------

    def evaluate_detections(self, detections_per_class, gt_by_class, output_dir: str):
        """Waymo L1/L2 difficulty AP (ref waymo_lidb.py:568-611)."""
        from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
            evaluate_class,
        )

        eval_type = (
            self.cfg.lidar.eval_type if self.cfg.net_type == "lidar" else "2d"
        )
        iou_t = 0.7 if eval_type in ("bev", "bev_aa") else (0.7 if eval_type == "3d" else 0.5)
        results = {}
        for j in range(1, self.num_classes):
            level_res = []
            for level, keep in (
                (1, lambda d: d <= 1),  # L1: easy GT only
                (2, lambda d: d <= 2),  # L2: all GT
            ):
                res = evaluate_class(
                    detections_per_class[j],
                    gt_by_class[j],
                    iou_thresh=iou_t,
                    eval_type=eval_type,
                    difficulty_filter=keep,
                )
                level_res.append(res)
                results[(self.classes[j], f"L{level}")] = res["ap"]
                print(
                    f"{self.classes[j]} L{level} AP({eval_type}@{iou_t}) = "
                    f"{res['ap']:.4f} (npos={res['npos']})"
                )
                if level == 2 and self.cfg.debug.test_frame_print:
                    # ref DEBUG.TEST_FRAME_PRINT -> display_frame_counts
                    from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
                        display_frame_counts,
                    )

                    display_frame_counts(
                        res["tp_frame"], res["fp_frame"], res["npos_frame"]
                    )
            if output_dir:
                # per-class PR artifact (ref waymo_lidb.py:601-602)
                from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
                    write_pr_pickle,
                )

                write_pr_pickle(output_dir, self.classes[j], level_res)
        return results


@register("waymo")
def _make_waymo(db_name: str, cfg: Config, mode: str) -> WaymoDB:
    return WaymoDB(cfg, mode)
