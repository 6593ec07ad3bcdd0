"""COCO dataset layer (legacy pipeline parity): the port's copy of
faster_rcnn_pytorch_multimodal_tpu/data/coco.py.  Frames decode with cv2,
imported at the call.

Consumes the standard COCO layout (ref lib/datasets/coco.py:28-120, which
used pycocotools; this is a devkit-free pure-JSON reader):

    <data_dir>/coco/
        annotations/instances_<split><year>.json
        images/<split><year>/<file_name>

Semantics mirrored from the reference:
  * category ids remapped to contiguous class indices with background 0
    (ref coco.py:66-77),
  * bbox [x, y, w, h] -> [x1, y1, x2, y2] with the w-1/h-1 clamp the
    reference applies (ref coco.py:164-176),
  * crowd annotations become don't-care boxes (the reference filtered
    iscrowd in its roidb handling).

Registered as `coco` / `coco_<year>`; mode train/val/test map to the
matching splits.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import register
from faster_rcnn_pytorch_multimodal_tpu_torch.data.db_base import DetectionDB


class CocoDB(DetectionDB):
    type = "image"

    def __init__(self, cfg: Config, mode: str, year: str = "2014"):
        self._year = year
        self._split = {"train": "train", "val": "val", "test": "test"}.get(
            mode, mode
        ) + year
        self._root = os.path.join(cfg.data_dir, "coco")
        ann_path = os.path.join(
            self._root, "annotations", f"instances_{self._split}.json"
        )
        if not os.path.exists(ann_path):
            raise FileNotFoundError(f"COCO annotations not found at {ann_path}")
        with open(ann_path) as f:
            self._coco = json.load(f)
        cats = sorted(self._coco["categories"], key=lambda c: c["id"])
        self._classes = ("__background__",) + tuple(c["name"] for c in cats)
        self._cat_to_class = {
            c["id"]: i + 1 for i, c in enumerate(cats)
        }
        super().__init__(f"coco_{year}", cfg, mode)

    def _build_roidb(self, mode: str) -> List[Dict]:
        anns_by_img: Dict[int, list] = {}
        for a in self._coco["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)
        roidb = []
        for img in self._coco["images"]:
            anns = anns_by_img.get(img["id"], [])
            entry = self._parse_annotation(img, anns)
            if entry is not None:
                roidb.append(entry)
        print(f"coco {self._split}: {len(roidb)} frames")
        return roidb

    def _parse_annotation(self, img: Dict, anns: list):
        w, h = float(img["width"]), float(img["height"])
        boxes, classes, boxes_dc = [], [], []
        for a in anns:
            x, y, bw, bh = a["bbox"]
            # ref coco.py:164-176: clip to [0, w-1] x [0, h-1], keep only
            # boxes with positive extent after the clamp
            x1 = float(np.clip(x, 0, w - 1))
            y1 = float(np.clip(y, 0, h - 1))
            x2 = float(np.clip(x + bw - 1, 0, w - 1))
            y2 = float(np.clip(y + bh - 1, 0, h - 1))
            if x2 <= x1 or y2 <= y1:
                continue
            if a.get("iscrowd", 0):
                boxes_dc.append([x1, y1, x2, y2])
                continue
            cls = self._cat_to_class.get(a["category_id"])
            if cls is None:
                continue
            boxes.append([x1, y1, x2, y2])
            classes.append(cls)
        if not boxes and self.mode == "train":
            # keep empty-GT (incl. crowd-only) frames on val/test: the full
            # split must be evaluated or AP inflates vs COCOeval
            return None
        return {
            "filename": os.path.join(
                self._root, "images", self._split, img["file_name"]
            ),
            "frame_id": str(img["id"]),
            "scene_idx": 0,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "boxes_dc": np.asarray(boxes_dc, np.float32).reshape(-1, 4),
            "gt_classes": np.asarray(classes, np.int32),
            "ignore": np.zeros(len(boxes), bool),
            "difficulty": np.zeros(len(boxes), np.int32),
            "flipped": False,
        }

    def _load_frame_data(self, entry: Dict) -> np.ndarray:
        import cv2

        return cv2.imread(entry["filename"]).astype(np.float32)  # BGR

    def evaluate_detections(self, detections_per_class, gt_by_class, output_dir: str):
        """COCO-style mAP@[.5:.95] (plus AP@0.5) via the greedy matcher,
        replacing the reference's COCOeval dependency (ref coco.py:217-249)."""
        from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
            evaluate_class,
        )

        results = {}
        ap50s, ap5095s = [], []
        thresholds = np.arange(0.5, 1.0, 0.05)
        for j in range(1, self.num_classes):
            dets = detections_per_class.get(j, [])
            gts = gt_by_class.get(j, {})
            if not gts or not any(len(g["boxes"]) for g in gts.values()):
                continue
            aps = [
                evaluate_class(dets, gts, iou_thresh=float(t), eval_type="2d")["ap"]
                for t in thresholds
            ]
            results[self.classes[j]] = {"ap50": aps[0], "ap": float(np.mean(aps))}
            ap50s.append(aps[0])
            ap5095s.append(float(np.mean(aps)))
        m50 = float(np.mean(ap50s)) if ap50s else 0.0
        m = float(np.mean(ap5095s)) if ap5095s else 0.0
        print(f"mAP@0.5 = {m50:.4f}, mAP@[.5:.95] = {m:.4f}")
        results["mAP50"] = m50
        results["mAP"] = m
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "coco_eval.txt"), "w") as f:
            for k, v in results.items():
                f.write(f"{k}: {v}\n")
        return results


@register("coco")
def _make_coco(db_name: str, cfg: Config, mode: str) -> CocoDB:
    parts = db_name.split("_")
    year = parts[1] if len(parts) > 1 else "2014"
    return CocoDB(cfg, mode, year=year)
