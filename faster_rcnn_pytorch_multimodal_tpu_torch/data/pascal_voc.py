"""Pascal VOC dataset layer (legacy pipeline parity): the port's copy of
faster_rcnn_pytorch_multimodal_tpu/data/pascal_voc.py.  Frames decode with
cv2, imported at the call (the CPU only where cv2 is not installed).

Consumes the standard VOCdevkit layout the reference expects
(ref lib/datasets/pascal_voc.py:25-213):

    <data_dir>/VOCdevkit<year>/VOC<year>/
        Annotations/<index>.xml
        JPEGImages/<index>.jpg
        ImageSets/Main/<image_set>.txt

Semantics mirrored from the reference:
  * the 20 VOC classes + background index 0 (ref pascal_voc.py:35-56),
  * boxes made 0-based (xml is 1-based, ref pascal_voc.py:179-190),
  * objects marked difficult are excluded unless `use_diff`
    (ref pascal_voc.py:161-169),
  * AP uses the VOC-2007 11-point metric for years < 2010
    (ref pascal_voc.py:251-257, voc_eval.py:38-69).

Registered as `voc` / `voc_<year>` / `voc_<year>_<image_set>`; mode
train -> trainval, val/test -> themselves when no image_set is given.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import register
from faster_rcnn_pytorch_multimodal_tpu_torch.data.db_base import DetectionDB

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class PascalVocDB(DetectionDB):
    _classes = VOC_CLASSES
    type = "image"

    def __init__(self, cfg: Config, mode: str, year: str = "2007",
                 image_set: str = "", use_diff: bool = False):
        image_set = image_set or {
            "train": "trainval", "val": "val", "test": "test"
        }.get(mode, mode)
        # the resolved image_set is part of the db name so distinct splits
        # get distinct roidb cache files (voc_2007 mode=train resolves to
        # trainval; without the suffix it would collide with voc_2007_train)
        super().__init__(f"voc_{year}_{image_set}", cfg, mode)
        self._year = year
        self._use_diff = use_diff
        self._image_set = image_set
        self._devkit_path = os.path.join(cfg.data_dir, f"VOCdevkit{year}")
        self._data_path = os.path.join(self._devkit_path, f"VOC{year}")
        if not os.path.isdir(self._data_path):
            raise FileNotFoundError(
                f"VOC devkit not found at {self._data_path}"
            )

    def _split_index(self) -> List[str]:
        path = os.path.join(
            self._data_path, "ImageSets", "Main", f"{self._image_set}.txt"
        )
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]

    def _build_roidb(self, mode: str) -> List[Dict]:
        roidb = []
        for idx in self._split_index():
            entry = self._parse_annotation(idx)
            if entry is not None:
                roidb.append(entry)
        print(f"voc{self._year} {self._image_set}: {len(roidb)} frames")
        return roidb

    def _parse_annotation(self, idx: str):
        xml_path = os.path.join(self._data_path, "Annotations", f"{idx}.xml")
        tree = ET.parse(xml_path)
        objs = tree.findall("object")
        if not self._use_diff:
            objs = [
                o for o in objs
                if int((o.find("difficult").text or 0)
                       if o.find("difficult") is not None else 0) == 0
            ]
        boxes, classes = [], []
        for obj in objs:
            name = obj.find("name").text.lower().strip()
            if name not in self._classes:
                continue
            bb = obj.find("bndbox")
            # xml coordinates are 1-based (ref pascal_voc.py:179-190)
            boxes.append([
                float(bb.find("xmin").text) - 1.0,
                float(bb.find("ymin").text) - 1.0,
                float(bb.find("xmax").text) - 1.0,
                float(bb.find("ymax").text) - 1.0,
            ])
            classes.append(self._classes.index(name))
        if not boxes and self.mode == "train":
            # empty-GT frames are useless for training but must stay in
            # val/test splits: dropping them would hide frames where the
            # detector can only produce false positives, inflating AP vs
            # the reference voc_eval over the full split
            return None
        return {
            "filename": os.path.join(
                self._data_path, "JPEGImages", f"{idx}.jpg"
            ),
            "frame_id": idx,
            "scene_idx": 0,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "boxes_dc": np.zeros((0, 4), np.float32),
            "gt_classes": np.asarray(classes, np.int32),
            "ignore": np.zeros(len(boxes), bool),
            "difficulty": np.zeros(len(boxes), np.int32),
            "flipped": False,
        }

    def _load_frame_data(self, entry: Dict) -> np.ndarray:
        import cv2

        return cv2.imread(entry["filename"]).astype(np.float32)  # BGR

    def evaluate_detections(self, detections_per_class, gt_by_class, output_dir: str):
        """Per-class VOC AP@0.5 with the 2007 11-point metric for years
        < 2010 (ref pascal_voc.py:243-263, voc_eval.py:72-218)."""
        from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
            evaluate_class,
        )

        use_07 = int(self._year) < 2010
        results = {}
        aps = []
        for j in range(1, self.num_classes):
            dets = detections_per_class.get(j, [])
            gts = gt_by_class.get(j, {})
            if not gts:
                continue
            res = evaluate_class(dets, gts, iou_thresh=0.5, eval_type="2d")
            if use_07 and res["npos"] > 0:
                from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import ap

                res["ap"] = ap(res["recall"], res["precision"], use_07_metric=True)
            results[self.classes[j]] = res["ap"]
            aps.append(res["ap"])
            print(f"AP for {self.classes[j]} = {res['ap']:.4f}")
            if output_dir:
                from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
                    write_pr_pickle,
                )

                write_pr_pickle(output_dir, self.classes[j], [res])
        mean_ap = float(np.mean(aps)) if aps else 0.0
        print(f"Mean AP = {mean_ap:.4f}")
        results["mAP"] = mean_ap
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "voc_eval.txt"), "w") as f:
            for k, v in results.items():
                f.write(f"{k}: {v:.4f}\n")
        return results


@register("voc")
def _make_voc(db_name: str, cfg: Config, mode: str) -> PascalVocDB:
    parts = db_name.split("_")
    year = parts[1] if len(parts) > 1 else "2007"
    image_set = parts[2] if len(parts) > 2 else ""
    return PascalVocDB(cfg, mode, year=year, image_set=image_set)
