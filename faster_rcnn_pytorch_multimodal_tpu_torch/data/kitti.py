"""KITTI dataset layers (LiDAR BEV + 2D image): the port's copy of
faster_rcnn_pytorch_multimodal_tpu/data/kitti.py.  Image frames decode with
cv2, imported at the call.

Standard KITTI object layout under <data_dir>/kitti/:
  training/{velodyne/*.bin, image_2/*.png, label_2/*.txt, calib/*.txt}
  splits/{train,val,test}.txt  (ref kitti_lidb.py:46-49)

Mirrors ref lib/datasets/kitti_lidb.py:31-284 / kitti_imdb.py:
  * label lines parsed with utils.kitti_utils.Object3d,
  * lidar boxes converted camera->velo frame via the calib
    (ref kitti_lidb.py:277-284),
  * difficulty from occlusion/truncation/2D box height
    (easy/moderate/hard, ref kitti_lidb.py:209-216),
  * Car/Van -> car; DontCare -> dc boxes; other classes skipped
    (vehicle-focused training like the Waymo path).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.data import augment as aug
from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import register
from faster_rcnn_pytorch_multimodal_tpu_torch.data.db_base import DetectionDB
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.kitti_utils import (
    Calibration,
    Object3d,
    camera_box_to_velo,
)


def _difficulty(obj: Object3d) -> int:
    """0 easy / 1 moderate / 2 hard / 3 unknown (ref kitti_lidb.py:209-216)."""
    h = obj.ymax - obj.ymin
    if h >= 40 and obj.occlusion == 0 and obj.truncation <= 0.15:
        return 0
    if h >= 25 and obj.occlusion <= 1 and obj.truncation <= 0.3:
        return 1
    if h >= 25 and obj.occlusion <= 2 and obj.truncation <= 0.5:
        return 2
    return 3


class KittiDB(DetectionDB):
    _classes = ("dontcare", "car")

    def __init__(self, cfg: Config, mode: str):
        super().__init__("kitti", cfg, mode)
        self._devkit_path = os.path.join(cfg.data_dir, "kitti")
        if not os.path.isdir(self._devkit_path):
            raise FileNotFoundError(f"kitti dataset not found at {self._devkit_path}")

    def _lidar_max_range(self) -> float:
        return self.cfg.limits.kitti_lidar_max_range

    def _split_index(self, mode: str) -> List[str]:
        split_file = os.path.join(self._devkit_path, "splits", f"{mode}.txt")
        if os.path.exists(split_file):
            with open(split_file) as f:
                return [l.strip() for l in f if l.strip()]
        d = os.path.join(self._devkit_path, "training", "label_2")
        return sorted(os.path.splitext(f)[0] for f in os.listdir(d))

    def _build_roidb(self, mode: str) -> List[Dict]:
        roidb = []
        for idx in self._split_index(mode):
            entry = self._parse_annotation(idx)
            if entry is not None:
                roidb.append(entry)
        print(f"kitti {mode}: {len(roidb)} frames")
        return roidb

    def _parse_annotation(self, idx: str):
        cfg = self.cfg
        base = os.path.join(self._devkit_path, "training")
        label_file = os.path.join(base, "label_2", f"{idx}.txt")
        calib_file = os.path.join(base, "calib", f"{idx}.txt")
        if not os.path.exists(label_file):
            return None
        with open(label_file) as f:
            objs = [Object3d(l) for l in f if l.strip()]
        is_lidar = cfg.net_type == "lidar"
        calib = Calibration(calib_file) if is_lidar else None

        boxes, boxes_dc, classes, difficulty = [], [], [], []
        for obj in objs:
            t = obj.type.lower()
            if t == "dontcare":
                if is_lidar:
                    continue  # dc has no valid 3D pose
                boxes_dc.append(obj.box2d.tolist())
                continue
            if t not in ("car", "van"):
                continue
            if is_lidar:
                b = camera_box_to_velo(obj, calib)
                if not (
                    cfg.lidar.x_range[0] <= b[0] <= cfg.lidar.x_range[1]
                    and cfg.lidar.y_range[0] <= b[1] <= cfg.lidar.y_range[1]
                    and cfg.lidar.z_range[0] <= b[2] <= cfg.lidar.z_range[1]
                ):
                    continue
                boxes.append(b.tolist())
            else:
                boxes.append(obj.box2d.tolist())
            classes.append(1)
            difficulty.append(_difficulty(obj))
        if not boxes:
            return None
        e = 7 if is_lidar else 4
        sub = "velodyne" if is_lidar else "image_2"
        ext = "bin" if is_lidar else "png"
        return {
            "filename": os.path.join(base, sub, f"{idx}.{ext}"),
            "frame_id": idx,
            "calib_file": calib_file,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, e),
            "boxes_dc": np.asarray(boxes_dc, np.float32).reshape(-1, 4 if not is_lidar else e),
            "gt_classes": np.asarray(classes, np.int32),
            "ignore": np.zeros(len(boxes), bool),
            "difficulty": np.asarray(difficulty, np.int32),
            "flipped": False,
        }

    def _load_frame_data(self, entry: Dict) -> np.ndarray:
        if self.cfg.net_type == "lidar":
            pts = np.fromfile(entry["filename"], dtype=np.float32).reshape(-1, 4)
            # camera-FOV crop (ref minibatch.py:258-264)
            calib = Calibration(entry["calib_file"])
            rect = calib.project_velo_to_rect(pts[:, :3])
            flag = aug.get_fov_flag(rect, self.cfg.limits.kitti_img_size, calib)
            return pts[flag]
        import cv2

        return cv2.imread(entry["filename"]).astype(np.float32)

    def evaluate_detections(self, detections_per_class, gt_by_class, output_dir: str):
        """Easy/Moderate/Hard AP (ref kitti_lidb.py:380-424)."""
        from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
            evaluate_class,
        )

        eval_type = (
            self.cfg.lidar.eval_type if self.cfg.net_type == "lidar" else "2d"
        )
        iou_t = 0.7
        results = {}
        for j in range(1, self.num_classes):
            level_res = []
            for name, keep in (
                ("easy", lambda d: d <= 0),
                ("moderate", lambda d: d <= 1),
                ("hard", lambda d: d <= 2),
            ):
                res = evaluate_class(
                    detections_per_class[j],
                    gt_by_class[j],
                    iou_thresh=iou_t,
                    eval_type=eval_type,
                    difficulty_filter=keep,
                )
                level_res.append(res)
                results[(self.classes[j], name)] = res["ap"]
                print(
                    f"{self.classes[j]} {name} AP({eval_type}@{iou_t}) = "
                    f"{res['ap']:.4f} (npos={res['npos']})"
                )
            if output_dir:
                # per-class PR artifact (ref waymo_lidb.py:601-602 pattern)
                from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
                    write_pr_pickle,
                )

                write_pr_pickle(output_dir, self.classes[j], level_res)
        return results


@register("kitti")
def _make_kitti(db_name: str, cfg: Config, mode: str) -> KittiDB:
    return KittiDB(cfg, mode)
