"""nuScenes 2D image dataset layer (devkit-free): the port's copy of
faster_rcnn_pytorch_multimodal_tpu/data/nuscenes.py.  Frames decode with
cv2, imported at the call.

The reference builds its nuScenes imdb through the nuscenes-devkit and
projects 3D annotations into CAM_FRONT 2D boxes
(ref lib/datasets/nuscenes_imdb.py:39-523, _anno_to_2d_bbox:254).  This
implementation reads the v1.0 JSON tables directly (sample, sample_data,
sample_annotation, calibrated_sensor, ego_pose, sensor) and performs the
same pipeline:

  * projection: global box -> ego frame (ego_pose) -> sensor frame
    (calibrated_sensor) -> image plane (camera_intrinsic); corners behind
    the camera dropped, extent clipped to the canvas (the reference
    computes the convex-hull/canvas intersection via shapely; for an
    axis-aligned canvas the bounding box of that intersection equals the
    clipped corner extent, so no polygon library is needed),
  * annotation filters (ref :355-357): visibility_token <= 1 or
    num_lidar_pts < 1 dropped,
  * category remap (ref :364-377): the four pedestrian subtypes ->
    human.pedestrian, emergency vehicles -> vehicle.car, anything outside
    the class list -> dontcare (kept as a dc region),
  * little-clip aspect filters (ref :385-392): car/bicycle boxes that are
    too narrow+tall are dropped,
  * occlusion removal (ref :419-452): a GT fully inside another GT (or a
    dc box) that is >0.3 m nearer is removed.

Layout: <data_dir>/nuscenes/{v1.0-trainval|v1.0-mini}/*.json + samples/.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import register
from faster_rcnn_pytorch_multimodal_tpu_torch.data.db_base import DetectionDB

# ref nuscenes_imdb.py:55-59
_CLASSES = ("dontcare", "vehicle.car", "human.pedestrian", "vehicle.bicycle")

# ref nuscenes_imdb.py:364-377 — explicit subtype list (wheelchair/
# stroller/personal_mobility fall through to dontcare upstream too)
_PED_SUBTYPES = {
    "human.pedestrian.adult",
    "human.pedestrian.child",
    "human.pedestrian.construction_worker",
    "human.pedestrian.police_officer",
}
_EMERGENCY = {"vehicle.emergency.ambulance", "vehicle.emergency.police"}

# ref nuscenes_imdb.py:347-349
_MIN_THRESH_CAR = 40
_MIN_THRESH_BIKE = 20


def remap_category(name: str) -> str:
    """ref nuscenes_imdb.py:364-377."""
    if name in _PED_SUBTYPES:
        return "human.pedestrian"
    if name in _EMERGENCY:
        return "vehicle.car"
    return name if name in _CLASSES else "dontcare"


def aspect_filtered(cat: str, x1, y1, x2, y2) -> bool:
    """True if the box fails the reference's little-clip filters
    (ref nuscenes_imdb.py:385-392)."""
    w = max(x2 - x1, 1e-6)
    ar = (y2 - y1) / w
    if ar > 5.0:
        return True
    if cat == "vehicle.car" and ((w < _MIN_THRESH_CAR and ar > 2) or ar > 3.5):
        return True
    if cat == "vehicle.bicycle" and (w < _MIN_THRESH_BIKE and ar > 2.0):
        return True
    return False


def _quat_to_rot(q) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _box_corners(center, wlh, rot: np.ndarray) -> np.ndarray:
    """(8, 3) corners of a nuScenes box (w, l, h ordering); the first four
    are the +l/2 'forward' face (the devkit's corners() layout, which the
    reference's near-face depth heuristic relies on, ref :276-277)."""
    w, l, h = wlh
    x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
    y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
    z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
    pts = rot @ np.vstack([x, y, z])
    return (pts + np.asarray(center)[:, None]).T


class NuScenesDB(DetectionDB):
    _classes = _CLASSES

    def __init__(self, cfg: Config, mode: str, version: Optional[str] = None):
        super().__init__("nuscenes", cfg, mode)
        self._root = os.path.join(cfg.data_dir, "nuscenes")
        if version is None:
            for v in ("v1.0-trainval", "v1.0-mini", "v1.0-test"):
                if os.path.isdir(os.path.join(self._root, v)):
                    version = v
                    break
        if version is None or not os.path.isdir(os.path.join(self._root, version)):
            raise FileNotFoundError(f"nuscenes tables not found under {self._root}")
        self._version = version

    def _table(self, name: str) -> List[Dict]:
        with open(os.path.join(self._root, self._version, f"{name}.json")) as f:
            return json.load(f)

    def _build_roidb(self, mode: str) -> List[Dict]:
        samples = self._table("sample")
        sample_data = self._table("sample_data")
        anns = self._table("sample_annotation")
        calib = {c["token"]: c for c in self._table("calibrated_sensor")}
        poses = {p["token"]: p for p in self._table("ego_pose")}
        sensors = {s["token"]: s for s in self._table("sensor")}

        # CAM_FRONT keyframe per sample
        cam_by_sample: Dict[str, Dict] = {}
        for sd in sample_data:
            if not sd.get("is_key_frame"):
                continue
            sensor = sensors.get(calib[sd["calibrated_sensor_token"]]["sensor_token"])
            if sensor and sensor["channel"] == "CAM_FRONT":
                cam_by_sample[sd["sample_token"]] = sd

        anns_by_sample: Dict[str, List[Dict]] = {}
        for a in anns:
            anns_by_sample.setdefault(a["sample_token"], []).append(a)

        roidb = []
        for sample in samples:
            sd = cam_by_sample.get(sample["token"])
            if sd is None:
                continue
            cs = calib[sd["calibrated_sensor_token"]]
            pose = poses[sd["ego_pose_token"]]
            intrinsic = np.asarray(cs["camera_intrinsic"], np.float64)
            w_img, h_img = sd["width"], sd["height"]

            boxes, classes, dists = [], [], []
            boxes_dc, dists_dc = [], []
            for a in anns_by_sample.get(sample["token"], []):
                # ref :355-357 annotation filters
                if int(a.get("visibility_token", 4) or 4) <= 1:
                    continue
                if int(a.get("num_lidar_pts", 1)) < 1:
                    continue
                proj = self._project_box(a, pose, cs, intrinsic, w_img, h_img)
                if proj is None:
                    continue
                bb, dist = proj
                cat = remap_category(a["category_name"])
                if cat == "dontcare":
                    boxes_dc.append(bb)
                    dists_dc.append(dist)
                    continue
                if aspect_filtered(cat, *bb):
                    continue
                boxes.append(bb)
                classes.append(self._classes.index(cat))
                dists.append(dist)

            # occlusion removal (ref :419-452): drop a GT fully inside a
            # >0.3 m nearer GT or dc box (near-face depth, dists[1])
            keep = []
            for i in range(len(boxes)):
                remove = False
                for js, jd in ((boxes, dists), (boxes_dc, dists_dc)):
                    for j in range(len(js)):
                        if js is boxes and i == j:
                            continue
                        inside = (
                            boxes[i][0] > js[j][0]
                            and boxes[i][1] > js[j][1]
                            and boxes[i][2] < js[j][2]
                            and boxes[i][3] < js[j][3]
                        )
                        if inside and (dists[i][1] - jd[j][1]) > 0.3:
                            remove = True
                if not remove:
                    keep.append(i)
            boxes = [boxes[i] for i in keep]
            classes = [classes[i] for i in keep]

            if not boxes and mode == "train":
                continue  # ref remove_without_gt (val/test keep empties)
            roidb.append(
                {
                    "filename": os.path.join(self._root, sd["filename"]),
                    "frame_id": sample["token"],
                    "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                    "boxes_dc": np.asarray(boxes_dc, np.float32).reshape(-1, 4),
                    "gt_classes": np.asarray(classes, np.int32),
                    "ignore": np.zeros(len(boxes), bool),
                    "difficulty": np.zeros(len(boxes), np.int32),
                    "flipped": False,
                }
            )
        print(f"nuscenes {mode}: {len(roidb)} frames")
        return roidb

    @staticmethod
    def _project_box(ann, pose, cs, intrinsic, w_img, h_img):
        """global 3D ann -> (clipped CAM_FRONT 2D box, (center_dist,
        near_face_depth)) or None (ref nuscenes_imdb.py:_anno_to_2d_bbox:254)."""
        corners = _box_corners(
            ann["translation"], ann["size"], _quat_to_rot(ann["rotation"])
        )
        # global -> ego
        r_e = _quat_to_rot(pose["rotation"])
        corners = (corners - np.asarray(pose["translation"])) @ r_e
        center = (np.asarray(ann["translation"]) - np.asarray(pose["translation"])) @ r_e
        # ego -> sensor
        r_s = _quat_to_rot(cs["rotation"])
        corners = (corners - np.asarray(cs["translation"])) @ r_s
        center = (center - np.asarray(cs["translation"])) @ r_s
        dist = (float(np.linalg.norm(center)), float(corners[:4, 2].mean()))
        in_front = corners[:, 2] > 0.1
        if not in_front.any():
            return None  # fully behind the camera
        corners = corners[in_front]
        uv = corners @ intrinsic.T
        uv = uv[:, :2] / uv[:, 2:3]
        x1, y1 = uv.min(0)
        x2, y2 = uv.max(0)
        if x2 < 0 or x1 > w_img - 1 or y2 < 0 or y1 > h_img - 1:
            return None  # no canvas intersection (ref :292-303)
        x1, x2 = np.clip([x1, x2], 0, w_img - 1)
        y1, y2 = np.clip([y1, y2], 0, h_img - 1)
        if x2 - x1 < 2 or y2 - y1 < 2:
            return None
        return [float(x1), float(y1), float(x2), float(y2)], dist

    def _load_frame_data(self, entry: Dict) -> np.ndarray:
        import cv2

        return cv2.imread(entry["filename"]).astype(np.float32)

    def evaluate_detections(self, detections_per_class, gt_frames, output_dir: str):
        """VOC-style AP (ref nuscenes_eval.py:104)."""
        from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import (
            evaluate_class,
        )

        results = {}
        for j in range(1, self.num_classes):
            res = evaluate_class(
                detections_per_class[j], gt_frames, iou_thresh=0.5, eval_type="2d"
            )
            results[self.classes[j]] = res["ap"]
            print(f"{self.classes[j]} AP(2d@0.5) = {res['ap']:.4f}")
        return results


@register("nuscenes")
def _make_nuscenes(db_name: str, cfg: Config, mode: str) -> NuScenesDB:
    return NuScenesDB(cfg, mode)
