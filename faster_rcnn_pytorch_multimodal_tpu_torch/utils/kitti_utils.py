"""KITTI calibration + label objects: the port's copy of
faster_rcnn_pytorch_multimodal_tpu/utils/kitti_utils.py (numpy; a
re-implementation of the surface of
ref lib/utils/kitti_utils.py:46-281, 549-600 that the pipeline consumes:
velo<->rect<->image projections, label parsing, 3D box corners)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


class Object3d:
    """One KITTI label line (ref kitti_utils.py:46-81).

    Format: type trunc occ alpha x1 y1 x2 y2 h w l x y z ry
    (camera/rect frame; (x, y, z) is the BOTTOM center of the box)."""

    def __init__(self, line: str):
        d = line.strip().split(" ")
        self.type = d[0]
        self.truncation = float(d[1])
        self.occlusion = int(float(d[2]))
        self.alpha = float(d[3])
        self.xmin, self.ymin, self.xmax, self.ymax = map(float, d[4:8])
        self.box2d = np.array([self.xmin, self.ymin, self.xmax, self.ymax])
        self.h, self.w, self.l = map(float, d[8:11])
        self.t = np.array(list(map(float, d[11:14])))
        self.ry = float(d[14])
        self.score = float(d[15]) if len(d) > 15 else -1.0


def _inverse_rigid_trans(tr: np.ndarray) -> np.ndarray:
    inv = np.zeros_like(tr)
    inv[:3, :3] = tr[:3, :3].T
    inv[:3, 3] = -tr[:3, :3].T @ tr[:3, 3]
    return inv


class Calibration:
    """KITTI calib file (ref kitti_utils.py:83-281).

    Frames: velo (x fwd, y left, z up), ref cam, rect cam (x right, y down,
    z fwd), image (u, v in px)."""

    def __init__(self, calib_filepath: str, from_dict: dict | None = None):
        if from_dict is not None:
            calibs = from_dict
        else:
            calibs = self._read_calib_file(calib_filepath)
        self.P = calibs["P2"].reshape(3, 4)
        self.V2C = calibs["Tr_velo_to_cam"].reshape(3, 4)
        self.C2V = _inverse_rigid_trans(
            np.vstack([self.V2C, [0, 0, 0, 1]])
        )[:3, :]
        self.R0 = calibs["R0_rect"].reshape(3, 3)
        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    @staticmethod
    def _read_calib_file(filepath: str) -> dict:
        data = {}
        with open(filepath) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, value = line.split(":", 1)
                try:
                    data[key.strip()] = np.array(
                        [float(x) for x in value.split()]
                    )
                except ValueError:
                    pass
        # some files name the keys differently
        if "R0_rect" not in data and "R_rect" in data:
            data["R0_rect"] = data["R_rect"]
        return data

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _homog(pts: np.ndarray) -> np.ndarray:
        return np.hstack([pts, np.ones((len(pts), 1))])

    # -- velo <-> rect -------------------------------------------------------

    def project_velo_to_ref(self, pts: np.ndarray) -> np.ndarray:
        return self._homog(pts) @ self.V2C.T

    def project_ref_to_velo(self, pts: np.ndarray) -> np.ndarray:
        return self._homog(pts) @ self.C2V.T

    def project_ref_to_rect(self, pts: np.ndarray) -> np.ndarray:
        return pts @ self.R0.T

    def project_rect_to_ref(self, pts: np.ndarray) -> np.ndarray:
        return pts @ np.linalg.inv(self.R0).T

    def project_velo_to_rect(self, pts: np.ndarray) -> np.ndarray:
        return self.project_ref_to_rect(self.project_velo_to_ref(pts))

    def project_rect_to_velo(self, pts: np.ndarray) -> np.ndarray:
        return self.project_ref_to_velo(self.project_rect_to_ref(pts))

    # -- rect <-> image -----------------------------------------------------

    def project_rect_to_image(self, pts: np.ndarray) -> np.ndarray:
        p2d = self._homog(pts) @ self.P.T
        return p2d[:, :2] / p2d[:, 2:3]

    def rect_to_img(self, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(uv, depth) — the fov-filter interface (ref minibatch.py:686)."""
        return self.project_rect_to_image(pts), pts[:, 2]

    def project_velo_to_image(self, pts: np.ndarray) -> np.ndarray:
        return self.project_rect_to_image(self.project_velo_to_rect(pts))


def compute_box_3d(obj: Object3d, calib: Calibration | None = None):
    """3D box corners in rect frame (+ image projection when calib given)
    (ref kitti_utils.py:549-600)."""
    c, s = np.cos(obj.ry), np.sin(obj.ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    l, w, h = obj.l, obj.w, obj.h
    x = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y = [0, 0, 0, 0, -h, -h, -h, -h]
    z = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    corners = rot @ np.vstack([x, y, z]) + obj.t[:, None]
    corners = corners.T  # (8, 3) rect frame
    if calib is None:
        return corners, None
    return corners, calib.project_rect_to_image(corners)


def camera_box_to_velo(obj: Object3d, calib: Calibration) -> np.ndarray:
    """Camera-frame KITTI label -> velo-frame 7-DoF [xc,yc,zc,l,w,h,ry]
    with z at the box CENTER (ref kitti_lidb.py:277-284 conversion).

    KITTI t is the bottom-center in rect coords; heading ry (rect, around
    y-down) maps to velo yaw = -ry - pi/2."""
    center_rect = obj.t.copy()
    center_rect[1] -= obj.h / 2.0  # bottom -> center (y points down)
    center_velo = calib.project_rect_to_velo(center_rect[None])[0]
    yaw = -obj.ry - np.pi / 2.0
    # normalize to (-pi, pi]
    yaw = np.arctan2(np.sin(yaw), np.cos(yaw))
    return np.array(
        [center_velo[0], center_velo[1], center_velo[2], obj.l, obj.w, obj.h, yaw],
        dtype=np.float32,
    )
