"""CADC calibration helpers, the port's copy of
faster_rcnn_pytorch_multimodal_tpu/utils/cadc_utils.py (ref lib/utils/CADC_utils.py:13-48):
intrinsic x extrinsic -> 4x4 image transform, point projection with
z-filtering for camera-FOV cropping."""

from __future__ import annotations

import json

import numpy as np


def get_image_transform(intrinsic: np.ndarray, extrinsic: np.ndarray) -> np.ndarray:
    """(3,3) camera intrinsic + (4,4) lidar->camera extrinsic -> (4,4)
    projection (ref CADC_utils.py:13-26)."""
    k = np.eye(4)
    k[:3, :3] = np.asarray(intrinsic, np.float64)
    return k @ np.asarray(extrinsic, np.float64)


def load_calib(calib_file: str):
    """CADC kitti-converted calib txt or json -> (intrinsic, extrinsic)."""
    if calib_file.endswith(".json"):
        with open(calib_file) as f:
            c = json.load(f)
        return np.asarray(c["intrinsic"]), np.asarray(c["extrinsic"])
    data = {}
    with open(calib_file) as f:
        for line in f:
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            try:
                data[key.strip()] = np.array([float(x) for x in val.split()])
            except ValueError:
                pass
    intrinsic = data["P2"].reshape(3, 4)[:, :3]
    extr = np.eye(4)
    extr[:3, :] = data["Tr_velo_to_cam"].reshape(3, 4)
    return intrinsic, extr


def project_pts(calib_file: str, pts: np.ndarray) -> np.ndarray:
    """Project (N, 3) lidar points to image plane; behind-camera points get
    z <= 0 (ref CADC_utils.py:28-48).  Returns (N, 3) [u, v, z]."""
    intrinsic, extrinsic = load_calib(calib_file)
    t = get_image_transform(intrinsic, extrinsic)
    homog = np.hstack([pts, np.ones((len(pts), 1))])
    proj = homog @ t.T
    z = proj[:, 2:3]
    uv = np.where(z > 0, proj[:, :2] / np.maximum(z, 1e-9), -1.0)
    return np.hstack([uv, z])
