"""Waymo range-image -> point-cloud math, pure numpy: the port's copy of
faster_rcnn_pytorch_multimodal_tpu/utils/waymo_range_image.py.

The reference vendored the waymo-open-dataset TF implementation
(ref tools/waymo_unpack_combined.py:374-494 parse_range_image +
convert_range_image_to_point_cloud, which call range_image_utils.
extract_point_cloud_from_range_image under TF 1.14).  That math is the
core of the Waymo ETL and must be testable in-env without TF; this module
reimplements it in numpy with the same conventions:

  * a range image is (H, W) ranges; row 0 is the HIGHEST beam, so the
    per-beam inclinations (given lowest->highest) are consumed reversed,
  * column azimuth spans [pi, -pi) across the width, corrected by the
    sensor's extrinsic yaw (az_correction = atan2(R10, R00)),
  * polar -> cartesian in the sensor frame, then the 4x4 extrinsic maps
    to the vehicle frame,
  * the TOP lidar additionally carries a per-PIXEL pose (vehicle->global
    at each firing timestamp, rolling-shutter correction): points go to
    the global frame through it and return to the frame-pose vehicle
    frame through the frame pose inverse.

Used by tools/waymo_unpack_*.py as the TF-free conversion path and
golden-tested by tests/test_waymo_range_image.py (synthetic inverse
construction: known points -> range image -> recovered points).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def compute_inclination(inclination_min: float, inclination_max: float,
                        height: int) -> np.ndarray:
    """Uniform beam inclinations, lowest->highest (the waymo-od
    range_image_utils.compute_inclination contract): beam i sits at the
    CENTER of its 1/height slice."""
    return inclination_min + (0.5 + np.arange(height)) / height * (
        inclination_max - inclination_min
    )


def _rotation_zyx(roll: np.ndarray, pitch: np.ndarray, yaw: np.ndarray) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), batched over leading dims
    (waymo-od transform_utils.get_rotation_matrix)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    o = np.ones_like(cr)
    z = np.zeros_like(cr)
    rx = np.stack([o, z, z, z, cr, -sr, z, sr, cr], -1).reshape(roll.shape + (3, 3))
    ry = np.stack([cp, z, sp, z, o, z, -sp, z, cp], -1).reshape(pitch.shape + (3, 3))
    rz = np.stack([cy, -sy, z, sy, cy, z, z, z, o], -1).reshape(yaw.shape + (3, 3))
    return rz @ ry @ rx


def pixel_pose_transform(pose_ri: np.ndarray) -> np.ndarray:
    """(H, W, 6) [roll, pitch, yaw, tx, ty, tz] -> (H, W, 4, 4) transforms
    (waymo-od get_rotation_matrix + get_transform on the top-pose image)."""
    rot = _rotation_zyx(pose_ri[..., 0], pose_ri[..., 1], pose_ri[..., 2])
    out = np.zeros(pose_ri.shape[:-1] + (4, 4), pose_ri.dtype)
    out[..., :3, :3] = rot
    out[..., :3, 3] = pose_ri[..., 3:6]
    out[..., 3, 3] = 1.0
    return out


def extract_point_cloud_from_range_image(
    range_image: np.ndarray,
    extrinsic: np.ndarray,
    inclination: np.ndarray,
    pixel_pose: Optional[np.ndarray] = None,
    frame_pose: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(H, W) ranges -> (H, W, 3) cartesian points in the vehicle frame.

    inclination: (H,) per-ROW beam angles (row 0 = highest beam, i.e. the
    caller passes compute_inclination(...)[::-1], matching the reference's
    tfp.reverse, ref waymo_unpack_combined.py:466).
    pixel_pose: optional (H, W, 4, 4) vehicle->global per pixel (TOP lidar);
    frame_pose: (4, 4) vehicle->global at the frame timestamp.
    """
    h, w = range_image.shape
    # azimuth: [pi, -pi) across the width, corrected by the extrinsic yaw
    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (np.arange(w, dtype=np.float64) + 0.5) / w
    azimuth = (1.0 - 2.0 * ratios) * np.pi - az_correction

    cos_az = np.cos(azimuth)[None, :]
    sin_az = np.sin(azimuth)[None, :]
    cos_incl = np.cos(inclination)[:, None]
    sin_incl = np.sin(inclination)[:, None]

    x = cos_az * cos_incl * range_image
    y = sin_az * cos_incl * range_image
    z = sin_incl * range_image
    pts = np.stack([x, y, z], axis=-1)  # sensor frame

    # sensor -> vehicle
    pts = pts @ extrinsic[:3, :3].T + extrinsic[:3, 3]

    if pixel_pose is not None:
        if frame_pose is None:
            raise ValueError("frame_pose required with pixel_pose")
        # vehicle (per-pixel timestamp) -> global
        pts = np.einsum("hwij,hwj->hwi", pixel_pose[..., :3, :3], pts)
        pts = pts + pixel_pose[..., :3, 3]
        # global -> vehicle (frame timestamp)
        r_inv = frame_pose[:3, :3].T
        pts = (pts - frame_pose[:3, 3]) @ r_inv.T
    return pts


def range_image_to_point_cloud(
    range_image: np.ndarray,
    extrinsic: np.ndarray,
    inclination: np.ndarray,
    intensity: Optional[np.ndarray] = None,
    elongation: Optional[np.ndarray] = None,
    pixel_pose: Optional[np.ndarray] = None,
    frame_pose: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Masked conversion: rows with range <= 0 are dropped.  Returns
    (N, 3) xyz or (N, 5) [x y z intensity elongation] matching the
    framework's lidar channel layout (ref :489-493 hstack)."""
    mask = range_image > 0
    pts = extract_point_cloud_from_range_image(
        range_image, extrinsic, inclination, pixel_pose, frame_pose
    )[mask]
    if intensity is None:
        return pts.astype(np.float32)
    feats = np.stack([intensity[mask], elongation[mask]], axis=-1)
    return np.hstack([pts, feats]).astype(np.float32)
