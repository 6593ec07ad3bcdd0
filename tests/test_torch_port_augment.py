"""The port's host augmentation and native point-cloud ops against the JAX
package's.

* native/pc_ops: every op on every seed equals JAX's native library bit for
  bit (the JAX library must have built: otherwise its numpy fallback draws
  from another stream and the comparison means nothing); the deterministic
  ops equal their numpy twins (the rotation within two float32 ulps of the
  larger input coordinate: the library's float32 cos/sin and contracted
  x*c - y*s against the twin's float64 cos/sin and float32 matmul); a
  compiler that fails raises and
  never falls back.
* data/augment: `augment_lidar_frame` with each switch alone and all
  together, and the image pipeline's pieces, bitwise equal to JAX's from the
  same RandomState (seeds 0-3 and on, until each switch's branches have
  run); the draws left in the RandomState after the call equal too.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list as j_cfg_from_list
from faster_rcnn_pytorch_multimodal_tpu.config import default_config as j_default_config
from faster_rcnn_pytorch_multimodal_tpu.data import augment as j_aug
from faster_rcnn_pytorch_multimodal_tpu.native import pc_ops as j_pc
from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list as t_cfg_from_list
from faster_rcnn_pytorch_multimodal_tpu_torch.config import default_config as t_default_config
from faster_rcnn_pytorch_multimodal_tpu_torch.data import augment as t_aug
from faster_rcnn_pytorch_multimodal_tpu_torch.native import pc_ops as t_pc

REPO = Path(__file__).resolve().parents[1]
SEEDS = (0, 1, 2, 3)


def _bitwise(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")), what
    else:
        assert np.array_equal(a, b), what


def _cloud(seed, n=6000):
    rng = np.random.RandomState(100 + seed)
    return np.hstack([rng.uniform(-10, 80, (n, 1)), rng.uniform(-45, 45, (n, 1)),
                      rng.uniform(-3.5, 3.5, (n, 1)), rng.uniform(0, 1, (n, 2))]).astype(np.float32)


def test_jax_native_library_built():
    assert j_pc.available(), "the JAX package's libpc_ops did not build: the comparisons below "\
        "would meet its numpy fallback"


_OPS = {
    "pc_gauss_distort": lambda s: ([0.07 * (s + 1) / 4, 0.05, 0.03], 7919 * s + 1),
    "pc_dropout": lambda s: (0.8 + 0.05 * s, (1 << 30) + s),
    "pc_rain_sim": lambda s: (0.5 + 2 * s, 120.0 + 40 * s, 31 * s + 5),
    "pc_rotate_z": lambda s: (-1.5 + 0.9 * s,),
    "pc_flip_y": lambda s: (),
    "pc_flip_x": lambda s: (70.0 - s,),
    "pc_swap_xy": lambda s: (-40.0 + s, 35.0),
    "pc_range_filter": lambda s: ([0.0, 70.0 - s, -40.0, 40.0, -3.0, 3.0 - s],),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_native_op_equals_jax_library(op):
    assert j_pc.available()
    for seed in SEEDS:
        pts = _cloud(seed)
        before = pts.copy()
        args = _OPS[op](seed)
        got, want = getattr(t_pc, op)(pts, *args), getattr(j_pc, op)(pts, *args)
        _bitwise(got, want, f"{op} seed {seed}")
        _bitwise(pts, before, "the input is left as it was")


@pytest.mark.parametrize("op", ["pc_range_filter", "pc_flip_y", "pc_flip_x", "pc_swap_xy"])
def test_deterministic_op_equals_its_twin(op):
    for seed in SEEDS:
        pts = _cloud(seed)
        args = _OPS[op](seed)
        _bitwise(getattr(t_pc, op)(pts, *args), getattr(t_pc, op + "_plain")(pts, *args), op)


def test_rotate_equals_its_twin_within_two_ulps():
    for seed in SEEDS:
        pts = _cloud(seed)
        ang = _OPS["pc_rotate_z"](seed)[0]
        got, want = t_pc.pc_rotate_z(pts, ang), t_pc.pc_rotate_z_plain(pts, ang)
        # x*c - y*s may cancel: the rounding is relative to the terms, so
        # the ulp is the larger input coordinate's
        ulp = np.spacing(np.abs(pts[:, :2]).max(1, keepdims=True))
        assert np.all(np.abs(got[:, :2] - want[:, :2]) <= 2 * ulp)
        _bitwise(got[:, 2:], pts[:, 2:], "z and the channels untouched")


def test_library_lives_under_build_keyed_by_source():
    path = t_pc.library_path()
    assert path.parent.parent == REPO / "build" / "native"
    assert t_pc.build() == path and path.exists()


def test_failed_build_raises_and_never_falls_back(tmp_path):
    """CXX=false: the compiler fails, so pc_ops raises with its output and
    no op returns anything (the library's key names the compiler, so a
    built library for g++ is not reused)."""
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from faster_rcnn_pytorch_multimodal_tpu_torch.native import pc_ops\n"
        "try:\n"
        "    pc_ops.pc_dropout(np.zeros((10, 5), np.float32), 0.5, 1)\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n"
        "else:\n"
        "    print('RETURNED')\n"
    )
    env = dict(os.environ, CXX="false")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "RAISED" in proc.stdout and "RETURNED" not in proc.stdout
    assert "false" in proc.stdout and "failed" in proc.stdout


# -- augment_lidar_frame ------------------------------------------------------

_SWITCHES = ("EN_AUG_FLIPS", "EN_AUG_GAUSS_DISTORT", "EN_AUG_DROPOUT", "EN_AUG_ROTATE",
             "EN_AUG_SWAP_X_Y")


def _cfgs(*overrides):
    return (j_cfg_from_list(j_default_config(), overrides),
            t_cfg_from_list(t_default_config(), overrides))


def _switch_overrides(which):
    out = ["NET_TYPE", "lidar"]
    for s in _SWITCHES:
        out += [f"LIDAR.{s}", str(which == "all" or which == s)]
    return tuple(out)


def _boxes(rng, g):
    return np.stack([rng.uniform(0, 70, g), rng.uniform(-40, 40, g), rng.uniform(-2, 2, g),
                     rng.uniform(3, 5, g), rng.uniform(1.5, 2.2, g), rng.uniform(1.3, 1.9, g),
                     rng.uniform(-np.pi, np.pi, g)], 1).astype(np.float32)


def _branches(cfg, seed) -> set:
    """The branches augment_lidar_frame takes on RandomState(seed): its
    first draws, in its order (a switch that is off draws nothing)."""
    rng, lc, taken = np.random.RandomState(seed), cfg.lidar, set()
    for name, on, p in (("flip_y", lc.en_aug_flips, 0.5), ("flip_x", lc.en_aug_flips, 0.5),
                        ("gauss", lc.en_aug_gauss_distort, 0.3),
                        ("dropout", lc.en_aug_dropout, 0.3), ("rotate", lc.en_aug_rotate, 0.3),
                        ("swap", lc.en_aug_swap_x_y, 0.3)):
        if on and rng.choice([True, False], p=[p, 1 - p]):
            taken.add(name)
    return taken


LIDAR_SEEDS = range(12)  # seeds 0-3 and on: each switch alone is taken on some of them


@pytest.mark.parametrize("which", _SWITCHES + ("all",))
def test_augment_lidar_frame_bitwise(which):
    jc, tc = _cfgs(*_switch_overrides(which))
    taken = set()
    for seed in LIDAR_SEEDS:
        pts = _cloud(seed)
        boxes = _boxes(np.random.RandomState(seed), 12)
        ignore = np.random.RandomState(seed).uniform(size=12) < 0.2
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        want = j_aug.augment_lidar_frame(pts, boxes, ignore, jc, rj)
        got = t_aug.augment_lidar_frame(pts, boxes, ignore, tc, rt)
        for name, g, w in zip(("points", "boxes", "ignore"), got, want):
            _bitwise(g, w, f"{which} seed {seed} {name}")
        assert rt.randint(1 << 31) == rj.randint(1 << 31)  # same draws taken
        taken |= _branches(tc, seed)
    want_taken = ({"flip_y", "flip_x", "gauss", "dropout", "rotate", "swap"} if which == "all"
                  else {"EN_AUG_FLIPS": {"flip_y", "flip_x"}, "EN_AUG_GAUSS_DISTORT": {"gauss"},
                        "EN_AUG_DROPOUT": {"dropout"}, "EN_AUG_ROTATE": {"rotate"},
                        "EN_AUG_SWAP_X_Y": {"swap"}}[which])
    assert taken == want_taken  # every branch of the switch ran on some seed


# -- the image side ------------------------------------------------------------


def _image(seed, hw=(96, 160)):
    rng = np.random.RandomState(200 + seed)
    return rng.uniform(0, 255, hw + (3,)).astype(np.float32)


def _image_boxes(rng, g, hw=(96, 160)):
    xy = rng.uniform(-10, hw[1] - 20, (g, 2))
    wh = rng.uniform(4, 60, (g, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_image_augment_pipeline_bitwise():
    pytest.importorskip("cv2")
    for seed in range(8):  # seeds 0-3 and more: the affine branch is taken 30% of the time
        img = _image(seed)
        rng = np.random.RandomState(seed)
        boxes, dc = _image_boxes(rng, 6), _image_boxes(rng, 2)
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        want = j_aug.image_augment_pipeline(img, boxes, dc, rj)
        got = t_aug.image_augment_pipeline(img, boxes, dc, rt)
        for name, g, w in zip(("image", "boxes", "boxes_dc"), got, want):
            _bitwise(g, w, f"seed {seed} {name}")
        assert rt.randint(1 << 31) == rj.randint(1 << 31)


def test_image_helpers_bitwise():
    pytest.importorskip("cv2")
    for seed in SEEDS:
        img = _image(seed)
        rng = np.random.RandomState(seed)
        boxes = _image_boxes(rng, 7)
        _bitwise(t_aug.flip_image_boxes(img, boxes)[0], j_aug.flip_image_boxes(img, boxes)[0])
        _bitwise(t_aug.flip_image_boxes(img, boxes)[1], j_aug.flip_image_boxes(img, boxes)[1])
        _bitwise(t_aug.photometric_distort(img, np.random.RandomState(seed)),
                 j_aug.photometric_distort(img, np.random.RandomState(seed)))
        ignore = rng.uniform(size=7) < 0.3
        for g, w in zip(t_aug.clip_and_ignore_boxes(boxes, ignore, 160, 96),
                        j_aug.clip_and_ignore_boxes(boxes, ignore, 160, 96)):
            _bitwise(g, w, "clip_and_ignore_boxes")
        _bitwise(t_aug.weather_corrupt(img, np.random.RandomState(seed)),
                 j_aug.weather_corrupt(img, np.random.RandomState(seed)))


def test_test_time_lidar_helpers_bitwise():
    """The numpy rain and dropout (augment.rain_sim, test_dropout) and the
    camera-FOV flag, with and without a calibration."""
    from faster_rcnn_pytorch_multimodal_tpu.utils.kitti_utils import Calibration as JCalib
    from faster_rcnn_pytorch_multimodal_tpu_torch.utils.kitti_utils import Calibration as TCalib

    calib = {"P2": np.array([700, 0, 600, 0, 0, 700, 180, 0, 0, 0, 1, 0], float),
             "R0_rect": np.eye(3).ravel(),
             "Tr_velo_to_cam": np.array([0, -1, 0, 0, 0, 0, -1, 0, 1, 0, 0, 0], float)}
    jcal, tcal = JCalib(None, from_dict=calib), TCalib(None, from_dict=calib)
    for seed in SEEDS:
        pts = _cloud(seed, 3000)
        _bitwise(t_aug.rain_sim(pts, 1.0 + seed, 150.0, np.random.RandomState(seed)),
                 j_aug.rain_sim(pts, 1.0 + seed, 150.0, np.random.RandomState(seed)))
        _bitwise(t_aug.test_dropout(pts, np.random.RandomState(seed)),
                 j_aug.test_dropout(pts, np.random.RandomState(seed)))
        _bitwise(t_aug.rotate_points_along_z(pts, 0.4 * seed),
                 j_aug.rotate_points_along_z(pts, 0.4 * seed))
        rect_t, rect_j = tcal.project_velo_to_rect(pts[:, :3]), jcal.project_velo_to_rect(pts[:, :3])
        _bitwise(rect_t, rect_j, "project_velo_to_rect")
        _bitwise(t_aug.get_fov_flag(rect_t, (375, 1242), tcal),
                 j_aug.get_fov_flag(rect_j, (375, 1242), jcal))
        _bitwise(t_aug.get_fov_flag(rect_t, (375, 1242)), j_aug.get_fov_flag(rect_j, (375, 1242)))
