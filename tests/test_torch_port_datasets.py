"""The port's KITTI, Waymo and CADC databases against the JAX package's, on
the JAX tests' own fixture trees (tests/test_datasets.py `_make_kitti_tree`,
`_make_waymo_tree`, tests/test_cadc.py `_make_cadc_tree`; image files and a
val split added here where a test needs them).

Each package gets its own CACHE_DIR: the roidb is pickled there on the
first read, and a shared cache would hand JAX's roidb to the port.  Every
comparison is bitwise: the roidb field by field, `frame(i, augment=True,
rng=RandomState(s))` for seeds 0-3 (LiDAR: points, gt_boxes, gt_boxes_dc,
window, info; images: data, boxes), the test-time rain and dropout, and the
KITTI and CADC calibration helpers.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list as j_cfg_from_list
from faster_rcnn_pytorch_multimodal_tpu.config import default_config as j_default_config
from faster_rcnn_pytorch_multimodal_tpu.data.datasets import get_db as j_get_db
from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list as t_cfg_from_list
from faster_rcnn_pytorch_multimodal_tpu_torch.config import default_config as t_default_config
from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import get_db as t_get_db
from tests.test_cadc import _make_cadc_tree
from tests.test_datasets import _make_kitti_tree, _make_waymo_tree

SEEDS = (0, 1, 2, 3)


def _bitwise(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        assert np.array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")), what
    else:
        assert np.array_equal(a, b), what


def _equal(got, want, what=""):
    """Nested dicts / lists / arrays / scalars equal, arrays bitwise."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (what, got.keys(), want.keys())
        for k in want:
            _equal(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        _bitwise(got, want, what)
    else:
        assert type(got) is type(want) and got == want, (what, got, want)


def _dbs(name, root, mode, *overrides, cache="cache"):
    """The JAX and the port database over one tree, each with its cache
    (`cache`_jax, `cache`_port: a new name for each filter setting)."""
    base = ("DATA_DIR", str(root))
    jc = j_cfg_from_list(j_default_config(), base + overrides
                         + ("CACHE_DIR", os.path.join(root, cache + "_jax")))
    tc = t_cfg_from_list(t_default_config(), base + overrides
                         + ("CACHE_DIR", os.path.join(root, cache + "_port")))
    return j_get_db(name, jc, mode), t_get_db(name, tc, mode)


def _roidb_equal(jdb, tdb):
    assert tdb.name == jdb.name and tuple(tdb.classes) == tuple(jdb.classes)
    assert len(tdb) == len(jdb) > 0
    _equal(tdb.roidb, jdb.roidb, "roidb")


def _frame_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        if k == "filename":
            assert got[k] == want[k]
        else:
            _bitwise(got[k], want[k], f"{what} {k}")


# -- trees ---------------------------------------------------------------------


def _kitti_tree(tmp_path, image_hw=None):
    root = _make_kitti_tree(str(tmp_path), n_frames=3)
    base = os.path.join(root, "kitti", "training")
    rng = np.random.RandomState(7)
    # a second car of each difficulty and another DontCare in frame 1
    with open(os.path.join(base, "label_2", "000001.txt"), "a") as f:
        f.write("Car 0.1 1 0.2 200 150 260 185 1.5 1.7 4.0 -3.0 1.6 30.0 0.2\n")
        f.write("Van 0.4 2 -0.5 100 170 140 199 2.0 1.9 5.0 4.0 1.7 45.0 -0.5\n")
        f.write("DontCare -1 -1 -10 20 30 60 70 -1 -1 -1 -1000 -1000 -1000 -10\n")
    if image_hw is not None:
        import cv2

        for i in range(3):
            img = rng.randint(0, 256, image_hw + (3,)).astype(np.uint8)
            cv2.imwrite(os.path.join(base, "image_2", f"{i:06d}.png"), img)
    return root


def _waymo_tree(tmp_path, image_hw=None, val=False):
    root = _make_waymo_tree(str(tmp_path), n_frames=4)
    base = os.path.join(root, "waymo", "train")
    if image_hw is not None:
        import cv2

        rng = np.random.RandomState(8)
        os.makedirs(os.path.join(base, "images"))
        labels = []
        for i in range(4):
            stem = f"{i:07d}"
            cv2.imwrite(os.path.join(base, "images", stem + ".png"),
                        rng.randint(0, 256, image_hw + (3,)).astype(np.uint8))
            labels.append({
                "assoc_frame": stem, "scene_type": [{"tod": "Day", "weather": "sunny"}],
                "box": [{"x1": 10.0 + i, "y1": 20.0, "x2": 70.0, "y2": 60.0},
                        {"x1": 90.0, "y1": 30.0, "x2": 130.0 + i, "y2": 85.0},
                        {"x1": 5.0, "y1": 5.0, "x2": 25.0, "y2": 40.0}],
                "class": [1, 1, 2], "difficulty": [0, 2, 0],
                "meta": [{"pts": 50}, {"pts": 2}, {"pts": 9}],
            })
        with open(os.path.join(base, "labels", "image_labels.json"), "w") as f:
            json.dump(labels, f)
    if val:
        shutil.copytree(base, os.path.join(root, "waymo", "val"))
    return root


# -- roidb ---------------------------------------------------------------------


@pytest.mark.parametrize("net_type", ["lidar", "image"])
def test_kitti_roidb_equals_jax(tmp_path, net_type):
    root = _kitti_tree(tmp_path)
    jdb, tdb = _dbs("kitti", root, "train", "NET_TYPE", net_type)
    _roidb_equal(jdb, tdb)
    assert os.path.exists(os.path.join(root, "cache_port", "kitti_train_" + net_type
                                       + "_gt_roidb.pkl"))
    # a second database reads the port's cache back
    _, again = _dbs("kitti", root, "train", "NET_TYPE", net_type)
    _equal(again.roidb, jdb.roidb, "cached roidb")


@pytest.mark.parametrize("net_type", ["lidar", "image"])
def test_waymo_roidb_equals_jax(tmp_path, net_type):
    root = _waymo_tree(tmp_path, image_hw=(120, 200) if net_type == "image" else None)
    jdb, tdb = _dbs("waymo", root, "train", "NET_TYPE", net_type)
    _roidb_equal(jdb, tdb)
    # the time-of-day filter
    jdb, tdb = _dbs("waymo", root, "train", "NET_TYPE", net_type, "TRAIN.TOD_FILTER_LIST",
                    "('Night',)", cache="night")
    assert len(jdb.roidb) == len(tdb.roidb) == 0


def test_cadc_roidb_equals_jax(tmp_path):
    root = _make_cadc_tree(str(tmp_path))
    jdb, tdb = _dbs("cadc", root, "train", "NET_TYPE", "lidar")
    _roidb_equal(jdb, tdb)
    jdb, tdb = _dbs("cadc", root, "train", "NET_TYPE", "lidar", "TRAIN.CADC_FILTER_LIST",
                    "('none',)", cache="snow")
    _roidb_equal(jdb, tdb)
    assert [e["snow_level"] for e in tdb.roidb] == ["none"]


# -- frames ----------------------------------------------------------------------

_ALL_AUG = ("LIDAR.EN_AUG_ROTATE", "True")  # the JAX defaults turn the other four on


@pytest.mark.parametrize("name", ["kitti", "waymo", "cadc"])
def test_lidar_frames_equal_jax(tmp_path, name):
    root = {"kitti": _kitti_tree, "waymo": _waymo_tree,
            "cadc": lambda p: _make_cadc_tree(str(p))}[name](tmp_path)
    jdb, tdb = _dbs(name, root, "train", "NET_TYPE", "lidar", *_ALL_AUG)
    for i in range(len(jdb)):
        _frame_equal(tdb.frame(i, augment=False), jdb.frame(i, augment=False), f"{name} {i}")
        for seed in SEEDS:
            _frame_equal(tdb.frame(i, augment=True, rng=np.random.RandomState(seed)),
                         jdb.frame(i, augment=True, rng=np.random.RandomState(seed)),
                         f"{name} frame {i} seed {seed}")


@pytest.mark.parametrize("switch", ["EN_AUG_FLIPS", "EN_AUG_GAUSS_DISTORT", "EN_AUG_DROPOUT",
                                    "EN_AUG_ROTATE", "EN_AUG_SWAP_X_Y"])
def test_waymo_frame_each_switch_alone(tmp_path, switch):
    root = _waymo_tree(tmp_path)
    flags = []
    for s in ("EN_AUG_FLIPS", "EN_AUG_GAUSS_DISTORT", "EN_AUG_DROPOUT", "EN_AUG_ROTATE",
              "EN_AUG_SWAP_X_Y"):
        flags += [f"LIDAR.{s}", str(s == switch)]
    jdb, tdb = _dbs("waymo", root, "train", "NET_TYPE", "lidar", *flags)
    for seed in range(8):
        _frame_equal(tdb.frame(seed % len(jdb), augment=True, rng=np.random.RandomState(seed)),
                     jdb.frame(seed % len(jdb), augment=True, rng=np.random.RandomState(seed)),
                     f"{switch} seed {seed}")


@pytest.mark.parametrize("name", ["kitti", "waymo"])
def test_image_frames_equal_jax(tmp_path, name):
    pytest.importorskip("cv2")
    root = (_kitti_tree(tmp_path, image_hw=(280, 640)) if name == "kitti"
            else _waymo_tree(tmp_path, image_hw=(120, 200), val=True))
    jdb, tdb = _dbs(name, root, "train", "NET_TYPE", "image")
    for i in range(len(jdb)):
        _frame_equal(tdb.frame(i, augment=False), jdb.frame(i, augment=False), f"{name} {i}")
        _frame_equal(tdb.frame(i, augment=True, rng=np.random.RandomState(0), scale=0.5),
                     jdb.frame(i, augment=True, rng=np.random.RandomState(0), scale=0.5),
                     f"{name} {i} at scale 0.5")
        for seed in SEEDS:
            _frame_equal(tdb.frame(i, augment=True, rng=np.random.RandomState(seed)),
                         jdb.frame(i, augment=True, rng=np.random.RandomState(seed)),
                         f"{name} frame {i} seed {seed}")
    # test-time weather corruption (TEST.AUGMENT_EN) on the val split
    jdb, tdb = _dbs(name, root, "val", "NET_TYPE", "image", "TEST.AUGMENT_EN", "True",
                    cache="weather")
    for seed in SEEDS:
        _frame_equal(tdb.frame(0, rng=np.random.RandomState(seed)),
                     jdb.frame(0, rng=np.random.RandomState(seed)), f"weather {seed}")


@pytest.mark.parametrize("name", ["kitti", "waymo"])
def test_test_time_rain_and_dropout_equal_jax(tmp_path, name):
    """TEST.RAIN_SIM_EN and TEST.DROPOUT_EN on the val split: the native
    rain and dropout, seeded from the frame's RandomState; and from the
    database's own RandomState when the caller passes none."""
    root = _kitti_tree(tmp_path) if name == "kitti" else _waymo_tree(tmp_path, val=True)
    sets = ("NET_TYPE", "lidar", "TEST.RAIN_SIM_EN", "True", "TEST.DROPOUT_EN", "True",
            "TEST.RAIN_RATE", "4.0")
    jdb, tdb = _dbs(name, root, "val", *sets)
    plain_j, _ = _dbs(name, root, "val", "NET_TYPE", "lidar", cache="plain")
    for seed in SEEDS:
        got = tdb.frame(seed % len(tdb), rng=np.random.RandomState(seed))
        want = jdb.frame(seed % len(jdb), rng=np.random.RandomState(seed))
        _frame_equal(got, want, f"rain seed {seed}")
        assert len(got["points"]) < len(plain_j.frame(seed % len(jdb))["points"])
    for i in range(len(jdb)):  # the databases' own RandomState, in turn
        _frame_equal(tdb.frame(i), jdb.frame(i), f"db rng frame {i}")


# -- helpers ---------------------------------------------------------------------


def test_kitti_and_cadc_utils_equal_jax(tmp_path):
    from faster_rcnn_pytorch_multimodal_tpu.utils import cadc_utils as jcu
    from faster_rcnn_pytorch_multimodal_tpu.utils import kitti_utils as jku
    from faster_rcnn_pytorch_multimodal_tpu_torch.utils import cadc_utils as tcu
    from faster_rcnn_pytorch_multimodal_tpu_torch.utils import kitti_utils as tku

    root = _kitti_tree(tmp_path)
    calib_file = os.path.join(root, "kitti", "training", "calib", "000000.txt")
    jc, tc = jku.Calibration(calib_file), tku.Calibration(calib_file)
    pts = np.random.RandomState(3).uniform(-30, 60, (500, 3)).astype(np.float32)
    for fn in ("project_velo_to_rect", "project_rect_to_velo", "project_velo_to_image",
               "project_rect_to_image", "project_velo_to_ref", "project_ref_to_velo"):
        _bitwise(getattr(tc, fn)(pts), getattr(jc, fn)(pts), fn)
    with open(os.path.join(root, "kitti", "training", "label_2", "000001.txt")) as f:
        lines = [line for line in f if line.strip()]
    for line in lines:
        jo, to = jku.Object3d(line), tku.Object3d(line)
        assert vars(to).keys() == vars(jo).keys()
        _equal({k: v for k, v in vars(to).items()}, {k: v for k, v in vars(jo).items()}, line)
        if jo.type != "DontCare":
            _bitwise(tku.camera_box_to_velo(to, tc), jku.camera_box_to_velo(jo, jc))
            for g, w in zip(tku.compute_box_3d(to, tc), jku.compute_box_3d(jo, jc)):
                _bitwise(g, w, "compute_box_3d")
    _bitwise(tcu.project_pts(calib_file, pts), jcu.project_pts(calib_file, pts))
    for g, w in zip(tcu.load_calib(calib_file), jcu.load_calib(calib_file)):
        _bitwise(g, w, "load_calib")


def test_registry_names():
    cfg = t_cfg_from_list(t_default_config(), ("DATA_DIR", "/nonexistent"))
    with pytest.raises(KeyError, match="available"):
        t_get_db("imaginary", cfg, "train")
    for name in ("nuscenes", "voc_2007_trainval", "pascal_voc", "coco"):
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            t_get_db(name, cfg, "train")
    for name in ("kitti", "waymo", "cadc"):
        with pytest.raises(FileNotFoundError, match=name):
            t_get_db(name, cfg, "train")
