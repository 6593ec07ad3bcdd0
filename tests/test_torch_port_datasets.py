"""The port's KITTI, Waymo, CADC, Pascal VOC, COCO and nuScenes databases
against the JAX package's, on the JAX tests' own fixture trees
(tests/test_datasets.py `_make_kitti_tree`, `_make_waymo_tree`,
tests/test_cadc.py `_make_cadc_tree`, tests/test_voc_coco.py's `voc_root`
and `coco_root`, tests/test_nuscenes.py's `_make_nusc_tree`; image files
and a val split added here where a test needs them).

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
from tests.test_nuscenes import _ann, _make_nusc_tree
from tests.test_voc_coco import _write_png, coco_root, voc_root

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
    """Every JAX database is registered: without its tree each raises
    FileNotFoundError, as JAX's does; an unknown name (JAX registers VOC as
    `voc`, not `pascal`) is a KeyError naming the choices."""
    cfg = t_cfg_from_list(t_default_config(), ("DATA_DIR", "/nonexistent"))
    jcfg = j_cfg_from_list(j_default_config(), ("DATA_DIR", "/nonexistent"))
    for name in ("imaginary", "pascal_voc"):
        with pytest.raises(KeyError, match="available"):
            t_get_db(name, cfg, "train")
        with pytest.raises(KeyError, match="available"):
            j_get_db(name, jcfg, "train")
    for name, says in (("kitti", "kitti"), ("waymo", "waymo"), ("cadc", "cadc"),
                       ("nuscenes", "nuscenes"), ("voc_2007_trainval", "VOC"),
                       ("coco", "COCO")):
        with pytest.raises(FileNotFoundError, match=says):
            t_get_db(name, cfg, "train")


# -- Pascal VOC, COCO and nuScenes (tests/test_voc_coco.py, tests/test_nuscenes.py) --

# the annotations of tests/test_nuscenes.py's cases, on one sample: the
# projection, a subtype remap, a box behind the camera, the visibility and
# lidar-point filters, a dontcare region, a sliver car, occlusion and a
# yawed box
_NUSC_ANNS = [
    _ann("a1", "vehicle.car", [0.0, 0.0, 10.0], [2.0, 4.5, 1.6]),
    _ann("a2", "human.pedestrian.adult", [6.0, 0.0, 12.0], [0.6, 0.6, 1.8]),
    _ann("a3", "vehicle.car", [0.0, 0.0, -15.0], [2.0, 4.5, 1.6]),
    _ann("a4", "vehicle.car", [3.0, 0.0, 10.0], [2.0, 4.5, 1.6], vis="1"),
    _ann("a5", "vehicle.car", [-3.0, 0.0, 10.0], [2.0, 4.5, 1.6], pts=0),
    _ann("a6", "movable_object.barrier", [1.0, 1.0, 8.0], [2.0, 2.0, 1.0]),
    _ann("a7", "vehicle.car", [5.0, 0.0, 40.0], [0.5, 0.5, 8.0]),
    _ann("a8", "vehicle.car", [0.0, 0.0, 30.0], [1.8, 4.0, 1.5]),
    _ann("a9", "vehicle.car", [-6.0, 0.5, 30.0], [2.0, 4.5, 1.6],
         rotation=[0.5 ** 0.5, 0.0, 0.5 ** 0.5, 0.0]),
    _ann("a11", "vehicle.bicycle", [-4.0, 0.5, 12.0], [0.6, 1.8, 1.2]),
    _ann("a10", "vehicle.emergency.police", [-8.0, 0.0, 20.0], [2.0, 4.5, 1.6]),
]


def _image_db_tree(name, tmp_path):
    """The JAX tests' trees: test_voc_coco's VOC and COCO fixtures (64x96
    frames), test_nuscenes's tree with _NUSC_ANNS (and a 90x160 image for
    its one frame); VOC and COCO with a val split, a copy of the train one."""
    if name == "voc_2007":
        root = voc_root.__wrapped__(tmp_path)
        main = os.path.join(root, "VOCdevkit2007", "VOC2007", "ImageSets", "Main")
        shutil.copy(os.path.join(main, "trainval.txt"), os.path.join(main, "val.txt"))
        return root
    if name == "coco_2014":
        root = coco_root.__wrapped__(tmp_path)
        ann = os.path.join(root, "coco", "annotations")
        shutil.copy(os.path.join(ann, "instances_train2014.json"),
                    os.path.join(ann, "instances_val2014.json"))
        return root
    root = _make_nusc_tree(str(tmp_path), _NUSC_ANNS)
    _write_png(os.path.join(root, "nuscenes", "samples", "CAM_FRONT", "f1.jpg"), 90, 160)
    return root


@pytest.mark.parametrize("name", ["voc_2007", "coco_2014", "nuscenes"])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_image_db_roidb_equals_jax(tmp_path, name, mode):
    """get_db builds each database on the JAX tests' seeded trees, and its
    roidb equals JAX's field by field, bitwise."""
    jdb, tdb = _dbs(name, _image_db_tree(name, tmp_path), mode, "NET_TYPE", "image")
    _roidb_equal(jdb, tdb)
    assert tdb.num_classes == {"voc_2007": 21, "coco_2014": 3, "nuscenes": 4}[name]


@pytest.mark.parametrize("name", ["voc_2007", "coco_2014", "nuscenes"])
def test_image_db_frames_equal_jax(tmp_path, name):
    """The frames (cv2's decode, flips, the image augmentation, a scale)
    equal JAX's bitwise for seeds 0-3."""
    pytest.importorskip("cv2")
    jdb, tdb = _dbs(name, _image_db_tree(name, tmp_path), "train", "NET_TYPE", "image")
    for i in range(len(jdb)):
        _frame_equal(tdb.frame(i, augment=False), jdb.frame(i, augment=False), f"{name} {i}")
        _frame_equal(tdb.frame(i, augment=True, rng=np.random.RandomState(0), scale=0.5),
                     jdb.frame(i, augment=True, rng=np.random.RandomState(0), scale=0.5),
                     f"{name} {i} at scale 0.5")
        for seed in SEEDS:
            _frame_equal(tdb.frame(i, augment=True, rng=np.random.RandomState(seed)),
                         jdb.frame(i, augment=True, rng=np.random.RandomState(seed)),
                         f"{name} frame {i} seed {seed}")


def _image_db_dets(db, rng):
    """Per-class detections near, on and off each GT box of the roidb, with
    a duplicate a box, and each class's GT by frame."""
    dets = {j: [] for j in range(1, db.num_classes)}
    gts = {}
    for entry in db.roidb:
        fid = entry["frame_id"]
        for j in range(1, db.num_classes):
            boxes = entry["boxes"][entry["gt_classes"] == j]
            gts.setdefault(j, {})[fid] = {"boxes": boxes}
            for b in boxes:
                for shift in (0.0, 2.0, 9.0):
                    dets[j].append({
                        "frame_id": fid, "bbox": b + rng.uniform(-shift, shift, 4),
                        "confidence": float(rng.uniform())})
    return dets, gts


@pytest.mark.parametrize("name", ["voc_2007", "coco_2014", "nuscenes"])
def test_image_db_eval_equals_jax(tmp_path, name):
    """evaluate_detections through the port's eval_utils gives JAX's APs:
    VOC's 11-point 2007 metric (and voc_eval.txt byte for byte), COCO's AP50
    and AP@[.5:.95] over ten IoU thresholds (and coco_eval.txt), nuScenes'
    VOC-style AP a class."""
    jdb, tdb = _dbs(name, _image_db_tree(name, tmp_path), "val", "NET_TYPE", "image")
    dets, gts = _image_db_dets(jdb, np.random.RandomState(3))
    if name == "nuscenes":
        frames = {e["frame_id"]: {"boxes": e["boxes"]} for e in jdb.roidb}
        want = jdb.evaluate_detections(dets, frames, str(tmp_path / "jax"))
        got = tdb.evaluate_detections(dets, frames, str(tmp_path / "port"))
    else:
        want = jdb.evaluate_detections(dets, gts, str(tmp_path / "jax"))
        got = tdb.evaluate_detections(dets, gts, str(tmp_path / "port"))
        txt = "voc_eval.txt" if name == "voc_2007" else "coco_eval.txt"
        with open(tmp_path / "jax" / txt) as f, open(tmp_path / "port" / txt) as g:
            assert g.read() == f.read()
    assert got == want and any(v for v in want.values()), (got, want)
