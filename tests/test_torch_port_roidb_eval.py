"""The port's roidb evaluation against the JAX package's, on the JAX tests'
fixture trees, on the CPU.

* evaluation/eval_utils: the uncertainty det-file surface copied from JAX
  (:188-355, :432-449) gives JAX's results on the same inputs.
* DetectionDB.write_lidar_results / write_image_results: the per-class det
  files byte-identical to JAX's, with and without uncertainty columns.
* KittiDB / WaymoDB.evaluate_detections: JAX's AP per difficulty (KITTI
  easy/moderate/hard, Waymo L1/L2) and its PR pickles on the same
  detections.
* inference.evaluate_roidb, tools/test_net_torch.py's branch for a real
  database: boxes back to meters or raw pixels, detections.pkl, det files,
  the per-scene uncertainty file and the evaluation equal what JAX's
  database methods make of the same network-space boxes
  (tools/test_net.py:176-273).
* tools/trainval_net_torch.py --db kitti takes 2 res18 steps on the KITTI
  fixture at a small raster, and tools/test_net_torch.py --db kitti
  --eval_det on its snapshot writes the det files and prints
  easy/moderate/hard AP.
"""

from __future__ import annotations

import importlib.util
import io
import json
import os
import pickle
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list as j_cfg_from_list
from faster_rcnn_pytorch_multimodal_tpu.config import default_config as j_default_config
from faster_rcnn_pytorch_multimodal_tpu.data.datasets import get_db as j_get_db
from faster_rcnn_pytorch_multimodal_tpu.evaluation import eval_utils as j_eu
from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list as t_cfg_from_list
from faster_rcnn_pytorch_multimodal_tpu_torch.config import default_config as t_default_config
from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import get_db as t_get_db
from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation import eval_utils as t_eu
from faster_rcnn_pytorch_multimodal_tpu_torch.inference import evaluate_roidb
from tests.test_datasets import _make_kitti_tree, _make_waymo_tree

REPO = Path(__file__).resolve().parents[1]
UC_KEYS = ("a_entropy", "a_mutual_info", "a_cls_var", "a_bbox_var", "e_entropy",
           "e_mutual_info", "e_cls_var", "e_bbox_var")


def _quiet(fn, *a, **kw):
    with redirect_stdout(io.StringIO()) as out:
        res = fn(*a, **kw)
    return res, out.getvalue()


def _kitti_tree(tmp_path):
    """The JAX fixture, 3 frames, and one Car of each difficulty in frame 1."""
    root = _make_kitti_tree(str(tmp_path), n_frames=3)
    with open(os.path.join(root, "kitti", "training", "label_2", "000001.txt"), "a") as f:
        f.write("Car 0.1 1 0.2 200 150 260 185 1.5 1.7 4.0 -3.0 1.6 30.0 0.2\n")
        f.write("Van 0.4 2 -0.5 100 170 140 199 2.0 1.9 5.0 4.0 1.7 45.0 -0.5\n")
    return root


def _waymo_tree(tmp_path):
    """The JAX fixture, 4 frames, with a sparse (L2) vehicle in each."""
    root = _make_waymo_tree(str(tmp_path), n_frames=4)
    path = os.path.join(root, "waymo", "train", "labels", "lidar_labels.json")
    with open(path) as f:
        labels = json.load(f)
    for i, lab in enumerate(labels):
        lab["box"].append({"xc": 45.0 - i, "yc": -12.0, "zc": 0.2, "lx": 4.4, "wy": 1.9,
                           "hz": 1.5, "heading": 1.0})
        lab["class"].append(1)
        lab["difficulty"].append(2 if i % 2 else 0)
        lab["meta"].append({"pts": 3})
    with open(path, "w") as f:
        json.dump(labels, f)
    return root


def _dbs(name, root, mode, *overrides):
    base = ("DATA_DIR", root) + overrides
    jc = j_cfg_from_list(j_default_config(), base + ("CACHE_DIR", os.path.join(root, "cj")))
    tc = t_cfg_from_list(t_default_config(), base + ("CACHE_DIR", os.path.join(root, "ct")))
    return j_get_db(name, jc, mode), t_get_db(name, tc, mode)


def _detections(db, rng, lidar):
    """Per class, per frame: the GT jittered (some dropped), and false
    positives; rows [box..., score] in the database's frame (meters or
    pixels)."""
    e = 7 if lidar else 4
    out = [[np.zeros((0, e + 1), np.float32) for _ in range(len(db))] for _ in db.classes]
    for i, entry in enumerate(db.roidb):
        gt = entry["boxes"][rng.uniform(size=len(entry["boxes"])) < 0.85].copy()
        gt[:, :2] += rng.normal(0, 0.15, (len(gt), 2))
        fp = gt[:1].copy() if len(gt) else np.zeros((0, e), np.float32)
        fp[:, :2] += 6.0
        boxes = np.vstack([gt, fp, gt[:1]])  # and a duplicate
        out[1][i] = np.hstack([boxes, rng.uniform(0.1, 1, (len(boxes), 1))]).astype(np.float32)
    return out


def _uc(boxes, rng, e, num_classes):
    widths = t_eu.uc_widths(e, num_classes)
    return [[{k: rng.uniform(0, 1, (len(rows), widths[k])).astype(np.float32) for k in UC_KEYS}
             if len(rows) else {} for rows in per_frame] for per_frame in boxes]


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir()) if p.suffix == ".txt"}


# -- eval_utils ------------------------------------------------------------------


def test_eval_utils_uncertainty_surface_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    assert t_eu.UC_ORDER == j_eu.UC_ORDER
    for e, c in ((4, 2), (7, 2), (7, 4)):
        assert t_eu.uc_widths(e, c) == j_eu.uc_widths(e, c)
        widths = t_eu.uc_widths(e, c)
        for keys in (UC_KEYS, UC_KEYS[:4], UC_KEYS[4:], ()):
            n_trail = sum(widths[k] for k in keys)
            assert t_eu._infer_uc_keys(n_trail, widths) == j_eu._infer_uc_keys(n_trail, widths)
            lines = [[f"{i:06d}", f"{rng.uniform():.6f}"]
                     + [f"{v:.5f}" for v in rng.uniform(size=e + n_trail)] for i in range(9)]
            (tavg, tuc), (javg, juc) = (t_eu.extract_uncertainties(e, lines, c),
                                        j_eu.extract_uncertainties(e, lines, c))
            assert tavg == javg and tuc.keys() == juc.keys()
            for k in juc:
                np.testing.assert_array_equal(tuc[k], juc[k])
            for i in range(9):
                t_eu.accumulate_scene_uncertainty(tavg, tuc, i, i % 3)
                j_eu.accumulate_scene_uncertainty(javg, juc, i, i % 3)
            for s in range(3):
                assert t_eu.write_scene_uncertainty(tavg, 3, s) == \
                    j_eu.write_scene_uncertainty(javg, 3, s)
                assert t_eu.write_frame_uncertainty(tavg, 3, s) == \
                    j_eu.write_frame_uncertainty(javg, 3, s)
    with pytest.raises(ValueError):
        t_eu._infer_uc_keys(5, t_eu.uc_widths(7, 2))
    counts = ({"a": 1, "b": 0}, {"a": 2}, {"a": 3, "b": 1})
    assert _quiet(t_eu.display_frame_counts, *counts) == _quiet(j_eu.display_frame_counts, *counts)
    recs = [{"frame_id": "1"}, {"idx": "2"}]
    for token in ("1", "2", "3"):
        assert t_eu.find_rec(recs, token) == j_eu.find_rec(recs, token)
    assert t_eu.find_rec({"x": 1}, "x") == j_eu.find_rec({"x": 1}, "x")
    a = t_eu.save_detection_results(["x 1", 2], str(tmp_path / "t"), "r.txt")
    b = j_eu.save_detection_results(["x 1", 2], str(tmp_path / "j"), "r.txt")
    assert Path(a).read_bytes() == Path(b).read_bytes()
    res = [{"recall": np.arange(3.0), "precision": np.ones(3), "ap": 0.5}]
    a = t_eu.write_pr_pickle(str(tmp_path / "t"), "car", res)
    b = j_eu.write_pr_pickle(str(tmp_path / "j"), "car", res)
    assert Path(a).read_bytes() == Path(b).read_bytes()


@pytest.mark.parametrize("net_type", ["lidar", "image"])
def test_labels_filename_equals_jax(tmp_path, net_type):
    root = _waymo_tree(tmp_path)
    jdb, tdb = _dbs("waymo", root, "train", "NET_TYPE", net_type)
    for eval_type in ("2d", "bev", "3d"):
        got = t_eu.get_labels_filename(tdb, eval_type)
        assert got == j_eu.get_labels_filename(jdb, eval_type)


# -- result files ------------------------------------------------------------------


@pytest.mark.parametrize("with_uc", [False, True])
@pytest.mark.parametrize("net_type", ["lidar", "image"])
def test_result_files_byte_identical(tmp_path, net_type, with_uc):
    root = _kitti_tree(tmp_path)
    jdb, tdb = _dbs("kitti", root, "val", "NET_TYPE", net_type)
    lidar = net_type == "lidar"
    rng = np.random.RandomState(1)
    boxes = _detections(jdb, rng, lidar)
    uc = _uc(boxes, rng, 7 if lidar else 4, 2) if with_uc else None
    ids = [e["frame_id"] for e in jdb.roidb]
    write = "write_lidar_results" if lidar else "write_image_results"
    getattr(tdb, write)(boxes, ids, str(tmp_path / "t"), uncertainties=uc)
    getattr(jdb, write)(boxes, ids, str(tmp_path / "j"), uncertainties=uc)
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert got == want and got["det_val_car.txt"]


# -- evaluate_detections ---------------------------------------------------------------


def _gt_by_class(db, n):
    out = {1: {}}
    for e in db.roidb[:n]:
        out[1][e["frame_id"]] = {"boxes": e["boxes"], "difficulty": e["difficulty"]}
    return out


def _dets_by_class(db, boxes):
    e = boxes[1][0].shape[1] - 1
    return {1: [{"frame_id": db.roidb[i]["frame_id"], "bbox": row[:e].copy(),
                 "confidence": row[-1]} for i, rows in enumerate(boxes[1]) for row in rows]}


@pytest.mark.parametrize("name,net_type", [("kitti", "lidar"), ("kitti", "image"),
                                           ("waymo", "lidar")])
def test_evaluate_detections_equals_jax(tmp_path, name, net_type):
    root = _kitti_tree(tmp_path) if name == "kitti" else _waymo_tree(tmp_path)
    overrides = ("NET_TYPE", net_type, "LIDAR.EVAL_TYPE", "bev")
    jdb, tdb = _dbs(name, root, "val" if name == "kitti" else "train", *overrides)
    boxes = _detections(jdb, np.random.RandomState(2), net_type == "lidar")
    dets, gt = _dets_by_class(jdb, boxes), _gt_by_class(jdb, len(jdb))
    got, tout = _quiet(tdb.evaluate_detections, dets, gt, str(tmp_path / "t"))
    want, jout = _quiet(jdb.evaluate_detections, dets, gt, str(tmp_path / "j"))
    assert got == want and tout == jout
    levels = ("easy", "moderate", "hard") if name == "kitti" else ("L1", "L2")
    assert sorted(k[1] for k in got) == sorted(levels)
    assert len({v for v in got.values()}) > 1 or name == "kitti"  # L1 and L2 differ
    cls = jdb.classes[1]
    assert (tmp_path / "t" / f"{cls}_pr.pkl").read_bytes() == \
        (tmp_path / "j" / f"{cls}_pr.pkl").read_bytes()


# -- inference.evaluate_roidb (tools/test_net_torch.py on a real database) -----------


@pytest.mark.parametrize("with_uc", [False, True])
def test_evaluate_roidb_equals_jax_methods(tmp_path, with_uc):
    root = _waymo_tree(tmp_path)
    sets = ("NET_TYPE", "lidar", "TRAIN.SCALES", "(0.5,)", "TEST.SCALES", "(0.5,)",
            "LIDAR.EVAL_TYPE", "bev")
    jdb, tdb = _dbs("waymo", root, "train", *sets)
    n = len(jdb)
    rng = np.random.RandomState(3)
    meters = _detections(jdb, rng, True)
    # the detector's output lives on the 0.5-scale voxel grid: the port
    # converts it back to meters
    grid = [[tdb._boxes_pc_to_voxel_grid(rows[:, :7], 0.5) for rows in per] for per in meters]
    net = [[np.hstack([g, rows[:, 7:]]) for g, rows in zip(gp, mp)] for gp, mp in zip(grid, meters)]
    uc = _uc(net, rng, 7, 2) if with_uc else [[{} for _ in range(n)] for _ in range(2)]
    got, _ = _quiet(evaluate_roidb, tdb, tdb.cfg, net, uc, n, str(tmp_path / "t"), True)

    # JAX: the same conversion and writers, then its evaluation
    conv = [[np.zeros((0, 8), np.float32) for _ in range(n)]] + [[
        np.hstack([jdb.boxes_voxel_grid_to_pc(rows[:, :7], 0.5), rows[:, 7:]]).astype(np.float32)
        for rows in net[1]]]
    ids = [e["frame_id"] for e in jdb.roidb]
    jdb.write_lidar_results(conv, ids, str(tmp_path / "j"), uncertainties=uc if with_uc else None)
    gt = {1: {e["frame_id"]: {"boxes": e["boxes"], "difficulty": e["difficulty"]}
              for e in jdb.roidb}}
    want, _ = _quiet(jdb.evaluate_detections, _dets_by_class(jdb, conv), gt, str(tmp_path / "j"))
    assert got == want
    with open(tmp_path / "t" / "detections.pkl", "rb") as f:
        pkl = pickle.load(f)
    for g, w in zip(pkl[1], conv[1]):
        np.testing.assert_array_equal(g, w)
    t_files = _files(tmp_path / "t")
    assert ("vehicle.car_scene_uncertainty_results.txt" in t_files) == with_uc
    t_files.pop("vehicle.car_scene_uncertainty_results.txt", None)
    assert t_files == _files(tmp_path / "j")
    if with_uc:
        with open(tmp_path / "j" / "det_train_vehicle.car.txt") as f:
            lines = [line.strip().split(" ") for line in f if line.strip()]
        avg, per_det = j_eu.extract_uncertainties(7, lines, num_classes=2)
        scene = {e["frame_id"]: e["scene_idx"] for e in jdb.roidb}
        cnt = {}
        for i, toks in enumerate(lines):
            j_eu.accumulate_scene_uncertainty(avg, per_det, i, scene[toks[0]])
            cnt[scene[toks[0]]] = cnt.get(scene[toks[0]], 0) + 1
        want_lines = [j_eu.write_scene_uncertainty(avg, cnt[s], s) for s in sorted(cnt)]
        got_text = (tmp_path / "t" / "vehicle.car_scene_uncertainty_results.txt").read_text()
        assert got_text == "".join(line + "\n" for line in want_lines if line)


# -- the CLIs on the KITTI fixture ---------------------------------------------------


def _tool(name):
    path = REPO / "tools" / name
    spec = importlib.util.spec_from_file_location(f"tool_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_kitti_cli_trains_and_evaluates(tmp_path, monkeypatch):
    """2 res18 steps on the KITTI fixture (LiDAR, augmentation on, a 100 x
    87 raster at scale 0.125), then --eval_det on the last snapshot."""
    import torch

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    root = _kitti_tree(tmp_path)
    common = ["--db", "kitti", "--data_dir", root, "--cache_dir", os.path.join(root, "ct"),
              "--net", "res18", "--net_type", "lidar", "--scale", "0.125", "--device", "cpu",
              "--out_dir", str(tmp_path / "out")]
    sets = ["COMPUTE_DTYPE", "float32", "STATIC.MAX_POINTS", "1024", "STATIC.MAX_GT", "8",
            "STATIC.NMS_PRE_TRAIN", "256", "TRAIN.RPN_POST_NMS_TOP_N", "64",
            "TRAIN.ROI_BATCH_SIZE", "32", "STATIC.NMS_PRE_TEST", "256",
            "TEST.RPN_POST_NMS_TOP_N", "32", "LIDAR.EVAL_TYPE", "bev"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res, _ = _quiet(_tool("trainval_net_torch.py").main,
                        common + ["--iters", "2", "--batch_size", "2", "--set"] + sets)
        assert res["step"] == 2 and all(np.isfinite(v) for h in res["history"]
                                        for v in h.values())
        snap = tmp_path / "out" / "lidar" / "kitti_lidar_train" / "checkpoints" / "iter_2"
        assert snap.exists()
        got, out = _quiet(_tool("test_net_torch.py").main,
                          common + ["--weights_file", str(snap), "--eval_det", "1", "--thresh",
                                    "0.0", "--batch_size", "2", "--set"] + sets)
    finally:
        torch.set_num_threads(threads)
    ev = tmp_path / "out" / "eval" / "kitti_lidar_val"
    assert (ev / "det_val_car.txt").exists() and (ev / "detections.pkl").exists()
    assert (ev / "car_pr.pkl").exists()
    assert sorted(got) == [("car", "easy"), ("car", "hard"), ("car", "moderate")]
    for level in ("easy", "moderate", "hard"):
        assert f"car {level} AP(bev@0.7)" in out
