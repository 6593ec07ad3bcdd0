"""tools/quality_run_torch.py, the port's quality harness, against
tools/quality_run.py on the CPU: every leg's config field by field, the
suite's legs, the false-positive taxonomy, the uncertainty separation
statistics (uc_stats), and a 2-iteration image leg, BEV leg and --uc leg at
a tiny size that write the JSON of QUALITY_r5.json's legs."""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
pytest.importorskip("jax")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import quality_run  # noqa: E402
import quality_run_torch  # noqa: E402
import quality_summary  # noqa: E402

from tests.test_quality_tools import _iou2d  # noqa: E402

QUALITY = os.path.join(os.path.dirname(__file__), "..", "QUALITY_r5.json")


def _jax_suite(tmp_path, monkeypatch):
    """tools/quality_run.py's suite: (name, argv) of every leg, in order."""
    ran = []

    def record(argv, tmp):
        ran.append(list(argv))
        with open(tmp, "w") as f:
            json.dump({"final": {"map": 0.0, "map_bev": 0.0}, "mode": argv[1]}, f)
        return 0

    monkeypatch.setattr(quality_run, "_spawn_leg", record)
    out = quality_run.emit_suite(str(tmp_path / "suite.json"))
    assert len(out) == len(ran)
    return list(zip(out, ran))


def test_suite_is_the_jax_suite(tmp_path, monkeypatch):
    assert [(n, a) for n, a in quality_run_torch.SUITE] == _jax_suite(tmp_path, monkeypatch)


def _leg_cfgs(argv):
    """(JAX config, port config) of a leg: build_cfg, then the flags run_one
    applies, in tools/quality_run.py's order."""
    from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list

    args = quality_run.build_parser().parse_args(argv)
    targs = quality_run_torch.build_parser().parse_args(argv)
    assert {k: v for k, v in vars(targs).items() if k in vars(args)} == vars(args)
    want = quality_run.build_cfg(args.mode, args.net, args.lr, args.overfit, args.stepsize,
                                 fpn=args.fpn, uc=args.uc)
    for flag, keys in ((args.rpn_pos, ("TRAIN.RPN_POSITIVE_OVERLAP",)),
                       (args.rpn_neg, ("TRAIN.RPN_NEGATIVE_OVERLAP",))):
        if flag is not None:
            want = cfg_from_list(want, (keys[0], str(flag)))
    if args.rotated_nms:
        want = cfg_from_list(want, ("TEST.ROTATED_NMS", "True", "TEST.NMS_THRESH", "0.3"))
    return want, quality_run_torch.leg_config(targs)


@pytest.mark.parametrize("name", [n for n, _ in quality_run_torch.SUITE])
def test_leg_config_equals_the_jax_config(name):
    """Every leg's config, field by field; every leg trains res18 from
    scratch with live BN (FIXED_BLOCKS -1)."""
    argv = dict(quality_run_torch.SUITE)[name]
    want, got = _leg_cfgs(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.net_variant == "res18" and got.resnet.fixed_blocks == -1


def _random_fps(rng, n_frames, n_fps):
    gt = {f"f{i}": {"boxes": np.sort(rng.uniform(0, 200, (rng.randint(0, 4), 4)), axis=1)}
          for i in range(n_frames)}
    fps = []
    for _ in range(n_fps):
        fid = f"f{rng.randint(n_frames + 1)}"  # the last frame id has no GT
        g = gt.get(fid, {"boxes": np.zeros((0, 4))})["boxes"]
        if len(g) and rng.uniform() < 0.6:
            box = g[rng.randint(len(g))] + rng.uniform(-30, 30, 4)
        else:
            box = np.sort(rng.uniform(0, 200, 4))
        fps.append({"frame_id": fid, "bbox": box})
    return fps, gt


def test_fp_taxonomy_equals_the_jax_taxonomy():
    """On tests/test_quality_tools.py's fixtures and on random false
    positives: duplicate, localization and background counts alike."""
    gt_frames = {"f0": {"boxes": np.array([[0.0, 0.0, 99.0, 99.0]])}}
    fps = [
        {"frame_id": "f0", "bbox": np.array([0.0, 0.0, 99.0, 99.0])},
        {"frame_id": "f0", "bbox": np.array([0.0, 0.0, 99.0, 32.0])},
        {"frame_id": "f0", "bbox": np.array([500.0, 500.0, 520.0, 520.0])},
        {"frame_id": "f9", "bbox": np.array([0.0, 0.0, 9.0, 9.0])},
    ]
    empty = {"f0": {"boxes": np.zeros((0, 4))}}
    cases = [(fps, gt_frames), (fps[:1], empty)]
    rng = np.random.RandomState(0)
    cases += [_random_fps(rng, 5, 40) for _ in range(5)]
    for fps_, gt_ in cases:
        want = quality_run.fp_taxonomy(fps_, gt_, _iou2d, thresh=0.5)
        assert quality_run_torch.fp_taxonomy(fps_, gt_, _iou2d, thresh=0.5) == want
    assert quality_run_torch.fp_taxonomy(fps, gt_frames, _iou2d, 0.5) == {
        "duplicate": 1, "localization": 1, "background": 2}


TINY_IMAGE = (
    ["--mode", "image", "--iters", "2", "--eval_every", "1", "--frames", "2", "--batch_size",
     "2", "--image_hw", "128", "192", "--device", "cpu"],
    ["STATIC.NMS_PRE_TRAIN", "256", "TRAIN.RPN_POST_NMS_TOP_N", "64", "TRAIN.ROI_BATCH_SIZE",
     "32", "STATIC.NMS_PRE_TEST", "256", "TEST.RPN_POST_NMS_TOP_N", "32"],
)
TINY_BEV = (
    ["--mode", "bev", "--iters", "2", "--eval_every", "1", "--frames", "2", "--batch_size", "2",
     "--rotated_nms", "--device", "cpu"],
    ["TRAIN.SCALES", "(0.25,)", "TEST.SCALES", "(0.25,)", "STATIC.MAX_POINTS", "4096",
     "TRAIN.ROI_BATCH_SIZE", "32"],
)


@pytest.mark.parametrize("leg", [TINY_IMAGE, TINY_BEV], ids=["image", "bev"])
def test_two_iteration_leg_writes_the_quality_json(tmp_path, leg):
    """A 2-iteration leg on the CPU at a tiny size: the JSON written after
    each eval holds the keys of QUALITY_r5.json's legs and of their curve
    entries (map_bev and tp_bev for BEV), every number in range."""
    flags, sets = leg
    bev = "bev" in flags
    out = str(tmp_path / "leg.json")
    res = quality_run_torch.main(flags + ["--out", out, "--set"] + sets)
    with open(out) as f:
        written = json.load(f)
    with open(QUALITY) as f:
        ref = json.load(f)["bev_overfit" if bev else "image_overfit"]
    assert set(ref) <= set(written)
    assert set(ref["final"]) <= set(written["final"])
    assert [c["iter"] for c in written["curve"]] == [1, 2]
    assert written["final"] == written["curve"][-1] and written["iters"] == 2
    assert written["net"] == "res18" and written["rotated_nms"] == bev
    for c in written["curve"]:
        assert np.isfinite(c["total_loss"]) and 0.0 <= c["map"] <= 1.0
        assert 0.0 <= c["proposal_recall"] <= 1.0
        assert c["fp"] == sum(c["fp_taxonomy"].values())
    assert res["final"] == written["final"]
    _renders(tmp_path, "bev_overfit" if bev else "image_overfit", written)


def _renders(tmp_path, name, leg):
    """tools/quality_summary.py (it imports neither package) renders the
    port's --emit artifact: the summary row and the curve's rows, no dash
    where the JAX artifact has a number (the schemas agree)."""
    import contextlib
    import io

    path = tmp_path / "suite.json"
    path.write_text(json.dumps({name: leg}))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        quality_summary.main(str(path))
    text = out.getvalue()
    row = next(ln for ln in text.splitlines() if ln.startswith(f"| {name} |"))
    assert "(incomplete)" not in row and "—" not in row.split("|")[2]
    assert sum(ln.startswith("| ") and ln.split("|")[1].strip().isdigit()
               for ln in text.splitlines()) == len(leg["curve"])
    return text


def test_uc_leg_runs(tmp_path):
    """The --uc leg (image_uc_scratch), which raised while uncertainty was
    not ported, runs: 2 iterations at a tiny size, T = 2 MC samples, the
    JSON of QUALITY_r5.json's image_uc_scratch leg, every number finite."""
    flags, sets = TINY_IMAGE
    out = str(tmp_path / "uc.json")
    res = quality_run_torch.main(flags + ["--uc", "--out", out, "--set"] + sets
                                 + ["UC.E_NUM_SAMPLE", "2", "UC.A_NUM_CE_SAMPLE", "20"])
    with open(QUALITY) as f:
        ref = json.load(f)["image_uc_scratch"]
    assert set(ref) <= set(res)
    for c in res["curve"]:
        assert np.isfinite(c["total_loss"]) and 0.0 <= c["map"] <= 1.0
        for key, st in c.get("uc_stats", {}).items():
            assert set(st) == set(ref["final"]["uc_stats"][key])
            assert 0.0 <= st["auc_fp_ranked_higher"] <= 1.0
    with open(out) as f:
        leg = json.load(f)
    text = _renders(tmp_path, "image_uc_scratch", leg)
    assert ("uc[" in text) == bool(leg["final"].get("uc_stats"))


def test_uc_separation_is_the_mann_whitney_share():
    """uc_stats on random detections: the TP and FP means and the share of
    (FP, TP) pairs with the FP higher, ties counted half, per key; a key
    without rows, or a side without detections, is left out."""
    rng = np.random.RandomState(3)
    dets = [{"a_entropy": float(rng.choice([0.1, 0.5, 0.9])), "e_mutual_info": float(rng.rand())}
            for _ in range(50)]
    fps = dets[::3]
    got = quality_run_torch.uc_separation(dets, fps)
    for key in quality_run_torch.UC_KEYS:
        fp = np.array([d[key] for d in fps])
        tp = np.array([d[key] for i, d in enumerate(dets) if i % 3])
        pairs = [(f > t) + 0.5 * (f == t) for f in fp for t in tp]
        assert got[key] == {"tp_mean": round(float(tp.mean()), 5),
                            "fp_mean": round(float(fp.mean()), 5),
                            "auc_fp_ranked_higher": round(float(np.mean(pairs)), 4)}
    assert quality_run_torch.uc_separation(dets, []) == {}
    assert quality_run_torch.uc_separation([{"confidence": 1.0}], []) == {}
