"""The harness on the CPU: cells, configurations and metrics found by name,
the result line's keys, BENCHMARK.json's names and units, and the frozen
arithmetic (model FLOPs against torch's FlopCounterMode, RoI align's bytes
by hand)."""

import json
import re
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import cells, traffic, yardstick
from portbench.reference.config import reference_config
from portbench.reference.model import Detector, make_weights
from portbench.tests import tiny

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CONTRACT_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                 "per_layer"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("tiny"))


def test_added_files_are_found_by_name(root):
    """A new cell, configuration, traffic mix, limits file and metric reader,
    added as files and entries, run with no edit to the harness."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = dict(tiny.CONFIGS["tiny_image"], frame_hw=[32, 48])
    (root / "portbench/configs/added.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "added_cfg", "source": "tiny",
                             "file": "portbench/configs/added.json", "reduced": [], "why": "x"})
    (root / "portbench/traffic/added_mix.json").write_text(json.dumps(tiny.SERVE_TRAFFIC))
    bench["workloads"].append({"name": "added_cell", "config": "added_cfg",
                               "traffic": "added_mix", "chips": 1, "why": "x"})
    (root / "portbench/limits/added_cell.json").write_text(
        json.dumps(tiny.LIMITS["tiny_image_serve"]))
    (root / "portbench/metrics/frames_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['frames'])\n")
    bench["per_layer"].append({"name": "frames_seen.serve", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "serve_frames_per_s", "workloads": ["added_cell"]})
    for m in bench["end_to_end"]:
        if m.get("workloads") and "tiny_image_serve" in m["workloads"]:
            m["workloads"].append("added_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load_cell("added_cell", root)
    assert cell.traffic["path"] == "serve" and cell.config["frame_hw"] == [32, 48]
    assert "frames_seen.serve" in [m["name"] for m in cell.per_layer]
    assert cells.reader("frames_seen.serve", root)({"frames": 3}) == 3.0
    res = tiny.run(root, "added_cell", seconds=0.3, traced=True)
    assert res["metrics"]["frames_seen.serve"] == {"value": 4.0, "unit": "frames"}


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contract_keys(root, traced):
    res = tiny.run(root, "tiny_image_train", seconds=0.3, traced=traced)
    keys = ["correct", "attempted", "failed", "metrics"] + (["breakdown"] if traced else [])
    assert list(res) == keys + ["device", "checks"]
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"train_frames_per_s", "peak_mem_gib", "setup_s"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


def test_benchmark_json_names_and_units():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == CONTRACT_KEYS
    assert 1 <= bench["run_seconds"] <= 51
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in bench["workloads"]] + [
            w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and all(m["source"] in ("host_clock", "device_trace")
                                    for m in e2e.values())
    assert all(0.0 < m["bound"] <= 0.25 for m in e2e.values())
    for w in bench["workloads"]:
        reported = {n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        layer = [m for m in bench["per_layer"] if w["name"] in m["workloads"]]
        assert "setup_s" in reported and len(reported) >= 2 and layer, w["name"]
        assert all(m["moves"] in reported for m in layer), w["name"]
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench/limits" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert cells.reader(m["name"]) is not None, m["name"]


@pytest.mark.parametrize("train", [False, True])
def test_model_flops_equal_the_flop_counter(train):
    """yardstick.model_flops at a tiny res18 against FlopCounterMode over the
    plain reference's forward (and backward) on the same shapes."""
    rcfg = reference_config(tiny.CONFIGS["tiny_image"]["overrides"])
    det = Detector(rcfg, 2, "cpu")
    P = make_weights(det.arch, 5, "cpu")
    b, hw = 2, (64, 96)
    pool = traffic.make_pool(dict(tiny.TRAFFIC, path="train"),
                                  {"kind": "image", "max_gt": 8, "frame_hw": list(hw)}, 5, "cpu",
                                  pin=False)[0]
    batch = (pool["data"], pool["gt_boxes"], pool["gt_mask"], pool["window"])
    with FlopCounterMode(display=False) as counter:
        if train:
            for k, spec in zip(P, det.arch.specs):
                P[k].requires_grad_(spec.trainable)
            d = det.draws(torch.Generator().manual_seed(1), b, hw)
            losses, _ = det.train_losses(P, batch, d)
            losses["total_loss"].backward()
            rois = rcfg["TRAIN.ROI_BATCH_SIZE"]
        else:
            with torch.no_grad():
                det.serve(P, pool["data"], pool["window"])
            rois = rcfg["TEST.RPN_POST_NMS_TOP_N"]
    want = b * yardstick.model_flops(det.arch, hw, rois, rcfg["POOLING_SIZE"], train)
    assert counter.get_total_flops() == want


def test_roi_align_bytes_by_hand():
    # 2 frames of 4 x 5 x 8 bf16 maps, 3 RoIs a frame pooled 7 x 7: read the maps
    # (2*4*5*8 = 320 elements), write 2*3*49*8 = 2352 elements, 2 bytes each
    nbytes = (320 + 2352) * 2
    flops = 2352 * 2 * 2 * 4 * 2
    want = max(nbytes / 3.35e12, flops / 67e12) * 1e3
    got = yardstick.roi_align_bound_ms(2, 4, 5, 8, 3, 7, 2)
    assert got == pytest.approx(want, rel=1e-12)
    assert yardstick.bound_ms(nbytes, flops)[1] == "bytes"


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"), "--workload",
                          "image_serve_b16", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"), "--workload",
                          "image_serve_b16", "--seed", "4294967311", "--seconds", "3"],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
