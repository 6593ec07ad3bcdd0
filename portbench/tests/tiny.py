"""Tiny cells for the CPU tests: res18 on 64 x 96 frames or 100 x 87 BEV
rasters, two frames a batch, in a benchmark root of their own (its own
BENCHMARK.json, configuration, traffic and limits files beside a copy of the
metric readers), so that a test drives the harness exactly as a run does
without the card."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench import cells, harness

REPO = cells.ROOT
BASE = ["NET_VARIANT", "res18", "COMPUTE_DTYPE", "bfloat16", "RESNET.FIXED_BLOCKS", "1",
        "TRAIN.ROI_BATCH_SIZE", "32", "TRAIN.RPN_POST_NMS_TOP_N", "64",
        "STATIC.NMS_PRE_TRAIN", "256", "STATIC.NMS_PRE_TEST", "128",
        "TEST.RPN_POST_NMS_TOP_N", "32", "STATIC.MAX_GT", "8", "TRAIN.RPN_BATCHSIZE", "64"]
CONFIGS = {
    "tiny_image": {"num_classes": 2, "frame_hw": [64, 96],
                   "overrides": ["NET_TYPE", "image", "PIXEL_STDDEVS", "[60.,60.,60.]"] + BASE},
    "tiny_bev": {"num_classes": 2,
                 "overrides": ["NET_TYPE", "lidar", "TRAIN.SCALES", "(0.125,)",
                               "TEST.SCALES", "(0.125,)", "STATIC.MAX_POINTS", "4000",
                               "TEST.ROTATED_NMS", "True", "TEST.NMS_THRESH", "0.3"] + BASE},
}
TRAFFIC = {"batch": 2, "pool": 3, "trace_steps": 2, "trace_after_s": 0.0,
           "image": {"gt": [1, 8], "gt_side": [8, 40]},
           "lidar": {"points": [3000, 4000], "gt": [1, 8]}}
SERVE_TRAFFIC = dict(TRAFFIC, path="serve", warmup=1, samples=2, sample_from=3)
CELLS = {"tiny_image_train": ("tiny_image", "tiny_train"),
         "tiny_bev_train": ("tiny_bev", "tiny_train"),
         "tiny_image_serve": ("tiny_image", "tiny_serve"),
         "tiny_bev_serve": ("tiny_bev", "tiny_serve")}
# between the program's readings at these sizes on the CPU (seeds 11,
# 22222222222, 3333, 44444444444) and the fp8 control's (seeds 55, 666666666666,
# 7777); the proposal layer's choice and the filtered detections are compared
# exactly
LIMITS = {
    "tiny_image_train": {"loss_gap": 2e-3, "grad_gap": 0.025, "update_gap": 0.016,
                         "update1_gap": 0.025, "rpn_gap": 3e-3, "nms_miss": 0.0},
    "tiny_bev_train": {"loss_gap": 5e-5, "grad_gap": 8e-3, "update_gap": 6e-3, "update1_gap": 8e-3,
                       "rpn_gap": 1.2e-4, "nms_miss": 0.0, "raster_gap": 1e-5},
    "tiny_image_serve": {"prob_gap": 3e-3, "box_gap": 1.2e-4, "rpn_gap": 3e-3, "roi_gap": 6e-3,
                         "nms_miss": 0.0, "filter_miss": 0.0},
    "tiny_bev_serve": {"prob_gap": 1e-4, "box_gap": 4e-5, "rpn_gap": 1e-4, "roi_gap": 3e-4,
                       "nms_miss": 0.0, "filter_miss": 0.0, "raster_gap": 1e-5},
}
CONTROL_SEEDS = (55, 666666666666, 7777)


def build(root: Path, limits=None) -> Path:
    """A benchmark root at `root` holding the four tiny cells."""
    pb = root / "portbench"
    for sub in ("traffic", "limits", "configs", "metrics"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for f in (REPO / "portbench" / "metrics").glob("*.py"):
        shutil.copy(f, pb / "metrics" / f.name)
    for name, cfg in CONFIGS.items():
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "tiny_train.json").write_text(json.dumps(dict(TRAFFIC, path="train")))
    (pb / "traffic" / "tiny_serve.json").write_text(json.dumps(SERVE_TRAFFIC))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "tiny", "file": f"portbench/configs/{n}.json",
                         "reduced": [], "why": "CPU tests"} for n in CONFIGS]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "CPU tests"}
                          for n, (c, t) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            path = "train" if m["name"].endswith(("train", "train_frames_per_s")) else "serve"
            m["workloads"] = [n for n, (_, t) in CELLS.items() if t.endswith(path)]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    for n, lim in (limits or LIMITS).items():
        (pb / "limits" / f"{n}.json").write_text(json.dumps(lim))
    return root


def run(root: Path, name: str, seed: int = 20260417123, seconds: float = 1.0,
        traced: bool = False) -> dict:
    """One CPU run of a tiny cell through the harness."""
    return harness.run_cell(cells.load_cell(name, root), seed, seconds, traced, "cpu",
                            time.time(), root)
