"""The port's tracing spans (utils/timer.py `span`) on the CPU at res18,
bfloat16 compute, 64 x 96 frames (or 100 x 88 x 15 BEV rasters), batch 2:

* with no profiler running `span` is one shared no-op and records nothing;
* under torch.profiler a training step (`training.solver.train`) and a
  served batch (`inference.detect_batch` + `filter_batch`) record the span
  tree of their layers, every child inside its parent, the same names as
  the profiler's CPU events, on the profiler's clock; `train.step` closes
  before `on_step` runs;
* losses, parameters after the step and detections are bit-identical with
  the profiler on and off;
* the benchmark's rebinding of `models.detector.propose` still sees every
  call inside `det.proposals`;
* the benchmark's `host_ms_per_frame` reader on hand-made records.
"""

from __future__ import annotations

import copy
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config
from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
from faster_rcnn_pytorch_multimodal_tpu_torch.inference import detect_batch, filter_batch
from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import to_device
from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver
from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD
from faster_rcnn_pytorch_multimodal_tpu_torch.utils import timer
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import Span, span, spans
from portbench import harness
from portbench.metrics import host_ms_per_frame
from tests.torch_port_threads import pinned, two_threads  # noqa: F401

B, H, W, K, G = 2, 64, 96, 2, 8
SMALL = ("NET_VARIANT", "res18", "COMPUTE_DTYPE", "bfloat16", "RESNET.FIXED_BLOCKS", "1",
         "STATIC.NMS_PRE_TRAIN", "256", "TRAIN.RPN_POST_NMS_TOP_N", "64",
         "TRAIN.ROI_BATCH_SIZE", "32", "STATIC.MAX_GT", str(G), "STATIC.NMS_PRE_TEST", "256",
         "TEST.RPN_POST_NMS_TOP_N", "32")
KINDS = {
    "image": ("NET_TYPE", "image") + SMALL,
    "lidar": ("NET_TYPE", "lidar", "TRAIN.SCALES", "(0.25,)", "TEST.SCALES", "(0.25,)",
              "STATIC.MAX_POINTS", "4096") + SMALL,
}
# (parent, child) pairs every step or batch records, None for a root; then
# what each kind adds: the uint8 frames' normalization, a BEV loader's
# raster in next() and its timer (`last_raster_ms`), the 7-DoF box loss
DET = {("det.backbone", "det.block"), ("det.roi_head", "det.block"),
       ("det.rpn", "sync.anchor_target"), ("det.roi_targets", "sync.roi_norm")}
TRAIN_TREE = DET | {
    (None, "train.step"), ("train.step", "train.data"), ("train.step", "train.h2d"),
    ("train.step", "train.draws"), ("train.step", "train.forward"),
    ("train.forward", "train.cast"), ("train.forward", "train.functional_call"),
    ("train.functional_call", "det.backbone"), ("train.functional_call", "det.rpn"),
    ("train.functional_call", "det.proposals"), ("train.functional_call", "det.roi_targets"),
    ("train.functional_call", "det.roi_head"), ("train.step", "train.backward"),
    ("train.step", "train.optimizer"), ("train.optimizer", "sync.clip_norm"),
    ("train.step", "sync.timer"), ("train.step", "sync.losses"),
}
SERVE_TREE = {
    (None, "serve.detect"), ("serve.detect", "serve.h2d"), ("serve.detect", "serve.eval_mode"),
    ("serve.detect", "det.backbone"), ("serve.detect", "det.rpn"),
    ("serve.detect", "det.proposals"), ("serve.detect", "det.roi_head"),
    ("det.backbone", "det.block"), ("det.roi_head", "det.block"),
    ("det.roi_head", "sync.box_norm"), (None, "serve.filter"),
}
KIND_TREE = {
    ("image", "train"): {("det.backbone", "sync.pixel_norm")},
    ("image", "serve"): {("det.backbone", "sync.pixel_norm")},
    ("lidar", "train"): {("train.data", "ops.voxelize"), ("train.data", "sync.timer"),
                         ("det.roi_head", "sync.loss_weight")},
    ("lidar", "serve"): {(None, "ops.voxelize"), (None, "sync.timer")},
}


def _cfg(kind):
    return t_config.cfg_from_list(t_config.default_config(), KINDS[kind])


@pytest.fixture(scope="module")
def state():
    """Per kind: the config and a float32 training model made once."""
    out = {}
    for kind in KINDS:
        cfg = _cfg(kind)
        model, _ = solver.create_train_state(cfg, K, "cpu", seed=0)
        with torch.no_grad():
            for name, m in model.named_modules():
                if name.endswith(".bn2"):  # res18's terminators: keep random weights finite
                    m.weight.fill_(0.25)
        out[kind] = (cfg, model)
    return out


def _loader(cfg):
    ds = SyntheticDataset(cfg, num_frames=B, num_classes=K, image_hw=(H, W), mode="train", seed=3)
    return BatchLoader(ds, cfg, batch_size=B, device="cpu", augment=False, shuffle=False, seed=0)


def _train_once(state, kind, on_step=None):
    """One step of a copy of the made model: (losses, parameters after it)."""
    cfg, model = state[kind]
    model = copy.deepcopy(model)
    with pinned(1):
        res = solver.train(model, DetectorSGD(model, cfg), _loader(cfg), 1,
                           torch.Generator().manual_seed(5), on_step=on_step)
    return res["losses"][0], {k: p.detach().clone() for k, p in model.named_parameters()}


def _serve_once(state, kind):
    """One batch: the loader (a BEV raster made there), detect, filter."""
    cfg, model = state[kind]
    model = to_device(copy.deepcopy(model), "cpu")
    with pinned(1):
        batch = _loader(cfg).next()
        out = detect_batch(model, batch)
        return out, filter_batch(model, out, 0.0)


def _profiled(fn):
    timer.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    return result, spans(), prof


def _pairs(recs):
    return {(None if r.parent is None else recs[r.parent].name, r.name) for r in recs}


def _check_nesting(recs, prof):
    """Every record closed, inside its parent, on its root, on one thread;
    each name the profiler's CPU events hold as often, at the same time on
    the profiler's clock."""
    for i, r in enumerate(recs):
        assert r.end_ns is not None and r.start_ns <= r.end_ns, r
        if r.parent is None:
            assert r.root == i
        else:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (p, r)
            assert r.root == p.root and r.thread == p.thread
    events = [e for e in prof.events() if e.device_type.name == "CPU"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    for name in {r.name for r in recs}:
        evs = sorted((e for e in events if e.name == name), key=lambda e: e.time_range.start)
        mine = [r for r in recs if r.name == name]
        assert len(evs) == len(mine), name
        for e, r in zip(evs, sorted(mine, key=lambda r: r.start_ns)):
            assert abs(t0 + e.time_range.start * 1e3 - r.start_ns) < 5e6, name


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_no_profiler_no_spans(state, kind):
    """Without a profiler: the one shared no-op context, and a training step
    and a served batch record nothing."""
    assert span("train.step") is span("det.block") is timer._OFF
    timer.reset_spans()
    _train_once(state, kind)
    _serve_once(state, kind)
    assert spans() == []


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_train_step_span_tree(state, kind):
    seen = {}

    def on_step(i, losses, ms):
        seen["step"] = [r for r in spans() if r.name == "train.step"]

    _, recs, prof = _profiled(lambda: _train_once(state, kind, on_step))
    _check_nesting(recs, prof)
    assert _pairs(recs) == TRAIN_TREE | KIND_TREE[kind, "train"]
    assert [r.name for r in recs if r.parent is None] == ["train.step"]
    assert len(seen["step"]) == 1 and seen["step"][0].end_ns is not None
    assert sum(r.name == "det.block" for r in recs) == 6 + 2  # res18's layer1..3, layer4


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_serve_batch_span_tree(state, kind):
    _, recs, prof = _profiled(lambda: _serve_once(state, kind))
    _check_nesting(recs, prof)
    assert _pairs(recs) == SERVE_TREE | KIND_TREE[kind, "serve"]
    lidar = ["ops.voxelize", "sync.timer"] if kind == "lidar" else []
    assert [r.name for r in recs if r.parent is None] == lidar + ["serve.detect", "serve.filter"]


@pytest.mark.parametrize("path", ["train", "serve"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_outputs_bit_identical_with_tracing(state, kind, path):
    run = (lambda: _train_once(state, kind)) if path == "train" else (
        lambda: _serve_once(state, kind))
    off = run()
    on, recs, _ = _profiled(run)
    assert recs
    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("path", ["train", "serve"])
def test_recording_proposals_sees_every_call(state, path):
    """portbench's harness rebinds models.detector.propose: under the
    profiler, with det.proposals open around it, it sees each call."""
    into = []
    run = (lambda: _train_once(state, "image")) if path == "train" else (
        lambda: _serve_once(state, "image"))
    with harness.recording_proposals(into):
        _, recs, _ = _profiled(run)
    n = sum(r.name == "det.proposals" for r in recs)
    assert n == 1 and len(into) == n
    assert into[0]["rois"].shape[0] == B


def _rec(name, parent, thread, start, end, root):
    return Span(name, parent, thread, start, end, root)


# hand-made records (ns): a step 0-10 ms with a 3 ms sync and a 1 ms sync
# nested in another sync; another thread's 5 ms root; a batch 20-24 ms with
# a 0.5 ms sync; an open root with its closed child
MAIN = threading.main_thread().ident
OTHER = MAIN + 1
RECORDS = [
    _rec("train.step", None, MAIN, 0, 10_000_000, 0),
    _rec("train.forward", 0, MAIN, 1_000_000, 5_000_000, 0),
    _rec("sync.timer", 0, MAIN, 6_000_000, 9_000_000, 0),
    _rec("sync.inner", 2, MAIN, 7_000_000, 8_000_000, 0),
    _rec("ops.voxelize", None, OTHER, 0, 5_000_000, 4),
    _rec("serve.detect", None, MAIN, 20_000_000, 24_000_000, 5),
    _rec("sync.losses", 5, MAIN, 23_000_000, 23_500_000, 5),
    _rec("train.step", None, MAIN, 30_000_000, None, 7),
    _rec("sync.timer", 7, MAIN, 31_000_000, 32_000_000, 7),
]
OPEN = [_rec("train.step", None, MAIN, 0, None, 0), _rec("sync.timer", 0, MAIN, 1, 2, 0)]
ELSEWHERE = [_rec("ops.voxelize", None, OTHER, 0, 5_000_000, 0)]


@pytest.mark.parametrize("records, frames, want, other_ms", [
    (RECORDS, 4, ((10 - 3) + (4 - 0.5)) / 4, 5.0),
    (RECORDS[:4], 2, 3.5, None),
    (ELSEWHERE, 4, None, 5.0),
    (OPEN, 4, None, None),
    ([], 4, None, None),
])
def test_host_ms_per_frame_reader(monkeypatch, records, frames, want, other_ms):
    """The main thread's closed roots less their outermost syncs, a frame;
    another thread's spans and an open root left out; None with no root."""
    monkeypatch.setattr(timer, "spans", lambda: list(records))
    got = host_ms_per_frame.read({"frames": frames})
    assert got == (None if want is None else pytest.approx(want))
    assert host_ms_per_frame.host_ms(records, OTHER) == other_ms
