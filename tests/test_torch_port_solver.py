"""The port's Solver (training/solver.py) and the tools around it, on the
CPU at res18, float32, 128x192 frames (or 200 x 175 x 15 BEV rasters),
batch 2:

* resume: 4 steps uninterrupted against 2 steps, a snapshot, a new Solver
  and 2 more, with the prefetch thread on and the val cycle running
  between steps; every parameter, running statistic, momentum buffer and
  loss bitwise equal, on image with live BN and on BEV.  The CPU's
  multithreaded convolution backward sums in an order that changes from
  run to run, so the tests here take one thread;
* the Solver's own behaviour: keep-last-N, a stop on SIGINT that snapshots
  after the step in flight, a half-written snapshot never picked, the
  RPN-only val cycle's proposal recall;
* preload against JAX's Solver.load_pretrained (the keys replaced in modes
  1 and 2), frozen-BN weights into a live-BN model and the reverse;
* the val cycle against JAX's make_eval_step (losses within rtol 1e-4 on
  the same weights and JAX's draws, the running statistics untouched) and
  make_act_summary_step (within 1e-5 of max);
* host functions against JAX: proposal_recall, the MetricsWriter's JSONL,
  tools/reval_torch.py against tools/reval.py on one detections pickle,
  tools/demo_torch.py against tools/demo.py on the same weights.
"""

from __future__ import annotations

import importlib.util
import io
import json
import os
import re
import signal
import sys
import threading
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list, default_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.evaluation import drawing as j_drawing  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.training import metrics as j_metrics  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.training import solver as j_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.utils import convert as j_convert  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation import drawing as t_drawing  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import metrics as t_metrics  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as t_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    from_flax_variables,
    to_flax_variables,
    torch_key_to_flax_path,
)
from tests.test_torch_port_train import jax_draws  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B, H, W, K, G = 2, 128, 192, 2, 8
SMALL = ("NET_VARIANT", "res18", "COMPUTE_DTYPE", "float32", "STATIC.NMS_PRE_TRAIN", "256",
         "TRAIN.RPN_POST_NMS_TOP_N", "64", "TRAIN.ROI_BATCH_SIZE", "32", "STATIC.MAX_GT", str(G),
         "STATIC.NMS_PRE_TEST", "256", "TEST.RPN_POST_NMS_TOP_N", "32",
         "TRAIN.LEARNING_RATE", "0.001", "TRAIN.SNAPSHOT_ITERS", "2", "TRAIN.DISPLAY", "4",
         "TRAIN.EN_ACT_SUMMARIES", "True")
IMAGE = ("NET_TYPE", "image", "RESNET.FIXED_BLOCKS", "-1") + SMALL
BEV = ("NET_TYPE", "lidar", "TRAIN.SCALES", "(0.25,)", "TEST.SCALES", "(0.25,)",
       "STATIC.MAX_POINTS", "4096") + SMALL


def _tcfg(overrides, *extra):
    return t_config.cfg_from_list(t_config.default_config(), overrides + extra)


def _solver(cfg, out, val=True, seed=0):
    """A Solver on a fresh res18 model (init seed 0) and fresh loaders."""
    lidar = cfg.net_type == "lidar"
    ds = SyntheticDataset(cfg, num_frames=6, num_classes=K, image_hw=(H, W), seed=0)
    loader = BatchLoader(ds, cfg, B, device="cpu", seed=cfg.rng_seed)
    val_loader = None
    if val:
        vds = SyntheticDataset(cfg, num_frames=4, num_classes=K, image_hw=(H, W), seed=101,
                               mode="val")
        val_loader = BatchLoader(vds, cfg, B, device="cpu", augment=False,
                                 seed=cfg.rng_seed + 1)
    model, _ = t_solver.create_train_state(cfg, K, "cpu", seed=seed)
    assert lidar == (cfg.net_type == "lidar")
    return t_solver.Solver(cfg, model, loader, val_loader, output_dir=str(out))


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The MetricsWriters' JSONL logs only: torch.utils.tensorboard pulls in
    TensorFlow where it is installed, tens of seconds a test process."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the resume runs must repeat bit for bit, and
    beside other test processes a thread pool a process oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _momenta(opt: DetectorSGD):
    return [opt.sgd.state[p]["momentum_buffer"] for p in opt.params]


@pytest.mark.parametrize("kind", ["image", "bev"])
def test_resume_is_bitwise_equal_to_an_uninterrupted_run(kind, tmp_path):
    cfg = _tcfg(IMAGE if kind == "image" else BEV)
    whole = _solver(cfg, tmp_path / "whole")
    res = whole.train(4)
    first = _solver(cfg, tmp_path / "resumed").train(2)
    again = _solver(cfg, tmp_path / "resumed")
    assert again.find_previous().endswith("iter_2")
    rest = again.train(4)
    assert (first["step"], rest["step"], res["step"]) == (2, 4, 4)
    assert first["history"] + rest["history"] == res["history"]
    want, got = whole.model.state_dict(), again.model.state_dict()
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)
    if kind == "image":
        assert t_det.live_bn_stats(again.model)  # running statistics among them
    assert again.optimizer.step_count == whole.optimizer.step_count == 4
    assert all(torch.equal(a, b) for a, b in zip(_momenta(whole.optimizer),
                                                   _momenta(again.optimizer)))
    # the logs: train scalars at the display steps and at each run's end,
    # val losses and the activation summaries at the display steps, the val
    # detections drawn
    with open(tmp_path / "resumed" / "tb" / "scalars.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [2, 4]
    with open(tmp_path / "resumed" / "tb_val" / "scalars.jsonl") as f:
        val = [json.loads(line) for line in f]
    assert [v["step"] for v in val] == [4]
    assert {"total_loss", "act_conv0/mean", "act_conv0/std", "act_conv0/absmax"} <= set(val[0])
    assert (tmp_path / "resumed" / "val_draws" / "iter_4" / "det_000.png").is_file()


@pytest.fixture(scope="module")
def image_solver(tmp_path_factory):
    cfg = _tcfg(IMAGE, "TRAIN.SNAPSHOT_KEPT", "2")
    solver = _solver(cfg, tmp_path_factory.mktemp("solver"), val=False)
    solver.optimizer = DetectorSGD(solver.model, cfg)
    return solver


def test_keep_last_n_and_half_written_snapshots(image_solver, monkeypatch):
    """SNAPSHOT_KEPT 2 keeps the two newest; a temporary file of a write cut
    short, and names that are not iter_<n>, are never picked."""
    s = image_solver
    for step in (1, 3, 5, 7, 9):
        s.snapshot(step)
    ckpt = Path(s._ckpt_dir)
    assert sorted(os.listdir(ckpt)) == ["iter_7", "iter_9"]

    def cut_short(obj, f, *a, **kw):
        with open(f, "wb") as fh:
            fh.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(t_solver.torch, "save", cut_short)
    with pytest.raises(OSError):
        s.snapshot(11)
    (ckpt / "iter_12.bak").write_bytes(b"x")
    os.makedirs(ckpt / "iter_x")
    assert not (ckpt / "iter_11").exists()
    assert s.find_previous() == str(ckpt / "iter_9")
    state = torch.load(s.find_previous(), weights_only=True)
    assert state["step"] == 9 and set(state) == {"model", "optimizer", "loader", "step"}


def test_sigint_snapshots_after_the_step_and_stops(tmp_path):
    """SIGINT raised while step 2 draws its batch: the Solver finishes that
    step, snapshots iter_2 (not a SNAPSHOT_ITERS step) and stops; the
    previous handler is back afterwards.  The RPN-only val cycle logs the
    proposal recall."""
    assert threading.current_thread() is threading.main_thread()
    cfg = _tcfg(IMAGE, "TRAIN.SNAPSHOT_ITERS", "100", "TRAIN.DISPLAY", "1",
                "ENABLE_FULL_NET", "False")
    s = _solver(cfg, tmp_path)
    nxt, calls = s.train_loader.next, []

    def next_then_signal():
        calls.append(1)
        if len(calls) == 2:
            signal.raise_signal(signal.SIGINT)
        return nxt()

    s.train_loader.next = next_then_signal
    before = signal.getsignal(signal.SIGINT)
    res = s.train(10)
    assert res["step"] == 2 and len(res["history"]) == 2
    assert os.listdir(tmp_path / "checkpoints") == ["iter_2"]
    assert signal.getsignal(signal.SIGINT) is before
    with open(tmp_path / "tb_val" / "scalars.jsonl") as f:
        val = [json.loads(line) for line in f]
    assert [v["step"] for v in val] == [1, 2]
    assert all(0.0 <= v["rpn_recall"] <= 1.0 for v in val)


# -- against the JAX package ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    """The JAX detector on the port's live-BN res18 init, and a val batch."""
    tcfg = _tcfg(IMAGE)
    port = t_det.init_detector(tcfg, K, seed=0).train()
    rng = np.random.RandomState(0)
    with torch.no_grad():  # running statistics away from their init
        for k, v in t_det.live_bn_stats(port).items():
            v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
                    if k.endswith("var") else
                    torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32)))
    variables = to_flax_variables(port.state_dict(), live_bn=True)
    cfg = cfg_from_list(default_config(), IMAGE)
    model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    vds = SyntheticDataset(tcfg, num_frames=4, num_classes=K, image_hw=(H, W), seed=101,
                           mode="val")
    host = BatchLoader(vds, tcfg, B, device="cpu", augment=False, seed=4).next()
    return tcfg, port, model, variables, host


def _changed_by_jax(variables, model, mode, monkeypatch):
    """The port keys whose leaves JAX's Solver.load_pretrained replaces."""
    marked = jax.tree.map(lambda v: np.asarray(v) + 1.0, variables)
    monkeypatch.setattr(j_convert, "restore_reconciled", lambda path, template: marked)
    state = j_det.TrainState(params=variables, opt_state=None, step=0)
    with redirect_stdout(io.StringIO()):
        new = j_solver.Solver.load_pretrained(None, state, "weights", mode).params
    before, after = from_flax_variables(variables), from_flax_variables(new)
    return {k for k in before if not torch.equal(before[k], after[k])}


@pytest.mark.parametrize("mode", [1, 2])
def test_preload_replaces_jax_scopes(mode, jax_side, tmp_path, monkeypatch):
    tcfg, port, model, variables, _ = jax_side
    want = _changed_by_jax(variables, model, mode, monkeypatch)
    weights = {k: v + 1.0 for k, v in port.state_dict().items()}
    torch.save(weights, tmp_path / "w.pt")
    s = _solver(tcfg, tmp_path, val=False)
    got = set(s.load_pretrained(str(tmp_path / "w.pt"), mode))
    assert got == want
    scopes = {torch_key_to_flax_path(k)[0] for k in got}
    assert scopes == ({"backbone", "tail"} if mode == 1 else
                      {torch_key_to_flax_path(k)[0] for k in port.state_dict()} - {"predictors"})
    sd = s.model.state_dict()
    assert all(torch.equal(sd[k], weights[k]) for k in got)


@pytest.mark.parametrize("direction", ["frozen_into_live", "live_into_frozen"])
def test_preload_across_bn_layouts(direction, tmp_path):
    """Frozen and live BN share their keys: a frozen-BN snapshot preloads
    into a live-BN model (mode 2) with its statistics and affines, and the
    reverse; a missing kept key raises with its name."""
    frozen, live = _tcfg(IMAGE, "RESNET.FIXED_BLOCKS", "1"), _tcfg(IMAGE)
    src_cfg, dst_cfg = (frozen, live) if direction == "frozen_into_live" else (live, frozen)
    src = _solver(src_cfg, tmp_path / "src", val=False, seed=1)
    src.optimizer = DetectorSGD(src.model, src_cfg)
    with torch.no_grad():
        for k, v in src.model.state_dict().items():
            if k.endswith("running_mean"):
                v.add_(0.5)
    path = src.snapshot(3)
    dst = _solver(dst_cfg, tmp_path / "dst", val=False)
    keys = dst.load_pretrained(path, 2)
    want, got = src.model.state_dict(), dst.model.state_dict()
    assert any(k.endswith("running_mean") for k in keys)
    assert all(torch.equal(got[k], want[k]) for k in keys)
    partial = {k: v for k, v in want.items() if k != "backbone.layer1.0.bn1.weight"}
    torch.save(partial, tmp_path / "partial.pt")
    with pytest.raises(ValueError, match="backbone.layer1.0.bn1.weight"):
        dst.load_pretrained(str(tmp_path / "partial.pt"), 1)


def test_val_cycle_matches_jax(jax_side):
    """make_eval_step's losses on JAX's draws within rtol 1e-4 of JAX's
    make_eval_step (batch statistics, nothing updated), the running
    statistics untouched; act_summary within 1e-5 of max of JAX's
    make_act_summary_step (the running statistics)."""
    tcfg, port, model, variables, host = jax_side
    jb = {k: jnp.asarray(host[k]) for k in ("data", "gt_boxes", "gt_mask", "window")}
    params = jax.tree.map(jnp.asarray, variables)
    rng = jax.random.PRNGKey(tcfg.rng_seed)
    want = j_solver.make_eval_step(model)(params, jb, rng)
    want_act = j_solver.make_act_summary_step(model)(params, jb)

    batch = t_solver.batch_to_device(host, torch.device("cpu"))
    n, r = port.train_lane_counts((H, W), G)
    stats = {k: v.clone() for k, v in t_det.live_bn_stats(port).items()}
    got = t_solver.make_eval_step(port)(batch, jax_draws(rng, B, n, r, G))
    assert port.training
    for k in ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box", "total_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert all(torch.equal(v, stats[k]) for k, v in t_det.live_bn_stats(port).items())
    got_act = t_solver.act_summary(port, batch["data"])
    assert got_act.keys() == want_act.keys()
    top = max(abs(float(v)) for v in want_act.values())
    for k in want_act:
        assert abs(float(got_act[k]) - float(want_act[k])) <= 1e-5 * top, k


def test_proposal_recall_equals_jax():
    rng = np.random.RandomState(7)
    xy = rng.uniform(0, 150, (3, 40, 2))
    rois = np.concatenate([xy, xy + rng.uniform(5, 60, (3, 40, 2))], -1).astype(np.float32)
    gt = np.concatenate([rois[:, :6] + rng.uniform(-8, 8, (3, 6, 4)),
                         np.ones((3, 6, 1))], -1).astype(np.float32)
    valid, mask = rng.uniform(size=(3, 40)) < 0.7, rng.uniform(size=(3, 6)) < 0.8
    mask[2] = False
    for t in (0.3, 0.5, 0.7):
        want = j_drawing.proposal_recall(rois, valid, gt, mask, t)
        assert t_drawing.proposal_recall(rois, valid, gt, mask, t) == want
        assert 0 < want[0] <= want[1]


def test_metrics_writer_jsonl_has_jax_keys(tmp_path):
    values = {"total_loss": np.float32(1.5), "rpn_loss_box": 0.25}
    recs = []
    for mod, name in ((j_metrics, "jax"), (t_metrics, "port")):
        w = mod.MetricsWriter(str(tmp_path / name), "val")
        w.scalars(7, values)
        w.close()
        with open(tmp_path / f"{name}_val" / "scalars.jsonl") as f:
            recs.append(json.loads(f.read()))
    assert list(recs[0]) == list(recs[1]) == ["step", "time", "total_loss", "rpn_loss_box"]
    assert {k: v for k, v in recs[1].items() if k != "time"} == {
        k: v for k, v in recs[0].items() if k != "time"}


def _tool(path: Path):
    sys.path.insert(0, str(path.parent))
    spec = importlib.util.spec_from_file_location(f"tool_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(fn, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        res = fn(argv)
    return res, out.getvalue()


def test_reval_matches_jax_reval(tmp_path):
    """tools/test_net_torch.py reads a Solver snapshot as --weights_file;
    tools/reval_torch.py and tools/reval.py on the detections pickle it
    writes: the same AP lines."""
    solver = _solver(_tcfg(IMAGE), tmp_path / "train", val=False)
    solver.optimizer = DetectorSGD(solver.model, solver.cfg)
    snapshot = solver.snapshot(1)
    sets = ["COMPUTE_DTYPE", "float32", "STATIC.NMS_PRE_TEST", "256",
            "TEST.RPN_POST_NMS_TOP_N", "32"]
    m_ap = _tool(REPO / "tools" / "test_net_torch.py").main(
        ["--device", "cpu", "--net", "res18", "--net_type", "image", "--max_frames", "4",
         "--batch_size", "2", "--thresh", "0.05", "--out_dir", str(tmp_path),
         "--weights_file", snapshot, "--set"] + sets)
    pkl = tmp_path / "eval" / "synthetic_image_val" / "detections_torch.pkl"
    argv = [str(pkl), "--net_type", "image"]
    res, got = _run(_tool(REPO / "tools" / "reval_torch.py").main, argv)
    _, want = _run(_tool(REPO / "tools" / "reval.py").main, argv)
    lines = [ln for ln in want.splitlines() if ln.startswith(("class ", "mAP"))]
    assert lines and [ln for ln in got.splitlines() if ln.startswith(("class ", "mAP"))] == lines
    assert abs(res["mAP"] - m_ap) < 1e-12


def test_demo_matches_jax_demo(tmp_path):
    """tools/demo_torch.py and tools/demo.py on one synthetic frame and one
    set of weights (the port's init, written for JAX as an orbax
    checkpoint): the same detections over the threshold, both PNGs
    written."""
    import orbax.checkpoint as ocp

    flags = ["--net", "res18", "--thresh", "0.3"]
    sets = ["--set", "COMPUTE_DTYPE", "float32", "STATIC.NMS_PRE_TEST", "256",
            "TEST.RPN_POST_NMS_TOP_N", "32"]
    cfg = _tcfg(("NET_TYPE", "image", "NET_VARIANT", "res18", "COMPUTE_DTYPE", "float32"))
    port = t_det.init_detector(cfg, K, seed=3)
    with torch.no_grad():  # random heads saturate every score at 1.0: tame them
        for key, scale in (("rpn.rpn_cls_score_net", 0.02), ("rpn.rpn_bbox_pred_net", 0.02),
                           ("predictors.cls_score_net", 0.01)):
            port.get_submodule(key).weight.mul_(scale)
    torch.save(port.state_dict(), tmp_path / "w.pt")
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler()) as ckptr:
        # a JAX snapshot's layout: TrainState.params holds the variables
        ckptr.save(str(tmp_path / "jax_w"),
                   {"state": {"params": to_flax_variables(port.state_dict())}})
    boxes_j, _ = _run(_tool(REPO / "tools" / "demo_torch.py").main, flags + [
        "--device", "cpu", "--weights_file", str(tmp_path / "w.pt"),
        "--out", str(tmp_path / "port.png")] + sets)
    _, printed = _run(_tool(REPO / "tools" / "demo.py").main, flags + [
        "--weights_file", str(tmp_path / "jax_w"), "--out", str(tmp_path / "jax.png")] + sets)
    assert (tmp_path / "port.png").is_file() and (tmp_path / "jax.png").is_file()
    want = [float(s) for s in re.findall(r"score=([0-9.]+)", printed)]
    got = [float(row[-1]) for j in range(1, K) for row in boxes_j[j]]
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(sorted(got), sorted(want), atol=1.5e-3)
