"""The port's tools against the JAX package's, on the CPU at a tiny size:

  profile_step_torch.py   every section runs at res18 on 64x96 frames
                          (image, FPN) and 200 x 175 x 15 rasters (BEV), and
                          the full section's losses are make_train_step's on
                          the same batch, weights and draws;
  diag_bev_overfit_torch  the anchor coverage (stage A) and the anchor_target
                          sample counts (stage B) print what JAX's tool
                          prints on the frozen frame, and one overfit step
                          with its recall runs;
  visualize_sample_torch  the image frame's PNG is JAX's tool's, pixel for
                          pixel; a BEV frame is drawn;
  cls_uncertainty_vis     the loss curves on JAX's normals within 1e-6 of
                          JAX's bayesian_cross_entropy, the PNG written;
  demo_all_bboxes_torch   demo_torch.py with JAX's wrapper's defaults.
"""

from __future__ import annotations

import importlib.util
import io
import os
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_port_threads import two_threads  # noqa: E402, F401

REPO = Path(__file__).resolve().parents[1]
TOOLS = REPO / "tools"


def _tool(name: str):
    sys.path.insert(0, str(TOOLS))
    spec = importlib.util.spec_from_file_location(f"tool_{name}", TOOLS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(fn, *args):
    out = io.StringIO()
    with redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


# -- profile_step_torch -----------------------------------------------------------

TINY = ("NET_VARIANT", "res18", "COMPUTE_DTYPE", "float32", "STATIC.MAX_POINTS", "9000",
        "TRAIN.SCALES", "(0.25,)", "TEST.SCALES", "(0.25,)", "TRAIN.RPN_POST_NMS_TOP_N", "64",
        "STATIC.NMS_PRE_TRAIN", "256", "TRAIN.ROI_BATCH_SIZE", "32")


@pytest.mark.parametrize("which", ["image", "bev", "fpn"])
def test_profile_step_sections(which):
    P = _tool("profile_step_torch")
    import chip_smoke
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as S

    cfg = chip_smoke.make_config(*P.CONFIGS[which], TINY)
    res = P.profile(cfg, "cpu", image_hw=(64, 96), batch_size=2, warmup=1, reps=1, windows=1)
    assert tuple(res) == P.SECTIONS
    for name in P.SECTIONS[:-1]:
        assert np.isfinite(res[name]["losses"]) and res[name]["ms"] > 0, name
    model, optimizer, batch, draws = P.setup(cfg, torch.device("cpu"), (64, 96), 2)
    if "points" in batch:
        batch = dict(batch, data=P._images(model, batch))
        assert tuple(batch["data"].shape[1:]) == (200, 175, 15)
    want, _ = S.make_train_step(model, optimizer)(batch, draws)
    got = res[P.SECTIONS[-1]]["losses"]
    assert got == {k: float(v) for k, v in want.items()}
    assert got["cross_entropy"] > 0
    text = P.report(which, cfg, res, "CPU", 2)
    assert all(name in text for name in P.SECTIONS)


# -- diag_bev_overfit_torch ----------------------------------------------------------


class _Stop(Exception):
    pass


def _stages_ab(text: str) -> list:
    """The lines of stages A and B (and the frame's GT before them)."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("=== frame 0"))
    end = next(i for i, ln in enumerate(lines) if ln.startswith("=== B."))
    return lines[start:end + 1]


def test_diag_bev_overfit_stages_equal_jax(monkeypatch):
    from faster_rcnn_pytorch_multimodal_tpu.training import solver as j_solver

    def stop(*_a, **_k):
        raise _Stop

    # JAX's tool up to stage C: its create_train_state stops it there
    monkeypatch.setattr(j_solver, "create_train_state", stop)
    monkeypatch.setattr(sys, "argv", ["diag_bev_overfit.py"])
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(_Stop):
        _tool("diag_bev_overfit").main()
    want = _stages_ab(out.getvalue())

    D = _tool("diag_bev_overfit_torch")
    res, text = _run(D.main, ["--iters", "1", "--eval_every", "1", "--device", "cpu"])
    assert _stages_ab(text) == want and len(want) > 6
    assert res["samples"]["fg"] > 0 and res["samples"]["bg"] > 0
    (log,) = res["log"]
    assert log["iter"] == 1 and np.isfinite(log["losses"]["total_loss"])
    assert 0.0 <= log["recall"] <= 1.0 and 0.0 <= log["ap"] <= 1.0


# -- visualize_sample_torch ----------------------------------------------------------


def test_visualize_sample_equals_jax(tmp_path):
    from PIL import Image

    common = ["--frame", "1", "--set", "PIXEL_STDDEVS", "[60.,60.,60.]"]
    _run(_tool("visualize_sample_torch").main, ["--out", str(tmp_path / "port.png")] + common)
    _run(_tool("visualize_sample").main, ["--out", str(tmp_path / "jax.png")] + common)
    got, want = (np.asarray(Image.open(tmp_path / n)) for n in ("port.png", "jax.png"))
    np.testing.assert_array_equal(got, want)
    canvas, text = _run(_tool("visualize_sample_torch").main, [
        "--net_type", "lidar", "--device", "cpu", "--out", str(tmp_path / "bev.png"),
        "--set", "TRAIN.SCALES", "(0.25,)", "STATIC.MAX_POINTS", "9000"])
    assert (tmp_path / "bev.png").is_file() and canvas.shape[:2] == (200, 175)
    assert "GT boxes" in text


# -- cls_uncertainty_vis_torch --------------------------------------------------------


def test_cls_uncertainty_curves_equal_jax(tmp_path):
    from faster_rcnn_pytorch_multimodal_tpu.ops.losses import bayesian_cross_entropy

    V = _tool("cls_uncertainty_vis_torch")
    n = 50
    key = jax.random.PRNGKey(0)
    normals = np.asarray(jax.random.normal(key, (n, 1, 2)))
    got = V.loss_curves(n, normals)

    def one(m, s):
        logits = jnp.stack([m, jnp.zeros_like(m)])[None]
        return bayesian_cross_entropy(logits, jnp.full((1, 2), s ** 2), jnp.asarray([0]), n,
                                      key)[0]

    grid = jax.jit(jax.vmap(jax.vmap(one, (None, 0)), (0, None)))
    want = np.asarray(grid(jnp.asarray(V.MARGINS, jnp.float32),
                           jnp.asarray(V.SIGMAS, jnp.float32)), np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    curves, text = _run(V.main, ["--out", str(tmp_path / "cls.png"), "--num_sample", "20"])
    assert (tmp_path / "cls.png").is_file() and curves.shape == want.shape
    assert np.isfinite(curves).all()


# -- demo_all_bboxes_torch ------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [], ["--thresh", "0.3"], ["--out", "x.png", "--set", "TEST.NMS_THRESH", "0.4"],
])
def test_demo_all_bboxes_passes_jax_defaults(argv, monkeypatch):
    got, want = [], []
    demo = _tool("demo")
    demo_torch = _tool("demo_torch")
    monkeypatch.setitem(sys.modules, "demo", demo)
    monkeypatch.setitem(sys.modules, "demo_torch", demo_torch)
    monkeypatch.setattr(demo, "main", want.append)
    monkeypatch.setattr(demo_torch, "main", got.append)
    _tool("demo_all_bboxes").main(list(argv))
    _tool("demo_all_bboxes_torch").main(list(argv))
    assert got == want and len(got) == 1


def test_demo_all_bboxes_draws(tmp_path):
    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list, default_config
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import init_detector

    cfg = cfg_from_list(default_config(), ("NET_TYPE", "image", "NET_VARIANT", "res18",
                                           "COMPUTE_DTYPE", "float32"))
    port = init_detector(cfg, 2, seed=3)
    with torch.no_grad():  # random heads saturate every score at 1.0: tame them
        for key, scale in (("rpn.rpn_cls_score_net", 0.02), ("rpn.rpn_bbox_pred_net", 0.02),
                           ("predictors.cls_score_net", 0.01)):
            port.get_submodule(key).weight.mul_(scale)
    torch.save(port.state_dict(), tmp_path / "w.pt")
    out = tmp_path / "all.png"
    boxes_j, text = _run(_tool("demo_all_bboxes_torch").main, [
        "--net", "res18", "--device", "cpu", "--weights_file", str(tmp_path / "w.pt"),
        "--out", str(out), "--set", "COMPUTE_DTYPE", "float32", "STATIC.NMS_PRE_TEST", "256",
        "TEST.RPN_POST_NMS_TOP_N", "32"])
    assert out.is_file() and "over threshold 0.8" in text
    assert all(row[-1] > 0.8 for rows in boxes_j[1:] for row in rows)
    os.remove(out)
