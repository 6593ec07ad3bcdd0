"""The port's DEBUG draws (utils/debug_draw.py) against the JAX package's,
on tests/test_debug_draws.py's tiny config (res18, 64x96 frames, float32)
and on a res18 BEV config (200 x 175 x 15 rasters): one batch from JAX's
loader feeds both, the port's weights are bridged to JAX, and the sampled
anchor and RoI lanes are pinned to JAX's draws (PRNGKey(0): the anchor
keys of its one key, the RoI keys of its per-frame split, as
tests/test_torch_port_targets.py pins them).  JAX's `_draw_boxes` is
wrapped to record what each of its draws puts on the canvas: the port's
box groups equal those boxes (bitwise; the sampled RoIs' corners, which
come through the network, within ROI_ATOL), and the PNGs are pixel-equal.  Then
the Solver's switches: DEBUG.DRAW_ANCHORS, DRAW_ANCHOR_T and
DRAW_PROPOSAL_T write their PNGs from the first batch of `train`."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list as j_cfg_from_list  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.config import default_config as j_default  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.data import BatchLoader as JLoader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.data import SyntheticDataset as JSynthetic  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models.detector import FasterRCNN as JFasterRCNN  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.utils import debug_draw as j_dd  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list, default_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import init_detector  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import Solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils import debug_draw as dd  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import to_flax_variables  # noqa: E402
from tests.test_debug_draws import _TINY  # noqa: E402
from tests.torch_port_threads import two_threads  # noqa: E402, F401

F32 = ("COMPUTE_DTYPE", "float32")
BEV = ("NET_TYPE", "lidar", "NET_VARIANT", "res18", "TRAIN.SCALES", "(0.25,)",
       "TEST.SCALES", "(0.25,)", "STATIC.MAX_POINTS", "9000", "STATIC.MAX_GT", "8",
       "TRAIN.RPN_POST_NMS_TOP_N", "64", "STATIC.NMS_PRE_TRAIN", "256",
       "TRAIN.ROI_BATCH_SIZE", "32")
CASES = {"image": _TINY + F32, "bev": BEV + F32}
# the sampled RoIs are the same lanes on both sides; their corners are the
# RPN's deltas decoded, which the two backends' convolutions round apart
# (~1e-5 of a 64x96 frame's coordinates): within 1e-3 px
ROI_ATOL = 1e-3


def _uniform_pair(key, n):
    kf, kb = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kf, (n,))), np.asarray(jax.random.uniform(kb, (n,))))


def _anchor_keys(n):
    """JAX draw_anchor_targets' keys: anchor_target(PRNGKey(0)) splits it
    into its fg and bg keys."""
    fg, bg = _uniform_pair(jax.random.PRNGKey(0), n)
    return fg[None], bg[None]


def _roi_keys(b, r):
    """JAX draw_proposal_targets' keys: split(PRNGKey(0), b), one a frame,
    each split into proposal_target's fg and bg keys."""
    pairs = [_uniform_pair(k, r) for k in jax.random.split(jax.random.PRNGKey(0), b)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _recorded(monkeypatch):
    """Wrap JAX's _draw_boxes: each call's boxes (float32) and colour."""
    calls = []
    draw = j_dd._draw_boxes

    def record(canvas, boxes, color):
        calls.append((np.asarray(boxes, np.float32)[:, :4], color))
        return draw(canvas, boxes, color)

    monkeypatch.setattr(j_dd, "_draw_boxes", record)
    return calls


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name = request.param
    jcfg = j_cfg_from_list(j_default(), CASES[name])
    tcfg = cfg_from_list(default_config(), CASES[name])
    ds = (JSynthetic(jcfg, num_frames=4, num_classes=2, image_hw=(64, 96)) if name == "image"
          else JSynthetic(jcfg, num_frames=4, num_classes=2, seed=5))
    batch = {k: np.asarray(v) for k, v in JLoader(ds, jcfg, batch_size=2, seed=0).next().items()}
    port = init_detector(tcfg, 2, seed=0).to(memory_format=torch.channels_last)
    if name == "bev":
        import chip_smoke

        chip_smoke.scale_terminators(port)
    params = jax.tree.map(jnp.asarray, to_flax_variables(port.state_dict()))
    return name, jcfg, tcfg, batch, port, params


def _same(got, calls, colors, atol=0.0):
    """The port's groups, in draw order, against JAX's recorded calls:
    the same boxes, bitwise (atol 0) or within atol pixels."""
    assert [c for _, c in calls] == list(colors)
    for (boxes, _), want in zip(got, calls):
        boxes = np.asarray(boxes, np.float32)[:, :4]
        assert boxes.shape == want[0].shape
        np.testing.assert_allclose(boxes, want[0], rtol=0, atol=atol)


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_draw_boxes_and_pngs_equal_jax(case, tmp_path, monkeypatch):
    name, jcfg, tcfg, batch, port, params = case
    calls = _recorded(monkeypatch)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    paths = []

    # DRAW_ANCHORS
    j_path = j_dd.draw_anchors(jcfg, batch, jdir)
    got = dd.anchor_boxes(tcfg, batch)
    _same([got["anchors"]], calls, [(80, 160, 255)])
    paths.append((dd.draw_anchors(tcfg, batch, tdir, boxes=got), j_path))
    assert (got["anchors"][1] == -1).all()

    # DRAW_ANCHOR_T
    calls.clear()
    j_path = j_dd.draw_anchor_targets(jcfg, batch, jdir)
    n = len(dd._grid(tcfg, batch["data"].shape))
    got = dd.anchor_target_boxes(tcfg, batch, keys=_anchor_keys(n))
    bg = got["bg"][0]
    _same([(bg[:: max(1, len(bg) // 64)], None), got["fg"], got["gt"]], calls,
          [dd.BG_COLOR, dd.FG_COLOR, dd.GT_COLOR])
    assert len(got["fg"][0]) > 0 and (got["fg"][1] == 1).all() and (got["bg"][1] == 0).all()
    paths.append((dd.draw_anchor_targets(tcfg, batch, tdir, boxes=got), j_path))

    # DRAW_PROPOSAL_T
    calls.clear()
    j_path = j_dd.draw_proposal_targets(jcfg, JFasterRCNN(cfg=jcfg, num_classes=2), params,
                                        batch, jdir)
    r = min(tcfg.static.nms_pre_train, tcfg.train.rpn_pre_nms_top_n,
            tcfg.train.rpn_post_nms_top_n)
    got = dd.proposal_target_boxes(tcfg, port, batch, keys=_roi_keys(2, r))
    _same([got["bg"], got["fg"], got["gt"]], calls, [dd.BG_COLOR, dd.FG_COLOR, dd.GT_COLOR],
          atol=ROI_ATOL)
    assert len(got["bg"][0]) + len(got["fg"][0]) > 0
    assert (got["gt"][1] == batch["gt_boxes"][0][batch["gt_mask"][0], -1]).all()
    paths.append((dd.draw_proposal_targets(tcfg, port, batch, tdir, boxes=got), j_path))

    for t_path, j_path in paths:
        assert os.path.basename(t_path) == os.path.basename(j_path)
        np.testing.assert_array_equal(_png(t_path), _png(j_path), err_msg=t_path)


def test_solver_draws_on_the_first_batch(tmp_path, monkeypatch):
    """The three switches on: Solver.train writes the three PNGs from the
    first batch, with the weights of its first step, and trains on."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = cfg_from_list(default_config(), _TINY + F32 + (
        "DEBUG.DRAW_ANCHORS", "True", "DEBUG.DRAW_ANCHOR_T", "True",
        "DEBUG.DRAW_PROPOSAL_T", "True", "TRAIN.SNAPSHOT_ITERS", "10"))
    ds = SyntheticDataset(cfg, num_frames=4, num_classes=2, image_hw=(64, 96))
    loader = BatchLoader(ds, cfg, 2, device="cpu", seed=0)
    model = init_detector(cfg, 2, seed=0).to(memory_format=torch.channels_last)
    solver = Solver(cfg, model, loader, output_dir=str(tmp_path))
    res = solver.train(2)
    assert res["step"] == 2
    out = tmp_path / "debug_draws"
    assert sorted(solver.debug_draws) == ["DRAW_ANCHORS", "DRAW_ANCHOR_T", "DRAW_PROPOSAL_T"]
    assert sorted(os.listdir(out)) == ["anchor_targets.png", "anchors.png",
                                       "proposal_targets.png"]
    assert _png(out / "proposal_targets.png").shape[:2] == (64, 128)


def test_chip_smoke_debug_draw_check_on_the_cpu():
    """chip_smoke.check_debug_draws (phase 34) with both sides on the CPU at
    res18 64x96, batch 2: its box lists agree and its proposals' lanes
    with them."""
    import chip_smoke

    cfg = chip_smoke.make_config(chip_smoke.IMAGE_OVERRIDES, (
        "NET_VARIANT", "res18", "STATIC.NMS_PRE_TRAIN", "256", "TRAIN.RPN_POST_NMS_TOP_N", "64"))
    launches = chip_smoke.check_debug_draws(cfg, "CPU", hw=(64, 96), batch=2, device="cpu")
    assert not any(launches.values())  # the CPU runs the twins: nothing launched
