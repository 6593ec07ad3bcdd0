"""The LiDAR BEV training step, port vs the JAX package, at res50 on two
synthetic 200 x 175 x 15 rasters (scale 0.25), ROI_BATCH_SIZE 32,
NMS_PRE_TRAIN 256 -> 64, float32, on the CPU.

As in test_torch_port_train.py: both detectors share one set of weights,
the port gets the JAX package's own draws (`jax_draws`), and its second
stage is pinned to the JAX proposal lanes.  The GT boxes are 7-DoF
[xc, yc, zc, l, w, h, ry, cls], built as slightly turned copies of some JAX
proposals' footprints on their 3D anchors' z and h, so that proposals are
sampled as fg and the 7-DoF box loss (sine of the heading residual,
LIDAR.REG_LOSS_WEIGHT, the lidar target normalization) is not zero.
"""

from __future__ import annotations

import importlib.util
import sys
import types
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list, default_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import box_transform as j_bt  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import iou as j_iou  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import losses as j_losses  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import targets as j_tg  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.voxelize import (  # noqa: E402
    voxelize_bev as j_voxelize,
)
from faster_rcnn_pytorch_multimodal_tpu.training import optim as j_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.training import solver as j_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import box_transform as t_bt  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import losses as t_losses  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import targets as t_tg  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as t_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    load_flax_variables,
)
from tests.test_torch_port_fpn import (  # noqa: E402
    _jax_intermediates,
    _relu_ties,
    _torch_layout,
)
from tests.test_torch_port_train import (  # noqa: E402
    _flat,
    _shared_variables,
    jax_draws,
)

# test_torch_port_fpn put the repo root on sys.path
import chip_smoke  # noqa: E402

B, K, G, SCALE = 2, 2, 8, 0.25
# the synthetic frames' seeds; on seed 5 one layer2 ReLU unit sits at 0
# within rounding and takes a different gate in JAX's jitted step than in the
# port (_relu_ties), which chip_smoke.pinned_ties reconciles
FRAMES_SEEDS = (5, 6)
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box")
OVERRIDES = (
    "NET_TYPE", "lidar",
    "NET_VARIANT", "res50",
    "COMPUTE_DTYPE", "float32",
    "TRAIN.SCALES", f"({SCALE},)",
    "TEST.SCALES", f"({SCALE},)",
    "STATIC.MAX_POINTS", "9000",
    "TRAIN.ROI_BATCH_SIZE", "32",
    "STATIC.NMS_PRE_TRAIN", "256",
    "TRAIN.RPN_POST_NMS_TOP_N", "64",
    "TRAIN.RPN_BATCHSIZE", "64",
    "STATIC.MAX_GT", str(G),
    "TRAIN.USE_GT", "True",
    "TRAIN.USE_GT_NOISE", "True",
    "TRAIN.LEARNING_RATE", "0.01",
    "TRAIN.MOMENTUM", "0.9",
    "LIDAR.REG_LOSS_WEIGHT", "(1.0, 1.0, 0.5, 1.0, 1.0, 0.5, 2.0)",
)


def _cfg(*extra):
    return cfg_from_list(default_config(), OVERRIDES + extra)


def _tcfg(*extra):
    return t_config.cfg_from_list(t_config.default_config(), OVERRIDES + extra)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- targets and losses, module by module ------------------------------------


def _lidar_pairs(rng, n):
    """BEV rois, 3D anchors and 7-DoF GT boxes of n (roi, GT) pairs."""
    xy = rng.uniform(0, 150, (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(4, 30, (n, 2))], 1)
    anchors = np.stack([rng.uniform(0, 150, n), rng.uniform(0, 150, n), rng.uniform(0.5, 1, n),
                        rng.uniform(10, 30, n), rng.uniform(5, 12, n), rng.uniform(1.5, 2, n),
                        rng.choice([0, np.pi / 2], n)], 1)
    gt = np.stack([xy[:, 0] + rng.uniform(0, 20, n), xy[:, 1] + rng.uniform(0, 20, n),
                   rng.uniform(0.3, 1.2, n), rng.uniform(4, 30, n), rng.uniform(3, 12, n),
                   rng.uniform(1.2, 2.2, n), rng.uniform(-np.pi, np.pi, n)], 1)
    return rois.astype(np.float32), anchors.astype(np.float32), gt.astype(np.float32)


def test_lidar_3d_bbox_transform_and_round_trip():
    rois, anchors, gt = _lidar_pairs(np.random.RandomState(0), 64)
    want = np.asarray(j_bt.lidar_3d_bbox_transform(jnp.asarray(rois), jnp.asarray(anchors),
                                                   jnp.asarray(gt)))
    got = t_bt.lidar_3d_bbox_transform(_t(rois), _t(anchors), _t(gt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    back = t_bt.lidar_3d_bbox_transform_inv(_t(rois), _t(anchors), got).numpy()
    np.testing.assert_allclose(back, gt, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("en_ry_sin", [True, False])
def test_lidar_box_loss_matches_jax(en_ry_sin):
    """smooth_l1_loss(lidar_det) on (B, S, 7K): Huber of the inside-weighted
    residual, the heading's through its sine when en_ry_sin, each element
    weighted by a non-uniform reg_loss_weight; huber_loss(sin_en) alone."""
    rng = np.random.RandomState(1)
    shape = (2, 16, 7 * 3)
    pred = rng.normal(0, 1.5, shape).astype(np.float32)
    targets = rng.normal(0, 1.5, shape).astype(np.float32)
    inside = (rng.uniform(size=shape) < 0.5).astype(np.float32)
    outside = (inside > 0).astype(np.float32)
    weight = (1.0, 2.0, 0.5, 1.0, 0.25, 1.0, 3.0)
    kw = dict(lidar_det=True, en_ry_sin=en_ry_sin, reg_loss_weight=weight, sum_axes=(2,))
    want = float(j_losses.smooth_l1_loss(*(jnp.asarray(a) for a in (pred, targets, inside,
                                                                     outside)), **kw))
    got = t_losses.smooth_l1_loss(_t(pred), _t(targets), _t(inside), _t(outside), **kw)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    image = float(t_losses.smooth_l1_loss(_t(pred), _t(targets), _t(inside), _t(outside),
                                          sum_axes=(2,)))
    assert abs(float(got) - image) > 1e-3  # the lidar branch changes the loss
    h_want = np.asarray(j_losses.huber_loss(jnp.asarray(pred), jnp.asarray(targets), 1.0,
                                            sin_en=en_ry_sin))
    h_got = t_losses.huber_loss(_t(pred), _t(targets), 1.0, sin_en=en_ry_sin).numpy()
    np.testing.assert_allclose(h_got, h_want, rtol=1e-6, atol=1e-7)


def test_lidar_proposal_target_matches_jax():
    """The lidar branch: overlaps on the BEV boxes, 7-DoF targets against
    each sampled RoI's 3D anchor, the lidar normalization; the sampled
    anchors come back in ProposalTargets.anchors_3d."""
    rng = np.random.RandomState(2)
    r, s = 96, 32
    rois, anchors, _ = _lidar_pairs(rng, r)
    rois = np.stack([rois] * B)
    anchors = np.stack([anchors] * B)
    gt7 = np.zeros((B, G, 8), np.float32)
    mask = np.zeros((B, G), bool)
    for i, n in enumerate([3, 5]):
        pick = rois[i, ::11][:n]
        gt7[i, :n, 0:2] = (pick[:, :2] + pick[:, 2:]) / 2 + rng.uniform(-1, 1, (n, 2))
        gt7[i, :n, 2] = rng.uniform(0.3, 1.2, n)
        gt7[i, :n, 3:5] = pick[:, 2:] - pick[:, :2]
        gt7[i, :n, 5] = rng.uniform(1.2, 2.2, n)
        gt7[i, :n, 6] = rng.uniform(-0.2, 0.2, n)
        gt7[i, :n, 7] = 1
        mask[i, :n] = True
    gt_bev = np.concatenate([np.asarray(j_iou.bbox_3d_to_bev_aabb(jnp.asarray(gt7[..., :7]))),
                             gt7[..., 7:]], -1)
    valid = rng.uniform(size=(B, r)) < 0.9
    c = _cfg().train
    means, stds = np.asarray(c.lidar_bbox_normalize_means), np.asarray(c.lidar_bbox_normalize_stds)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    kw = dict(num_classes=K, num_bbox_elem=7, roi_batch_size=s, fg_fraction=0.25, fg_thresh=0.5,
              bg_thresh_hi=0.5, bg_thresh_lo=0.0)
    want = jax.vmap(partial(j_tg.proposal_target, is_lidar=True, **kw),
                    in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None, None))(
        jnp.concatenate([jnp.zeros((B, r, 1)), jnp.asarray(rois)], -1), jnp.zeros((B, r)),
        jnp.asarray(valid), jnp.asarray(anchors), jnp.asarray(gt_bev), jnp.asarray(mask),
        jnp.asarray(gt7), jnp.zeros((B, 1, 4)), jnp.zeros((B, 1), bool), keys,
        jnp.asarray(means), jnp.asarray(stds))
    # the uniform keys JAX's _rank_within draws inside proposal_target
    draws = [np.stack([np.asarray(jax.random.uniform(jax.random.split(k)[j], (r,))) for k in keys])
             for j in (0, 1)]
    got = t_tg.proposal_target(
        _t(rois), _t(valid), _t(gt_bev), _t(mask), torch.zeros((B, 1, 4)),
        torch.zeros((B, 1), dtype=torch.bool), _t(draws[0]), _t(draws[1]), _t(means), _t(stds),
        anchors_3d=_t(anchors), true_gt_boxes=_t(gt7), **kw)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois)[..., 1:])
    np.testing.assert_array_equal(got.anchors_3d.numpy(), np.asarray(want.anchors_3d))
    np.testing.assert_allclose(got.bbox_targets.numpy(), np.asarray(want.bbox_targets),
                               rtol=1e-5, atol=1e-5)
    for name in ("bbox_inside_weights", "bbox_outside_weights", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert int((got.labels > 0).sum()) >= 4 and got.bbox_targets.abs().max() > 0.1


# -- the training step -----------------------------------------------------------


def _stages(m, images, window):
    feats = m.features(images, deterministic=True)
    rpn = m.rpn_scores(feats["rpn"])
    rpn["anchors"] = m._anchors(feats["rpn"])
    rois, _s, a3d, valid, src = m._propose_batch(rpn, window, "train")
    return rois, a3d, valid, src


def _batch(cfg, tcfg, seed):
    """Two synthetic rasters (rasterized as the JAX loader does), windows,
    the shared weights and 7-DoF GT on some JAX proposals."""
    db = SyntheticDataset(tcfg, num_frames=B, mode="train", seed=seed)
    frames = [db.frame(i) for i in range(B)]
    p = tcfg.static.max_points
    pts = np.zeros((B, p, 5), np.float32)
    valid = np.zeros((B, p), bool)
    for i, f in enumerate(frames):
        pts[i, : len(f["points"])] = f["points"][:p]
        valid[i, : len(f["points"])] = True
    grid = raster_kwargs(tcfg, SCALE)
    x = np.asarray(jax.jit(jax.vmap(partial(j_voxelize, **grid)))(jnp.asarray(pts),
                                                                   jnp.asarray(valid)))
    window = np.stack([f["window"] for f in frames])
    variables = _shared_variables(j_det.FasterRCNN(cfg=cfg, num_classes=K), x, window)
    rois, a3d, pvalid, _src = (np.asarray(a) for a in j_det.FasterRCNN(cfg=cfg, num_classes=K).apply(
        variables, jnp.asarray(x), jnp.asarray(window), method=_stages))
    rng = np.random.RandomState(1)
    gt = np.zeros((B, G, 8), np.float32)
    mask = np.zeros((B, G), bool)
    for i, n in enumerate([3, 5]):
        pick = np.flatnonzero(pvalid[i])[::7][:n]
        r, a = rois[i, pick], a3d[i, pick]
        gt[i, :n, 0:2] = (r[:, :2] + r[:, 2:]) / 2 + rng.uniform(-1, 1, (n, 2))
        gt[i, :n, 2] = a[:, 2] + rng.uniform(-0.2, 0.2, n)
        gt[i, :n, 3:5] = (r[:, 2:] - r[:, :2]) * rng.uniform(0.9, 1.1, (n, 2))
        gt[i, :n, 5] = a[:, 5] * rng.uniform(0.9, 1.1, n)
        gt[i, :n, 6] = rng.uniform(-0.3, 0.3, n)
        gt[i, :n, 7] = 1
        mask[i, :n] = True
    batch = {"data": x, "gt_boxes": gt, "gt_mask": mask, "window": window}
    return batch, variables


def _jax_run(cfg, variables, batch, rng):
    """JAX losses and gradients (total and loss_box alone) at step 0, the
    proposal lanes, the sampled labels and the parameters after
    make_train_step."""
    model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step_rng = jax.random.fold_in(rng, jnp.int32(0))
    froz = j_optim.frozen_mask(variables["params"], cfg)

    def losses_fn(params):
        params = jax.tree.map(lambda p, m: jax.lax.stop_gradient(p) if m else p, params, froz)
        return model.apply({"params": params}, jb["data"], jb["gt_boxes"], jb["gt_mask"],
                           jb["window"], step_rng, method=j_det.FasterRCNN.forward_train)

    @jax.jit
    def grads(params):
        losses = losses_fn(params)
        g_total = jax.grad(lambda p: losses_fn(p)["total_loss"])(params)
        g_box = jax.grad(lambda p: losses_fn(p)["loss_box"])(params)
        return losses, g_total, g_box

    rois, a3d, valid, src = model.apply(variables, jb["data"], jb["window"], method=_stages)
    # the second-stage sampling of forward_train, from its own key chain
    _rng_at, rng_pt, _ = jax.random.split(step_rng, 3)
    gt = jb["gt_boxes"]
    gt_bev = jnp.concatenate([j_iou.bbox_3d_to_bev_aabb(gt[..., :7]), gt[..., 7:8]], -1)
    gt4 = gt_bev[..., :4]
    gw, gh = gt4[..., 2] - gt4[..., 0], gt4[..., 3] - gt4[..., 1]
    gt4 = gt4 + (jax.random.normal(jax.random.fold_in(step_rng, 7), gt4.shape) * 0.03
                 * jnp.stack([gw, gh, gw, gh], -1))
    all_rois = jnp.concatenate([rois, gt4], 1)
    all_valid = jnp.concatenate([valid, jb["gt_mask"]], 1)
    all_a3d = jnp.concatenate([a3d, gt[..., :7]], 1)
    r = all_rois.shape[1]
    c = cfg.train
    pt = jax.vmap(lambda r4, v, a, gb, m, g7, k: j_tg.proposal_target(
        jnp.concatenate([jnp.zeros((r, 1)), r4], -1), jnp.zeros(r), v, a, gb, m, g7,
        jnp.zeros((1, 4)), jnp.zeros((1,), bool), k,
        jnp.asarray(c.lidar_bbox_normalize_means), jnp.asarray(c.lidar_bbox_normalize_stds),
        num_classes=K, num_bbox_elem=7, roi_batch_size=c.roi_batch_size,
        fg_fraction=c.fg_fraction, fg_thresh=c.fg_thresh, bg_thresh_hi=c.bg_thresh_hi,
        bg_thresh_lo=c.bg_thresh_lo, is_lidar=True))(
        all_rois, all_valid, all_a3d, gt_bev, jb["gt_mask"], gt, jax.random.split(rng_pt, B))

    losses, g_total, g_box = grads(variables["params"])
    opt = j_optim.build_optimizer(variables, cfg)
    state = j_det.TrainState(params=variables, opt_state=opt.init(variables),
                             step=jnp.zeros((), jnp.int32))
    new_state, _ = j_solver.make_train_step(model, opt)(state, jb, rng)
    return types.SimpleNamespace(
        src=np.asarray(src), valid=np.asarray(valid), labels=np.asarray(pt.labels),
        bbox_targets=np.asarray(pt.bbox_targets),
        losses={k: float(v) for k, v in losses.items()},
        g_total={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(g_total)},
        g_box={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(g_box)},
        new_params={flax_path_to_torch_key(p): np.asarray(v)
                    for p, v in _flat(new_state.params["params"])},
        n_rois=r, step_rng=step_rng,
    )


@pytest.fixture(scope="module", params=FRAMES_SEEDS, ids=lambda seed: f"frames{seed}")
def run(request):
    cfg, tcfg = _cfg(), _tcfg()
    batch, variables = _batch(cfg, tcfg, request.param)
    j = _jax_run(cfg, variables, batch, jax.random.PRNGKey(3))
    model = t_det.FasterRCNN(tcfg, K)
    n, r = model.train_lane_counts(batch["data"].shape[1:3], G)
    assert (n, r) == (13 * 11 * 2, 64 + G) and r == j.n_rois
    draws = jax_draws(j.step_rng, B, n, r, G)
    run = types.SimpleNamespace(cfg=cfg, tcfg=tcfg, batch=batch, variables=variables, j=j,
                                draws=draws, ties=[])
    run.ties = _relu_ties(lambda: _port(tcfg, variables), lambda m: _forward(m, run),
                          _jax_intermediates(cfg, variables, batch, j.step_rng))
    return run


def _port(cfg, variables):
    model = t_det.FasterRCNN(cfg, K)
    load_flax_variables(model, variables)
    return model


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pin(run):
    return torch.from_numpy(run.j.src).long(), torch.from_numpy(run.j.valid)


def _forward(model, run):
    """forward_train on the JAX draws and proposal lanes, each ReLU tie given
    JAX's gate."""
    tb = _tensors(run.batch)
    with chip_smoke.pinned_ties(model, run.ties):
        return model.forward_train(tb["data"], tb["gt_boxes"], tb["gt_mask"], tb["window"],
                                   run.draws, proposals=_pin(run))


def test_lanes_samples_and_targets_identical(run):
    """Unpinned, the port's NMS on its own scores keeps the JAX lanes; pinned,
    it samples the JAX labels, each RoI's 3D anchor and 7-DoF targets."""
    model = _port(run.tcfg, run.variables)
    with torch.no_grad():
        _losses, aux = _forward(model, run)
        feat = model.features(torch.from_numpy(run.batch["data"]))
        rpn = model.rpn_scores(feat)
        anchors = model.anchors(feat.shape[1], feat.shape[2], feat.device, "train")
        src, valid = model.select_proposals(rpn, anchors, torch.from_numpy(run.batch["window"]))
    pt = aux.proposal_targets
    np.testing.assert_array_equal(pt.labels.numpy(), run.j.labels)
    assert (run.j.labels > 0).sum() >= 6 and (run.j.labels == 0).sum() >= 4
    assert pt.anchors_3d.shape == (B, 32, 7)
    np.testing.assert_allclose(pt.bbox_targets.numpy(), run.j.bbox_targets, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(valid.numpy(), run.j.valid)
    # the same kept lanes; two lanes whose scores tie within float32 rounding
    # may trade places in the score order
    got, want = src.numpy(), run.j.src
    for i in range(B):
        v = run.j.valid[i]
        np.testing.assert_array_equal(np.sort(got[i][v]), np.sort(want[i][v]))
        assert (got[i][v] == want[i][v]).mean() >= 0.95


def test_relu_ties_are_few_and_at_zero(run):
    """The units whose ReLU gate differs between the two backends
    (test_torch_port_fpn._relu_ties) are few: at most 4 in the backbone, at
    most 16 in all (the C4 tail's ReLUs see 2 x 72 x 49 x 2048 units), and
    each sits at 0 within 1e-5 of its ReLU's max|input|, not at a port
    fault."""
    print(f"ReLU ties (path, residual, at, JAX input, port input, max|input|): {run.ties}")
    assert sum(t[0].startswith("backbone.") for t in run.ties) <= 4, run.ties
    assert len(run.ties) <= 16, run.ties
    for path, residual, at, jx, tx, scale in run.ties:
        assert max(abs(jx), abs(tx)) <= 1e-5 * scale, (path, residual, at, jx, tx, scale)


def test_losses_and_gradients(run):
    """Losses within rtol 1e-4; every trainable leaf's gradient within
    1e-3 * its max, each ReLU tie given JAX's gate."""
    model = _port(run.tcfg, run.variables)
    DetectorSGD(model, run.tcfg)
    losses, _ = _forward(model, run)
    for k in LOSSES + ("total_loss",):
        np.testing.assert_allclose(float(losses[k].detach()), run.j.losses[k], rtol=1e-4,
                                   err_msg=k)
    assert all(run.j.losses[k] > 0 for k in LOSSES)
    losses["total_loss"].backward()
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    worst = (0.0, None)
    for name, p in trained:
        want = _torch_layout(run.j.g_total[name])
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max() + 1e-12,
                                   err_msg=name)
        worst = max(worst, (float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12)), name))
    print(f"largest gradient error / max|g|: {worst[0]} ({worst[1]})")
    assert len(trained) >= 50


def test_loss_box_reaches_the_rpn_through_the_proposals(run):
    """Fault F1 in lidar training: loss_box alone sends gradient into the RPN
    bbox conv (through log(gt_l / lengths) of the proposals' +1 lengths), in
    both packages alike."""
    model = _port(run.tcfg, run.variables)
    DetectorSGD(model, run.tcfg)
    losses, _ = _forward(model, run)
    losses["loss_box"].backward()
    want = run.j.g_box["rpn.rpn_bbox_pred_net.weight"]
    assert np.abs(want).max() > 0
    got = model.rpn.rpn_bbox_pred_net.weight.grad
    assert got is not None and float(got.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (3, 2, 0, 1)),
                               atol=1e-3 * np.abs(want).max())


def test_one_train_step_matches_make_train_step(run):
    """Port make_train_step vs JAX make_train_step: each trainable leaf's
    update within 1e-3 * its max plus float32 rounding of the parameter,
    each ReLU tie given JAX's gate."""
    model = _port(run.tcfg, run.variables)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step = t_solver.make_train_step(model, DetectorSGD(model, run.tcfg))
    with chip_smoke.pinned_ties(model, run.ties):
        losses, _ = step(_tensors(run.batch), run.draws, _pin(run))
    np.testing.assert_allclose(float(losses["total_loss"]), run.j.losses["total_loss"], rtol=1e-4)
    moved = 0
    for name, p in model.named_parameters():
        w = _torch_layout(run.j.new_params[name])
        want, got = w - start[name].numpy(), (p.detach() - start[name]).numpy()
        atol = 1e-3 * np.abs(want).max() + 1e-6 * np.abs(start[name].numpy()).max()
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)
        moved += bool(np.abs(want).max() > 0)
    assert moved == sum(p.requires_grad for p in model.parameters()) >= 50


@pytest.mark.parametrize("substride", [1, 2])
def test_lidar_lane_counts(substride):
    """The keys' sizes: ceil(Y / 16) x ceil(X / 16) cells of num_anchors_3d
    lanes, 25 x 22 x 2 at 400 x 350, the substride's sub-cells included, as
    many as the RPN and the anchor grid have."""
    cfg = _tcfg("LIDAR.ANCHOR_SUBSTRIDE", str(substride), "STATIC.NMS_PRE_TRAIN", "1024",
                "TRAIN.RPN_POST_NMS_TOP_N", "2000")
    model = t_det.FasterRCNN(cfg, K)
    n, r = model.train_lane_counts((400, 350), 64)
    assert n == 25 * 22 * 2 * substride ** 2 == 25 * 22 * cfg.num_anchors_3d
    assert r == min(1024, n) + 64
    assert model.anchors(25, 22, torch.device("cpu"), "train").shape[0] == n
    batch = {"data": torch.zeros((1, 400, 350, 15)), "gt_boxes": torch.zeros((1, 64, 8))}
    draws = t_solver.draw_train_keys(model, batch, torch.Generator().manual_seed(0))
    assert draws.anchor_fg.shape == (1, n) and draws.roi_fg.shape == (1, r)
    assert draws.gt_noise.shape == (1, 64, 4)


def test_train_loop_on_lidar_batches():
    """training.solver.train on the loader's lidar batches (raster made on the
    loader's device, 8-column GT, DC boxes): finite losses, every step."""
    cfg = _tcfg()
    ds = SyntheticDataset(cfg, num_frames=B, num_classes=K, mode="train", seed=0)
    loader = BatchLoader(ds, cfg, batch_size=B, device="cpu", augment=True, seed=0)
    batch = t_solver.batch_to_device(loader.peek(), torch.device("cpu"))
    assert batch["data"].shape == (B, 200, 175, 15) and batch["gt_boxes"].shape == (B, G, 8)
    assert batch["gt_boxes_dc"].shape[-1] == 4 and batch["gt_mask"].any()
    model, opt = t_solver.create_train_state(cfg, K, "cpu", seed=0)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith(".bn3"):
                m.weight.fill_(0.25)
    res = t_solver.train(model, opt, loader, 2, torch.Generator().manual_seed(0))
    assert all(np.isfinite(v) for losses in res["losses"] for v in losses.values())
    assert len(res["ms"]) == 2 and res["losses"][0]["loss_box"] > 0


def test_trainval_cli_trains_lidar(tmp_path, monkeypatch):
    """tools/trainval_net_torch.py --net_type lidar: one step on the loader's
    synthetic LiDAR batch, finite losses (the Solver's per-step history).
    The Solver's logs are JSONL only here: torch.utils.tensorboard would
    import TensorFlow into the test process."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    path = Path(__file__).resolve().parents[1] / "tools" / "trainval_net_torch.py"
    spec = importlib.util.spec_from_file_location("trainval_net_torch", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    res = cli.main([
        "--device", "cpu", "--net", "res50", "--net_type", "lidar", "--scale", "0.25",
        "--iters", "1", "--batch_size", "1", "--out_dir", str(tmp_path),
        "--set", "COMPUTE_DTYPE", "float32", "STATIC.NMS_PRE_TRAIN", "256",
        "TRAIN.RPN_POST_NMS_TOP_N", "64", "TRAIN.ROI_BATCH_SIZE", "32",
        "STATIC.MAX_POINTS", "8192"])
    assert len(res["ms"]) == 1
    assert all(np.isfinite(v) for v in res["history"][0].values())
    assert res["history"][0]["total_loss"] > 0
