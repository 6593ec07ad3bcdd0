"""One res18 live-BN training step each of the image C4, FPN and LiDAR BEV
detectors, port vs the JAX package's jitted step, on the CPU
(RESNET.FIXED_BLOCKS -1): on JAX's draws and proposal lanes, each ReLU tie
given JAX's gate; the losses, every leaf's gradient and the running
statistics, the update, then an eval forward on the updated running
statistics.  The configurations, the shared weights (JAX's init with every
BN scale in [0.5, 1.5], BN biases and running means small normals, running
variances in [0.5, 1.5], from numpy seeds) and the LiDAR raster are
tests/test_torch_port_live_bn.py's.
"""

from __future__ import annotations

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
import optax  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import iou as j_iou  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import targets as j_tg  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.training import optim as j_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.inference import eval_mode  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import optim as t_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as t_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    load_flax_variables,
)
from tests.test_torch_port_fpn import (  # noqa: E402
    _jax_intermediates,
    _relu_ties,
    _torch_layout,
)
from tests.test_torch_port_live_bn import (  # noqa: E402
    BEV,
    FPN,
    IMAGE,
    LOSSES,
    B,
    G,
    H,
    K,
    W,
    _cfgs,
    _close,
    _randomize_bn,
    _raster,
    _t,
)
from tests.test_torch_port_train import _flat, jax_draws  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _stages_train(m, images, window):
    """JAX forward_train's features (train mode: batch statistics) and
    train-phase proposals."""
    feats = m.features(images, True, True)
    rpn = m.rpn_scores(feats["rpn"])
    rpn["anchors"] = m._anchors(feats["rpn"])
    rois, _s, a3d, valid, src = m._propose_batch(rpn, window, "train")
    return rois, a3d, valid, src


def _train_batch(cfg, tcfg, lidar):
    """Frames, windows, the shared live-BN weights and GT on some of JAX's
    train-mode proposals (image: jittered boxes; lidar: 7-DoF boxes on the
    proposals' footprints and their 3D anchors' z and h)."""
    rng = np.random.RandomState(1)
    if lidar:
        x, window = _raster(tcfg, seed=6)
    else:
        x = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
        window = np.array([[0, W, 0, H], [0, W - 40, 0, H - 24]], np.float32)
    model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    variables = _randomize_bn(
        jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                                     jnp.asarray(window))), seed=0)
    lanes = tuple(np.asarray(a) for a in jax.jit(partial(model.apply, method=_stages_train))(
        variables, jnp.asarray(x), jnp.asarray(window)))
    rois, a3d, pvalid, _src = lanes
    gt = np.zeros((B, G, 8 if lidar else 5), np.float32)
    mask = np.zeros((B, G), bool)
    for i, n in enumerate([3, 5]):
        pick = np.flatnonzero(pvalid[i])[::7][:n]
        r = rois[i, pick]
        if lidar:
            a = a3d[i, pick]
            gt[i, :n, 0:2] = (r[:, :2] + r[:, 2:]) / 2 + rng.uniform(-1, 1, (n, 2))
            gt[i, :n, 2] = a[:, 2] + rng.uniform(-0.2, 0.2, n)
            gt[i, :n, 3:5] = (r[:, 2:] - r[:, :2]) * rng.uniform(0.9, 1.1, (n, 2))
            gt[i, :n, 5] = a[:, 5] * rng.uniform(0.9, 1.1, n)
            gt[i, :n, 6] = rng.uniform(-0.3, 0.3, n)
        else:
            gt[i, :n, :4] = r + rng.uniform(-2, 2, r.shape)
        gt[i, :n, -1] = 1
        mask[i, :n] = True
    return {"data": x, "gt_boxes": gt, "gt_mask": mask, "window": window}, variables, lanes


def _jax_run(cfg, variables, batch, rng, lidar, lanes):
    """JAX's step 0 with live BN, on train-mode proposal `lanes`
    (_stages_train: they do not depend on the GT): losses, gradients and
    the running statistics forward_train leaves, the sampled labels,
    the variables after make_train_step, and the eval forward on them
    (features, RPN scores and forward_test)."""
    model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step_rng = jax.random.fold_in(rng, jnp.int32(0))

    def losses_fn(params):
        losses, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb["data"],
            jb["gt_boxes"], jb["gt_mask"], jb["window"], step_rng,
            method=j_det.FasterRCNN.forward_train, mutable=["batch_stats"])
        return losses["total_loss"], (losses, mut)

    @jax.jit
    def grads(params):
        (_, (losses, mut)), g = jax.value_and_grad(losses_fn, has_aux=True)(params)
        return losses, g, mut

    rois, a3d, valid, src = (jnp.asarray(a) for a in lanes)
    _rng_at, rng_pt, _ = jax.random.split(step_rng, 3)
    gt = jb["gt_boxes"]
    gt_bev = (jnp.concatenate([j_iou.bbox_3d_to_bev_aabb(gt[..., :7]), gt[..., 7:8]], -1)
              if lidar else gt)
    gt4 = gt_bev[..., :4]
    gw, gh = gt4[..., 2] - gt4[..., 0], gt4[..., 3] - gt4[..., 1]
    gt4 = gt4 + (jax.random.normal(jax.random.fold_in(step_rng, 7), gt4.shape) * 0.03
                 * jnp.stack([gw, gh, gw, gh], -1))
    all_rois = jnp.concatenate([rois, gt4], 1)
    all_valid = jnp.concatenate([valid, jb["gt_mask"]], 1)
    r = all_rois.shape[1]
    c = cfg.train
    kw = dict(num_classes=K, roi_batch_size=c.roi_batch_size, fg_fraction=c.fg_fraction,
              fg_thresh=c.fg_thresh, bg_thresh_hi=c.bg_thresh_hi, bg_thresh_lo=c.bg_thresh_lo)
    if lidar:
        all_a3d = jnp.concatenate([a3d, gt[..., :7]], 1)
        pt = jax.vmap(lambda r4, v, a, gb, m, g7, k: j_tg.proposal_target(
            jnp.concatenate([jnp.zeros((r, 1)), r4], -1), jnp.zeros(r), v, a, gb, m, g7,
            jnp.zeros((1, 4)), jnp.zeros((1,), bool), k,
            jnp.asarray(c.lidar_bbox_normalize_means), jnp.asarray(c.lidar_bbox_normalize_stds),
            num_bbox_elem=7, is_lidar=True, **kw))(
            all_rois, all_valid, all_a3d, gt_bev, jb["gt_mask"], gt, jax.random.split(rng_pt, B))
    else:
        pt = jax.vmap(lambda r4, v, g, m, k: j_tg.proposal_target(
            jnp.concatenate([jnp.zeros((r, 1)), r4], -1), jnp.zeros(r), v, jnp.zeros((r, 7)), g,
            m, jnp.zeros((G, 8)), jnp.zeros((1, 4)), jnp.zeros((1,), bool), k,
            jnp.asarray(c.image_bbox_normalize_means), jnp.asarray(c.image_bbox_normalize_stds),
            **kw))(all_rois, all_valid, jb["gt_boxes"], jb["gt_mask"], jax.random.split(rng_pt, B))

    losses, g_total, mut = grads(variables["params"])
    # JAX's make_train_step: its optimizer chain on these gradients, the
    # whole variables tree as its state holds it (the statistics frozen), and
    # the statistics forward_train left written back (solver.py:86-88).  Not
    # its jitted step itself: that rounds its forward differently from the
    # forward the ReLU ties are read from, which can tip a C4-tail unit
    opt = j_optim.build_optimizer(variables, cfg)
    g_all = {"params": g_total,
             "batch_stats": jax.tree.map(jnp.zeros_like, variables["batch_stats"])}
    updates, _ = opt.update(g_all, opt.init(variables), variables)
    new_vars = {"params": optax.apply_updates(variables["params"], updates["params"]),
                "batch_stats": mut["batch_stats"]}
    new_vars = jax.tree.map(np.asarray, new_vars)

    def _eval(m, images, window):
        feats = m.features(images)
        feat = feats["pyramid"] if feats["pyramid"] is not None else feats["rpn"]
        return feat, m.rpn_scores(feats["rpn"])["fg_prob"], m.forward_test(images, window)

    j_feat, j_fg, j_out = jax.jit(partial(model.apply, method=_eval))(
        new_vars, jb["data"], jb["window"], rngs={"dropout": jax.random.PRNGKey(0)})
    return types.SimpleNamespace(
        src=np.asarray(src), valid=np.asarray(valid), labels=np.asarray(pt.labels),
        losses={k: float(v) for k, v in losses.items()},
        g_total={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(g_total)},
        stats={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(mut["batch_stats"])},
        new_params={flax_path_to_torch_key(p): np.asarray(v)
                    for p, v in _flat(new_vars["params"])},
        new_stats={flax_path_to_torch_key(p): np.asarray(v)
                   for p, v in _flat(new_vars["batch_stats"])},
        eval_feat=jax.tree.map(np.asarray, j_feat), eval_fg=np.asarray(j_fg),
        eval_out={k: np.asarray(v) for k, v in j_out.items()},
        n_rois=r, step_rng=step_rng,
    )


def _port(run):
    model = t_det.FasterRCNN(run.tcfg, K)
    load_flax_variables(model, run.variables)
    return model.train()


def _pin(run):
    return _t(run.j.src).long(), _t(run.j.valid)


def _forward(model, run, ties=None):
    """forward_train on JAX's draws and proposal lanes, each ReLU tie
    (run.ties, or `ties`) given JAX's gate."""
    tb = {k: _t(v) for k, v in run.batch.items()}
    with chip_smoke.pinned_ties(model, run.ties if ties is None else ties):
        return model.forward_train(tb["data"], tb["gt_boxes"], tb["gt_mask"], tb["window"],
                                   run.draws, proposals=_pin(run))


@pytest.fixture(scope="module", params=["c4", "fpn", "bev"])
def step_run(request):
    overrides = {"c4": IMAGE, "fpn": FPN, "bev": BEV}[request.param]
    lidar = request.param == "bev"
    cfg, tcfg = _cfgs(overrides)
    batch, variables, lanes = _train_batch(cfg, tcfg, lidar)
    j = _jax_run(cfg, variables, batch, jax.random.PRNGKey(3), lidar, lanes)
    probe = t_det.FasterRCNN(tcfg, K)
    n, r = probe.train_lane_counts(batch["data"].shape[1:3], G)
    assert r == j.n_rois
    draws = jax_draws(j.step_rng, B, n, r, G)
    run = types.SimpleNamespace(name=request.param, cfg=cfg, tcfg=tcfg, batch=batch,
                                variables=variables, j=j, draws=draws, lidar=lidar)
    run.ties = _relu_ties(lambda: _port(run), lambda m: _forward(m, run, ties=()),
                          _jax_intermediates(cfg, variables, batch, j.step_rng))
    return run


def test_live_step_ties_are_few_and_at_zero(step_run):
    """The ReLU units whose gate differs between the backends in train mode
    are few (the C4 tail's ReLUs see 64 x 49 x 512 units), each at 0
    within 1e-5 of its ReLU's max|input|."""
    ties = step_run.ties
    print(f"{step_run.name} ReLU ties: {ties}")
    assert len(ties) <= 24, ties
    for path, residual, at, jx, tx, scale in ties:
        assert max(abs(jx), abs(tx)) <= 1e-5 * scale, (path, residual, at, jx, tx, scale)


def test_live_step_losses_gradients_and_stats(step_run):
    """Labels identical; the four losses within rtol 1e-4; every trainable
    leaf's gradient (the stem and every BN affine among them) within 1e-3
    of its max; the running statistics forward_train leaves within 1e-5 of
    max of JAX's."""
    run = step_run
    model = _port(run)
    t_optim.DetectorSGD(model, run.tcfg)
    losses, aux = _forward(model, run)
    np.testing.assert_array_equal(aux.proposal_targets.labels.numpy(), run.j.labels)
    assert (run.j.labels > 0).sum() >= 4 and (run.j.labels == 0).sum() >= 4
    for k in LOSSES + ("total_loss",):
        np.testing.assert_allclose(float(losses[k].detach()), run.j.losses[k], rtol=1e-4,
                                   err_msg=k)
    assert all(run.j.losses[k] > 0 for k in LOSSES)
    for key, want in run.j.stats.items():
        _close(model.state_dict()[key].numpy(), want, 1e-5, key)
    losses["total_loss"].backward()
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert set(trained) == set(run.j.g_total)
    assert "backbone.conv1.weight" in trained and "backbone.bn1.weight" in trained
    worst = (0.0, None)
    for name, p in trained.items():
        want = _torch_layout(run.j.g_total[name])
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max() + 1e-12,
                                   err_msg=name)
        worst = max(worst, (float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12)), name))
    print(f"{run.name}: largest gradient error / max|g| {worst}")


def test_live_step_update_and_eval_forward(step_run):
    """make_train_step against JAX's (its optimizer chain on the gradients
    test_live_step_losses_gradients_and_stats holds): every parameter's
    update within 1e-3 of its max (plus float32 rounding of the parameter),
    the running statistics within 1e-5 of max; then an eval forward on the updated
    statistics at the serving slices' tolerances: the features within 1e-4
    of max, fg_prob within 2e-3, and the second stage on JAX's eval rois:
    cls_prob within 3e-3 of max and the boxes within 0.15."""
    run = step_run
    model = _port(run)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step = t_solver.make_train_step(model, t_optim.DetectorSGD(model, run.tcfg))
    tb = {k: _t(v) for k, v in run.batch.items()}
    with chip_smoke.pinned_ties(model, run.ties):
        losses, _ = step(tb, run.draws, _pin(run))
    np.testing.assert_allclose(float(losses["total_loss"]), run.j.losses["total_loss"], rtol=1e-4)
    for name, p in model.named_parameters():
        w = _torch_layout(run.j.new_params[name])
        want, got = w - start[name].numpy(), (p.detach() - start[name]).numpy()
        atol = 1e-3 * np.abs(want).max() + 1e-6 * np.abs(start[name].numpy()).max()
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)
    for key, want in run.j.new_stats.items():
        _close(model.state_dict()[key].numpy(), want, 1e-5, key)
        assert not np.array_equal(want, start[key].numpy()), key
    j = run.j.eval_out
    with eval_mode(model), torch.no_grad():
        feat = model.features(tb["data"])
        fg = model.rpn_scores(feat)["fg_prob"]
        cls_prob, boxes = model.classify_rois(
            tuple(_t(f) for f in run.j.eval_feat) if isinstance(feat, tuple)
            else _t(run.j.eval_feat), _t(j["rois"]), tb["window"],
            _t(j["anchors_3d"]) if run.lidar else None)
    assert model.training
    for got, want in zip(feat if isinstance(feat, tuple) else (feat,),
                         run.j.eval_feat if isinstance(feat, tuple) else (run.j.eval_feat,)):
        _close(got.numpy(), want, 1e-4, "eval features")
    np.testing.assert_allclose(fg.numpy(), run.j.eval_fg, atol=2e-3)
    _close(cls_prob.numpy(), j["cls_prob"], 3e-3, "eval cls_prob")
    np.testing.assert_allclose(boxes.numpy(), j["bbox_pred"], atol=0.15)
