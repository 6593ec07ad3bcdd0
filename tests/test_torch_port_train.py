"""The training step, port vs the JAX package, at res50 on 128x192 frames,
batch 2, ROI_BATCH_SIZE 32, NMS_PRE_TRAIN 256 -> 64, float32, on the CPU.

Both detectors share one set of weights (the flax init, BN statistics
randomized from a numpy seed, residual terminators at 0.25 as bench.py
does) and one batch.  The port gets the JAX package's own random draws,
rebuilt from its key chain: fold_in(rng, step) -> split(3) -> split(B) ->
split(2) -> uniform, and fold_in(., 7) for the GT noise.  Its second stage
is pinned to the JAX proposal lanes (the RPN scores of the two backends
differ in the last bits, which could reorder near-tied proposals), so that
the comparison isolates the training math.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list, default_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import targets as j_tg  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.training import optim as j_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.training import solver as j_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as t_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training.optim import DetectorSGD  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    load_flax_variables,
)

B, H, W, K, G = 2, 128, 192, 2, 8
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box")


OVERRIDES = (
    "NET_TYPE", "image",
    "NET_VARIANT", "res50",
    "COMPUTE_DTYPE", "float32",
    "PIXEL_STDDEVS", "[60.,60.,60.]",
    "TRAIN.ROI_BATCH_SIZE", "32",
    "STATIC.NMS_PRE_TRAIN", "256",
    "TRAIN.RPN_POST_NMS_TOP_N", "64",
    "TRAIN.RPN_BATCHSIZE", "64",
    "STATIC.MAX_GT", str(G),
    "TRAIN.USE_GT", "True",
    "TRAIN.USE_GT_NOISE", "True",
    "TRAIN.LEARNING_RATE", "0.01",
    "TRAIN.MOMENTUM", "0.9",
)


def _cfg(*extra):
    """The JAX package's config."""
    return cfg_from_list(default_config(), OVERRIDES + extra)


def _tcfg(*extra):
    """The port's config, from the same overrides."""
    return t_config.cfg_from_list(t_config.default_config(), OVERRIDES + extra)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _shared_variables(model, x, window):
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(window))
    rng = np.random.RandomState(0)
    params = {}
    for path, v in _flat(variables["params"]):
        v = np.array(v, np.float32)
        if path[-1] == "mean":
            v = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif path[-1] == "var":
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif path[-2:] == ("bn3", "scale"):
            v = np.full_like(v, 0.25)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return {"params": params}


def _stages(m, images, window):
    feats = m.features(images)
    rpn = m.rpn_scores(feats["rpn"])
    rpn["anchors"] = m._anchors(feats["rpn"])
    rois, _s, _a, valid, src = m._propose_batch(rpn, window, "train")
    return rois, valid, src


def _batch(cfg):
    """Frames, windows and the shared weights; GT boxes are jittered copies
    of some of the JAX proposals (which do not depend on the GT), so that
    proposals, and not only the appended GT boxes, are sampled as fg and
    loss_box reaches the RPN through them."""
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    window = np.array([[0, W, 0, H], [0, W - 40, 0, H - 24]], np.float32)
    j_model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    variables = _shared_variables(j_model, x, window)
    rois, valid, _src = (np.asarray(a) for a in j_model.apply(
        variables, jnp.asarray(x), jnp.asarray(window), method=_stages))
    gt = np.zeros((B, G, 5), np.float32)
    mask = np.zeros((B, G), bool)
    for i, n in enumerate([3, 5]):
        picks = rois[i][valid[i]][::7][:n]
        gt[i, :n, :4] = picks + rng.uniform(-2, 2, picks.shape)
        gt[i, :n, 4] = 1
        mask[i, :n] = True
    return {"data": x, "gt_boxes": gt, "gt_mask": mask, "window": window}, variables


def jax_draws(step_rng, b, n, r, g):
    """The uniform keys and GT noise that JAX forward_train draws with
    `step_rng`, as a port TrainDraws."""
    rng_at, rng_pt, _rng_cls = jax.random.split(step_rng, 3)

    def two(key, size):
        fg, bg = [], []
        for k in jax.random.split(key, b):
            kf, kb = jax.random.split(k)
            fg.append(np.asarray(jax.random.uniform(kf, (size,))))
            bg.append(np.asarray(jax.random.uniform(kb, (size,))))
        return torch.from_numpy(np.stack(fg)), torch.from_numpy(np.stack(bg))

    noise = np.asarray(jax.random.normal(jax.random.fold_in(step_rng, 7), (b, g, 4)))
    return t_det.TrainDraws(*two(rng_at, n), *two(rng_pt, r), torch.from_numpy(noise))


def _jax_run(cfg, variables, batch, rng):
    """JAX proposals, sampled labels, losses and gradients (total and
    loss_box alone) at step 0, and the parameters after make_train_step."""
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

    rois, valid, src = model.apply(variables, jb["data"], jb["window"], method=_stages)
    # the second-stage sampling of forward_train, from its own key chain
    _rng_at, rng_pt, _ = jax.random.split(step_rng, 3)
    gt4 = jb["gt_boxes"][..., :4]
    gw = gt4[..., 2] - gt4[..., 0]
    gh = gt4[..., 3] - gt4[..., 1]
    gt4 = gt4 + (jax.random.normal(jax.random.fold_in(step_rng, 7), gt4.shape) * 0.03
                 * jnp.stack([gw, gh, gw, gh], -1))
    all_rois = jnp.concatenate([rois, gt4], 1)
    all_valid = jnp.concatenate([valid, jb["gt_mask"]], 1)
    r = all_rois.shape[1]
    c = cfg.train
    pt = jax.vmap(lambda r4, v, g, m, k: j_tg.proposal_target(
        jnp.concatenate([jnp.zeros((r, 1)), r4], -1), jnp.zeros(r), v, jnp.zeros((r, 7)), g, m,
        jnp.zeros((G, 8)), jnp.zeros((1, 4)), jnp.zeros((1,), bool), k,
        jnp.asarray(c.image_bbox_normalize_means), jnp.asarray(c.image_bbox_normalize_stds),
        num_classes=K, roi_batch_size=c.roi_batch_size, fg_fraction=c.fg_fraction,
        fg_thresh=c.fg_thresh, bg_thresh_hi=c.bg_thresh_hi, bg_thresh_lo=c.bg_thresh_lo))(
        all_rois, all_valid, jb["gt_boxes"], jb["gt_mask"], jax.random.split(rng_pt, B))

    losses, g_total, g_box = grads(variables["params"])
    # TrainState.params holds the whole variables dict, as create_train_state makes it
    opt = j_optim.build_optimizer(variables, cfg)
    state = j_det.TrainState(params=variables, opt_state=opt.init(variables),
                             step=jnp.zeros((), jnp.int32))
    new_state, _ = j_solver.make_train_step(model, opt)(state, jb, rng)
    return types.SimpleNamespace(
        src=np.asarray(src), valid=np.asarray(valid), labels=np.asarray(pt.labels),
        losses={k: float(v) for k, v in losses.items()},
        g_total={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(g_total)},
        g_box={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(g_box)},
        new_params={flax_path_to_torch_key(p): np.asarray(v)
                    for p, v in _flat(new_state.params["params"])},
        n_rois=r, step_rng=step_rng,
    )


@pytest.fixture(scope="module")
def run():
    cfg = _cfg()
    batch, variables = _batch(cfg)
    j = _jax_run(cfg, variables, batch, jax.random.PRNGKey(3))
    n = (H // 16) * (W // 16) * cfg.num_anchors
    draws = jax_draws(j.step_rng, B, n, j.n_rois, G)
    return types.SimpleNamespace(cfg=cfg, tcfg=_tcfg(), batch=batch, variables=variables, j=j,
                                 draws=draws)


def _port(cfg, variables):
    model = t_det.FasterRCNN(cfg, K)
    load_flax_variables(model, variables)
    return model


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _forward(model, run, **kw):
    tb = _tensors(run.batch)
    pin = (torch.from_numpy(run.j.src).long(), torch.from_numpy(run.j.valid))
    return model.forward_train(tb["data"], tb["gt_boxes"], tb["gt_mask"], tb["window"],
                               run.draws, proposals=pin, **kw)


def _assert_grads_close(model, want, min_leaves, rtol_max=1e-3):
    """Each trainable leaf's gradient within rtol_max * max|g| of that leaf
    (float32 convolutions in two backends, summed in different orders)."""
    n = 0
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        w = want[name]
        w = np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else (w.T if w.ndim == 2 else w)
        got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        scale = np.abs(w).max()
        np.testing.assert_allclose(got, w, atol=rtol_max * scale + 1e-12, err_msg=name)
        n += 1
    assert n >= min_leaves


def test_lanes_and_sampled_labels_identical(run):
    """The port's own proposal lanes on the JAX scores agree with JAX's, its
    anchor targets use the same lanes, and (pinned) it samples the same
    second-stage labels from the JAX draws."""
    model = _port(run.tcfg, run.variables)
    with torch.no_grad():
        losses, aux = _forward(model, run)
    np.testing.assert_array_equal(aux.proposal_targets.labels.numpy(), run.j.labels)
    assert (run.j.labels > 0).sum() >= 4 and (run.j.labels == 0).sum() >= 4
    assert run.j.valid.sum() >= B * 32
    # unpinned: the port's NMS on its own scores picks the same lanes here
    feat = model.features(torch.from_numpy(run.batch["data"]))
    rpn = model.rpn_scores(feat)
    anchors = model.anchors(feat.shape[1], feat.shape[2], feat.device, "train")
    src, valid = model.select_proposals(rpn, anchors, torch.from_numpy(run.batch["window"]))
    np.testing.assert_array_equal(valid.numpy(), run.j.valid)
    np.testing.assert_array_equal(src.numpy()[valid.numpy()], run.j.src[run.j.valid])


def test_losses_and_gradients(run):
    """Losses within rtol 1e-4; every trainable leaf's gradient within
    1e-3 * its max."""
    model = _port(run.tcfg, run.variables)
    DetectorSGD(model, run.tcfg)  # sets requires_grad from the frozen mask
    losses, _ = _forward(model, run)
    for k in LOSSES + ("total_loss",):
        np.testing.assert_allclose(float(losses[k]), run.j.losses[k], rtol=1e-4, err_msg=k)
    assert all(run.j.losses[k] > 0 for k in LOSSES)
    losses["total_loss"].backward()
    _assert_grads_close(model, run.j.g_total, min_leaves=50)


def test_loss_box_reaches_the_rpn_through_the_proposals(run):
    """Fault F1, kept in the port: loss_box alone sends gradient into the
    RPN bbox conv, through the differentiable proposal boxes of the
    regression targets; in the JAX package and in the port alike."""
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
    # the other leaves at 3e-3 * max|g|: this small loss alone is more
    # sensitive to ReLU units that sit at 0 within rounding in one backend
    _assert_grads_close(model, run.j.g_box, min_leaves=50, rtol_max=3e-3)


def test_one_train_step_matches_make_train_step(run):
    """Port make_train_step (forward, backward, DetectorSGD) vs JAX
    make_train_step: each trainable leaf's update within 1e-3 * its max
    plus float32 rounding of the parameter."""
    model = _port(run.tcfg, run.variables)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    step = t_solver.make_train_step(model, DetectorSGD(model, run.tcfg))
    tb = _tensors(run.batch)
    pin = (torch.from_numpy(run.j.src).long(), torch.from_numpy(run.j.valid))
    losses, _ = step(tb, run.draws, pin)
    np.testing.assert_allclose(float(losses["total_loss"]), run.j.losses["total_loss"], rtol=1e-4)
    moved = 0
    for name, p in model.named_parameters():
        w = run.j.new_params[name]
        w = np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else (w.T if w.ndim == 2 else w)
        want, got = w - start[name].numpy(), (p.detach() - start[name]).numpy()
        atol = 1e-3 * np.abs(want).max() + 1e-6 * np.abs(start[name].numpy()).max()
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)
        moved += bool(np.abs(want).max() > 0)
    assert moved == sum(p.requires_grad for p in model.parameters()) >= 50


def test_rpn_only_forward_train(run):
    """ENABLE_FULL_NET False: the RPN losses alone, equal to JAX's, and no
    gradient into the second stage."""
    cfg = run.tcfg.replace(enable_full_net=False)
    model = _port(cfg, run.variables)
    DetectorSGD(model, cfg)
    tb = _tensors(run.batch)
    losses, aux = model.forward_train(tb["data"], tb["gt_boxes"], tb["gt_mask"], tb["window"],
                                      run.draws)
    for k in ("rpn_cross_entropy", "rpn_loss_box"):
        np.testing.assert_allclose(float(losses[k]), run.j.losses[k], rtol=1e-4, err_msg=k)
    assert float(losses["cross_entropy"]) == float(losses["loss_box"]) == 0.0
    assert aux.proposal_targets is None
    losses["total_loss"].backward()
    assert model.predictors.cls_score_net.weight.grad is None
    assert model.rpn.rpn_cls_score_net.weight.grad is not None


def test_train_anchors_follow_scale_idx(run):
    """Multi-scale TRAIN.SCALES: the minibatch's scale_idx selects the grid,
    as the JAX package's _anchors does."""
    cfg = _cfg("TRAIN.SCALES", "(0.5, 1.0, 1.5)")
    j_model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    feat = jnp.zeros((1, H // 16, W // 16, 1024))
    model = t_det.FasterRCNN(_tcfg("TRAIN.SCALES", "(0.5, 1.0, 1.5)"), K)
    for idx in (0, 2):
        want, _ = j_model.apply(run.variables, feat, scale_idx=jnp.int32(idx),
                                method=j_det.FasterRCNN._anchors)
        got = model.anchors(H // 16, W // 16, torch.device("cpu"), "train", scale_idx=idx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.equal(model.anchors(8, 12, "cpu", "train", 0),
                           model.anchors(8, 12, "cpu", "train", 2))


def test_train_loss_decreases():
    """The counterpart of tests/test_train_smoke.py: four steps of the port's
    train loop on one repeated synthetic batch; finite losses that fall."""
    cfg = _tcfg()
    ds = SyntheticDataset(cfg, num_frames=B, num_classes=K, image_hw=(H, W))
    loader = BatchLoader(ds, cfg, batch_size=B, device="cpu", augment=False, shuffle=False, seed=0)
    model, opt = t_solver.create_train_state(cfg, K, "cpu", seed=0)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith(".bn3"):
                m.weight.fill_(0.25)
    res = t_solver.train(model, opt, loader, 4, torch.Generator().manual_seed(0))
    totals = [loss["total_loss"] for loss in res["losses"]]
    assert all(np.isfinite(t) for t in totals)
    assert totals[-1] < totals[0], totals
    assert len(res["ms"]) == 4


def test_bf16_step_trains_float32_masters(run):
    """COMPUTE_DTYPE bfloat16: the forward runs on bf16 casts of every
    float32 parameter and buffer, and the gradients and updates land on
    the float32 masters (as cast_for_compute in the JAX package)."""
    cfg = _tcfg("COMPUTE_DTYPE", "bfloat16")
    model = _port(cfg, run.variables)
    casts = t_solver.cast_for_compute(model)
    assert all(v.dtype == torch.bfloat16 for v in casts.values())
    assert set(casts) == set(model.state_dict())
    start = {k: v.clone() for k, v in model.named_parameters()}
    opt = DetectorSGD(model, cfg)
    step = t_solver.make_train_step(model, opt)
    tb = _tensors(run.batch)
    pin = (torch.from_numpy(run.j.src).long(), torch.from_numpy(run.j.valid))
    losses, aux = step(tb, run.draws, pin)
    assert all(np.isfinite(float(v)) for v in losses.values())
    # bf16 rounding moves the losses, not the sampling of this batch
    np.testing.assert_array_equal(aux.proposal_targets.labels.numpy(), run.j.labels)
    np.testing.assert_allclose(float(losses["total_loss"]), run.j.losses["total_loss"], rtol=0.05)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        if p.requires_grad:
            assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
            assert not torch.equal(p.detach(), start[name]), name
        else:
            assert p.grad is None and torch.equal(p.detach(), start[name])
