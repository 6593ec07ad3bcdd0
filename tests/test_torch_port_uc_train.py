"""One training step with uncertainty, the PyTorch port against the JAX
package's jitted step, on the CPU: all eight UC.* flags with live BN
(RESNET.FIXED_BLOCKS -1), the res50 image C4 detector on two 96x128 frames
and the res18 LiDAR BEV detector on two 200 x 175 x 15 rasters.

The losses (the RPN's and the detection Bayesian cross-entropies, the
attenuated box losses and a_mutual_info) within rtol 1e-4; every trainable
leaf's gradient (the variance heads, the epistemic stacks and their BN, the
RPN's variance convs among them) within 1e-3 of its max|g|, each ReLU tie
given JAX's gate (chip_smoke.pinned_ties); the running statistics within
1e-5 of max; and the step's dropout live.  The port records the dropout
masks it draws and JAX's CheapDropout takes them
(test_torch_port_uc._jax_draws_alike); the port is handed the normals JAX
draws from its step key chain (rng_cls and fold_in(rng_cls, 3)), JAX's draws
for the targets (test_torch_port_train.jax_draws) and JAX's proposal lanes.
"""

from __future__ import annotations

import types
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import optim as t_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    load_flax_variables,
)
from tests.test_torch_port_fpn import _jax_site, _torch_layout  # noqa: E402
from tests.test_torch_port_live_bn import _raster  # noqa: E402
from tests.test_torch_port_train import _flat, jax_draws  # noqa: E402
from tests.test_torch_port_uc import (  # noqa: E402
    BEV,
    IMAGE,
    LIVE18,
    _cfgs,
    _jax_draws_alike,
    _jax_masks,
    _rel,
    _shared_variables,
    _t,
)

import chip_smoke  # noqa: E402  (the repo root is on sys.path: test_torch_port_live_bn)

B, K, G = 2, 2, 8
H, W = 96, 128
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box", "a_mutual_info")


def _stages_uc(m, images, window):
    """JAX forward_train's train-phase proposals, its dropout live."""
    feats = m.features(images, False, True)
    rpn = m.rpn_scores(feats["rpn"])
    rpn["anchors"] = m._anchors(feats["rpn"])
    rois, _s, a3d, valid, src = m._propose_batch(rpn, window, "train")
    return rois, a3d, valid, src


def _frames(tcfg, lidar, rng):
    if lidar:
        return _raster(tcfg, seed=6)
    x = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    return x, np.array([[0, W, 0, H], [0, W - 40, 0, H - 24]], np.float32)


def _train_batch(cfg, tcfg, x, window, lidar, masks, rng):
    """The shared live-BN weights and GT on some of JAX's proposals (as
    test_torch_port_live_bn does), JAX's dropout taking `masks`."""
    model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    variables = _shared_variables(tcfg)
    with _jax_draws_alike(masks):
        lanes = tuple(np.asarray(a) for a in jax.jit(partial(model.apply, method=_stages_uc))(
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


def _recorded_draws(tcfg, x, window, lidar):
    """The masks a port training forward draws on frames `x` (and the
    normals' shapes), on a throwaway model with one GT box a frame."""
    model = t_det.FasterRCNN(tcfg, K).train()
    x, window = _t(x), _t(window)
    if lidar:
        gt = torch.zeros((B, G, 8))
        gt[:, 0] = torch.tensor([20.0, 20.0, 1.0, 8.0, 4.0, 2.0, 0.0, 1.0])
    else:
        gt = torch.zeros((B, G, 5))
        gt[:, 0] = torch.tensor([10.0, 10.0, 60.0, 50.0, 1.0])
    mask = torch.zeros((B, G), dtype=torch.bool)
    mask[:, 0] = True
    n, r = model.train_lane_counts(tuple(x.shape[1:3]), G)
    gen = torch.Generator().manual_seed(3)
    rec = t_det.UCDraws(gen, record=True)
    draws = t_det.TrainDraws(*(torch.rand((B, m), generator=gen) for m in (n, n, r, r)),
                             torch.zeros((B, G, 4)), rec)
    with torch.no_grad():
        model.forward_train(x, gt, mask, window, draws)
    return rec


def _site(inter, path, residual):
    """JAX's input to a relu_sites ReLU, the stacks' too (the class stack is
    EpistemicStack_0, the box stack _1: both are on here)."""
    parts = path.split(".")
    if parts[0] == "predictors":
        i = 0 if parts[1] == "cls_stack" else 1
        return np.asarray(inter["predictors"][f"EpistemicStack_{i}"][parts[2]]["__call__"][0])
    return _jax_site(inter, path, residual)


def _relu_ties(make_port, forward, inter, rounds=4):
    """test_torch_port_fpn._relu_ties with the stacks' ReLUs among the sites,
    each ReLU's input within 5e-4 of its max of JAX's (not 1e-4: both sides
    rebuild the proposals' boxes from their own RPN deltas, and with the
    backbone's dropout doubling its activations the pooled RoIs of some
    proposals move by the deltas' rounding: 1.3e-4 on 29 of 64 RoIs of the
    image run's C4 tail, median 5e-7)."""
    ties = []
    for _ in range(rounds):
        model = make_port()
        with chip_smoke.pinned_ties(model, ties), chip_smoke.relu_inputs(model) as got:
            with torch.no_grad():
                forward(model)
        want = {}
        for (path, residual), tx in got.items():
            jx = _site(inter, path, residual)
            jx = np.transpose(jx, (0, 3, 1, 2)) if jx.ndim == 4 else jx
            assert np.abs(tx.numpy() - jx).max() <= 5e-4 * np.abs(jx).max() + 1e-12, path
            want[(path, residual)] = torch.from_numpy(np.ascontiguousarray(jx))
        new = chip_smoke.find_ties(want, got, skip={t[:3] for t in ties})
        if not new:
            break
        ties += new
    return ties


@pytest.fixture(scope="module", params=["image", "bev"])
def train_run(request):
    lidar = request.param == "bev"
    overrides = (BEV if lidar else IMAGE) + (LIVE18 if lidar else ("RESNET.FIXED_BLOCKS", "-1"))
    cfg, tcfg = _cfgs(overrides)
    rng = np.random.RandomState(1)
    x, window = _frames(tcfg, lidar, rng)
    rec = _recorded_draws(tcfg, x, window, lidar)
    masks = _jax_masks(rec.masks)
    batch, variables, lanes = _train_batch(cfg, tcfg, x, window, lidar, masks, rng)
    step_rng = jax.random.fold_in(jax.random.PRNGKey(3), jnp.int32(0))
    rng_cls = jax.random.split(step_rng, 3)[2]
    normals = {"rpn_ce": np.asarray(jax.random.normal(jax.random.fold_in(rng_cls, 3),
                                                      tuple(rec.normals["rpn_ce"].shape))),
               "ce": np.asarray(jax.random.normal(rng_cls, tuple(rec.normals["ce"].shape)))}
    model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def losses_fn(params):  # every module's output too, for the ReLU ties
        losses, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb["data"],
            jb["gt_boxes"], jb["gt_mask"], jb["window"], step_rng,
            method=j_det.FasterRCNN.forward_train, capture_intermediates=True,
            mutable=["intermediates", "batch_stats"])
        return losses["total_loss"], (losses, mut)

    with _jax_draws_alike(masks):
        (_, (losses, mut)), grads = jax.jit(jax.value_and_grad(losses_fn, has_aux=True))(
            variables["params"])
    inter = mut["intermediates"]
    n, r = t_det.FasterRCNN(tcfg, K).train_lane_counts(batch["data"].shape[1:3], G)
    base = jax_draws(step_rng, B, n, r, G)
    run = types.SimpleNamespace(
        name=request.param, tcfg=tcfg, batch=batch, variables=variables, lidar=lidar,
        src=_t(lanes[3]).long(), valid=_t(lanes[2]),
        losses={k: float(v) for k, v in losses.items()},
        grads={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(grads)},
        stats={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(mut["batch_stats"])},
    )
    run.draws = lambda: base._replace(uc=t_det.UCDraws(
        masks=rec.masks, normals={k: _t(v) for k, v in normals.items()}))
    run.ties = _relu_ties(lambda: _port(run), lambda m: _forward(m, run, ties=()), inter)
    return run


def _port(run):
    model = t_det.FasterRCNN(run.tcfg, K)
    load_flax_variables(model, run.variables)
    return model.train()


def _forward(model, run, ties=None):
    tb = {k: _t(v) for k, v in run.batch.items()}
    with chip_smoke.pinned_ties(model, run.ties if ties is None else ties):
        return model.forward_train(tb["data"], tb["gt_boxes"], tb["gt_mask"], tb["window"],
                                   run.draws(), proposals=(run.src, run.valid))


def test_train_step_losses_gradients_and_stats(train_run):
    """The losses (the Bayesian CEs, the attenuated box losses and
    a_mutual_info) within rtol 1e-4; every trainable leaf's gradient (the
    variance heads, the stacks, the RPN variance convs among them) within
    1e-3 of its max|g|, the ReLU ties few, at 0 and pinned; the running
    statistics within 1e-5 of max."""
    run = train_run
    print(f"{run.name} ReLU ties: {[t[:3] for t in run.ties]}")
    # the res50 tail alone has 64 RoIs x 49 x 9,216 ReLU units
    assert len(run.ties) <= 64
    for *_, jx, tx, scale in run.ties:
        assert max(abs(jx), abs(tx)) <= 1e-5 * scale
    model = _port(run)
    t_optim.DetectorSGD(model, run.tcfg)
    losses, _aux = _forward(model, run)
    for k in LOSSES + ("total_loss",):
        np.testing.assert_allclose(float(losses[k].detach()), run.losses[k], rtol=1e-4, err_msg=k)
        assert np.isfinite(run.losses[k]) and run.losses[k] != 0, k
    for key, want in run.stats.items():
        assert _rel(model.state_dict()[key].numpy(), want) <= 1e-5, key
    losses["total_loss"].backward()
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    want_keys = {k for k in run.grads if not k.endswith(("running_mean", "running_var"))}
    assert set(trained) == want_keys
    assert {"rpn_cls_al_var_net.weight", "predictors.cls_al_var_net.weight",
            "predictors.bbox_stack.bbox_fc2.weight"} <= set(trained)
    if run.lidar:
        assert "predictors.cls_stack.cls_bn1.weight" in trained
    worst = (0.0, None)
    for name, p in trained.items():
        want = _torch_layout(run.grads[name])
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max() + 1e-12,
                                   err_msg=name)
        worst = max(worst, (float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12)), name))
    print(f"{run.name}: largest gradient error / max|g| {worst}")


def test_train_step_draws_live_dropout(train_run):
    """The step's dropout is live: other masks give other second-stage
    losses, and at res50 other RPN losses (the backbone's Bottlenecks drop);
    at res18 the RPN's stay (BasicBlock has no dropout)."""
    run = train_run
    model = _port(run)
    flipped = {k: ~v for k, v in run.draws().uc.masks.items()}
    tb = {k: _t(v) for k, v in run.batch.items()}
    draws = run.draws()
    draws = draws._replace(uc=t_det.UCDraws(masks=flipped, normals=draws.uc.normals))
    with torch.no_grad():
        losses, _ = model.forward_train(tb["data"], tb["gt_boxes"], tb["gt_mask"], tb["window"],
                                        draws, proposals=(run.src, run.valid))
    changed = {k: abs(float(losses[k]) / run.losses[k] - 1) for k in LOSSES}
    print(f"{run.name}: relative change of each loss under the flipped masks {changed}")
    assert changed["a_mutual_info"] > 1e-3 and changed["loss_box"] > 1e-3, changed
    if run.lidar:  # res18: BasicBlock has no dropout, the stacks have
        assert changed["rpn_cross_entropy"] == changed["rpn_loss_box"] == 0.0, changed
    else:
        assert changed["rpn_loss_box"] > 1e-3, changed

