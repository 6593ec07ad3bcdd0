"""Uncertainty on the FPN detector, the PyTorch port against the JAX
package, on the CPU, in float32: res50 FPN (POOLING_MODE multiscale) with
all eight UC.* flags on two 64x96 frames, 6 anchors a p2 cell.

Serving (forward_test, T = 2 Monte-Carlo samples): the RPN stage's samples
run the pyramid's Bottlenecks with their dropout live, the FPN and the RPN
on p2; the detection stage's run FCTail (no dropout, JAX heads.py:62-78)
and the predictors' epistemic stacks over the RoIs pooled once by
multiscale RoI align.  rois, cls_prob, the decoded boxes and every key of
`uncertainties` and `rpn_uncertainties` within 5e-5 of max|x| (the
cancelling keys within a few float32 roundoffs beside it,
test_torch_port_uc._cancellation_slack), and each MC sample within 5e-5
(SERVING_TOL: not the C4 tests' 1e-5.  The pyramid agrees within 3.4e-6
of its max and the RPN's logits within 2.7e-6; the softmax puts that on
fg_prob (1.7e-5 of its max of 1), the proposals rebuilt from the samples'
mean deltas carry 1e-5 of the frame into the multiscale pooling, and the
head's samples, pooled at those boxes, reach 2.7e-5, over two weight
draws.  test_torch_port_fpn holds the FPN without uncertainty to 1e-4.)

Training (one step from scratch at res50, FIXED_BLOCKS -1: live BN; the
pyramid's Bottlenecks drop, layer4 among them, and so do the stacks): the
Bayesian cross-entropies, the attenuated box losses and a_mutual_info
within rtol 1e-4 of JAX's jitted forward_train, every trainable leaf's
gradient within 1e-3 of its max|g| (each ReLU tie given JAX's gate), the
running statistics within 1e-5 of max, the dropout live in the step.

The two sides draw alike as in test_torch_port_uc: the port records its
dropout masks and JAX's CheapDropout takes them, JAX's MC scan runs one
sample a step, and the port takes the normals JAX draws.
"""

from __future__ import annotations

import types

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
    from_flax_variables,
)
from tests.test_torch_port_backbones import _clipped_normal, _port  # noqa: E402
from tests.test_torch_port_fpn import _torch_layout  # noqa: E402
from tests.test_torch_port_train import _flat, jax_draws  # noqa: E402
from tests.test_torch_port_uc import (  # noqa: E402
    EPS32,
    IMAGE,
    TEST_KEY,
    T,
    _cancellation_slack,
    _cfgs,
    _jax_draws_alike,
    _jax_masks,
    _rel,
    _shared_variables,
    _t,
)
from tests.test_torch_port_uc_train import (  # noqa: E402
    _recorded_draws,
    _relu_ties,
    _train_batch,
)

B, K, G = 2, 2, 8
H, W = 64, 96
# anchors of 32 and 64 px at each p2 cell, as the JAX package's FPN
# uncertainty tests set them for these frames (tests/test_uncertainty_fpn.py
# _TINY): the default 128-512 px anchors over a 96 px frame scale the RPN
# deltas' float32 rounding by the anchor size into the clipped proposals
# (1.6e-5 of the frame where the pyramid agrees within 3e-6)
FPN_UC = IMAGE + ("USE_FPN", "True", "POOLING_MODE", "multiscale",
                  "ANCHOR_SCALES", "[2,4]", "ANCHOR_RATIOS", "[0.5,1,2]")
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box", "a_mutual_info")
SERVING_TOL = 5e-5  # of max|x|; see the module docstring


def _variables(tcfg):
    """test_torch_port_uc._shared_variables, init_params' truncated normals
    drawn faster (test_torch_port_backbones._clipped_normal)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_det, "_trunc_normal", _clipped_normal)
        return _shared_variables(tcfg)


def _frames(seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    return x, np.array([[0, W, 0, H], [0, W - 40, 0, H - 24]], np.float32), rng


# -- serving ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving_run():
    cfg, tcfg = _cfgs(FPN_UC)
    x, window, _ = _frames(2)
    variables = _variables(tcfg)
    port = _port(tcfg, variables).eval()
    a, p = cfg.uc.a_num_ce_sample, cfg.test.rpn_post_nms_top_n
    normals = {"rpn_ce": np.asarray(jax.random.normal(TEST_KEY, (a, B, p, 2))),
               "ce": np.asarray(jax.random.normal(TEST_KEY, (a, B, p, K)))}
    draws = t_det.UCDraws(torch.Generator().manual_seed(0), record=True,
                          normals={k: _t(v) for k, v in normals.items()})
    samples, mc = [], port._mc_samples
    port._mc_samples = lambda *a: samples.append(mc(*a)) or samples[-1]
    with torch.no_grad():
        got = port.forward_test(_t(x), _t(window), draws)
    model = j_det.FasterRCNN(cfg=cfg, num_classes=K)

    def forward_test(v, images, win):  # and the MC samples, (RPN, head)
        from tests.test_torch_port_uc import _INJECT

        return model.apply(v, images, win, method=j_det.FasterRCNN.forward_test), _INJECT["samples"]

    with _jax_draws_alike(_jax_masks(draws.masks)):
        want, j_samples = jax.tree.map(np.asarray, jax.jit(forward_test)(
            variables, jnp.asarray(x), jnp.asarray(window)))
    return types.SimpleNamespace(got=got, want=want, masks=draws.masks, samples=samples,
                                 j_samples=j_samples, port=port)


def test_fpn_uc_serving_masks(serving_run):
    """The recorded masks: the pyramid's Bottlenecks, layer4 among them (it
    lives in the FPN backbone), for the RPN samples, and both stacks' two
    layers for the head's; FCTail has none.  One a sample."""
    names = set(serving_run.masks)
    assert {"backbone.layer1.0.drop2d", "backbone.layer4.2.drop3"} <= names
    assert {"predictors.cls_stack.cls_drop2", "predictors.bbox_stack.bbox_drop1"} <= names
    assert not any(n.startswith(("tail.", "fpn.")) for n in names)
    assert all(m.shape[0] == T for m in serving_run.masks.values())
    assert isinstance(serving_run.got["rois"], torch.Tensor)
    assert serving_run.port.flat_tail


def test_fpn_uc_serving_outputs_match_jax(serving_run):
    """rois and their validity, the proposals' scores, cls_prob (the mean of
    the T softmaxes) and the decoded boxes within SERVING_TOL of max|x|."""
    got, want = serving_run.got, serving_run.want
    np.testing.assert_array_equal(got["roi_valid"].numpy(), want["roi_valid"])
    assert want["roi_valid"].sum() >= B * 8
    for k in ("rois", "roi_scores", "cls_prob", "bbox_pred"):
        assert _rel(got[k].numpy(), want[k]) <= SERVING_TOL, k


def test_fpn_uc_mc_samples_match_jax(serving_run):
    """Each MC sample of the RPN stage (pyramid, FPN and RPN with the
    Bottlenecks' dropout live: logits, fg_prob, deltas, the log-variances)
    and of the head (FCTail and the predictors over the multiscale-pooled
    RoIs) within SERVING_TOL of max of JAX's."""
    rpn, det = serving_run.samples
    j_rpn, j_det_out = serving_run.j_samples
    for got, want in ((rpn, j_rpn), (det, j_det_out)):
        assert set(want) <= set(got)
        for k in want:
            assert got[k].shape[0] == T
            assert _rel(got[k].numpy(), want[k]) <= SERVING_TOL, k
    # the RPN samples differ: the pyramid's dropout is a source
    assert (rpn["fg_prob"][0] - rpn["fg_prob"][1]).abs().max() > 1e-3


def _slack(key: str, classes: int) -> float:
    """_cancellation_slack, and for an entropy the same 4 float32 roundoffs
    of its terms: the RPN's near-certain proposals (p within 1e-4 of 1)
    have entropies of ~1e-3 bits, where p's rounding (an eps) is 7e-5 of
    the max."""
    if key.endswith("entropy"):
        return 4 * EPS32 * np.log2(classes)
    return _cancellation_slack(key, classes)


@pytest.mark.parametrize("stage", ["uncertainties", "rpn_uncertainties"])
def test_fpn_uc_uncertainties_match_jax(serving_run, stage):
    """Every key of both 8-key dicts within SERVING_TOL of max|x| of JAX's (plus
    the rounding slack for e_cls_var, the entropies and the mutual
    informations, _slack), and not all zero."""
    got, want = serving_run.got[stage], serving_run.want[stage]
    assert set(got) == set(want) and len(want) == 8, (set(got), set(want))
    for k in want:
        w = want[k]
        assert np.isfinite(w).all() and np.abs(w).max() > 0, k
        slack = _slack(k, K if stage == "uncertainties" else 2)
        err = np.abs(got[k].numpy() - w).max()
        assert err <= SERVING_TOL * np.abs(w).max() + slack, (k, err)


# -- one training step --------------------------------------------------------------------


def _stages_uc(m, images, window):
    """JAX forward_train's train-phase proposals, its dropout live."""
    feats = m.features(images, False, True)
    rpn = m.rpn_scores(feats["rpn"])
    rpn["anchors"] = m._anchors(feats["rpn"])
    rois, _s, a3d, valid, src = m._propose_batch(rpn, window, "train")
    return rois, a3d, valid, src


@pytest.fixture(scope="module")
def train_run():
    cfg, tcfg = _cfgs(FPN_UC + ("NET_VARIANT", "res50", "RESNET.FIXED_BLOCKS", "-1"))
    x, window, rng = _frames(1)
    rec = _recorded_draws(tcfg, x, window, False)
    masks = _jax_masks(rec.masks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_det, "_trunc_normal", _clipped_normal)
        batch, variables, lanes = _train_batch(cfg, tcfg, x, window, False, masks, rng)
    step_rng = jax.random.fold_in(jax.random.PRNGKey(3), jnp.int32(0))
    rng_cls = jax.random.split(step_rng, 3)[2]
    normals = {"rpn_ce": np.asarray(jax.random.normal(jax.random.fold_in(rng_cls, 3),
                                                      tuple(rec.normals["rpn_ce"].shape))),
               "ce": np.asarray(jax.random.normal(rng_cls, tuple(rec.normals["ce"].shape)))}
    model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def losses_fn(params):
        losses, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb["data"],
            jb["gt_boxes"], jb["gt_mask"], jb["window"], step_rng,
            method=j_det.FasterRCNN.forward_train, capture_intermediates=True,
            mutable=["intermediates", "batch_stats"])
        return losses["total_loss"], (losses, mut)

    with _jax_draws_alike(masks):
        (_, (losses, mut)), grads = jax.jit(jax.value_and_grad(losses_fn, has_aux=True))(
            variables["params"])
    n, r = t_det.FasterRCNN(tcfg, K).train_lane_counts(batch["data"].shape[1:3], G)
    assert n == (H // 4) * (W // 4) * cfg.num_anchors  # the RPN on p2 at stride 4
    base = jax_draws(step_rng, B, n, r, G)
    run = types.SimpleNamespace(
        tcfg=tcfg, batch=batch, state=from_flax_variables(variables), src=_t(lanes[3]).long(),
        valid=_t(lanes[2]), losses={k: float(v) for k, v in losses.items()},
        grads={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(grads)},
        stats={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(mut["batch_stats"])},
    )
    run.draws = lambda: base._replace(uc=t_det.UCDraws(
        masks=rec.masks, normals={k: _t(v) for k, v in normals.items()}))
    run.ties = _relu_ties(lambda: _train_port(run), lambda m: _forward(m, run, ties=()),
                          mut["intermediates"])
    return run


def _train_port(run):
    return _port(run.tcfg, run.state).train()


def _forward(model, run, ties=None, draws=None):
    import chip_smoke

    tb = {k: _t(v) for k, v in run.batch.items()}
    with chip_smoke.pinned_ties(model, run.ties if ties is None else ties):
        return model.forward_train(tb["data"], tb["gt_boxes"], tb["gt_mask"], tb["window"],
                                   draws or run.draws(), proposals=(run.src, run.valid))


def test_fpn_uc_train_step_losses_gradients_and_stats(train_run):
    """The losses and a_mutual_info within rtol 1e-4; every trainable leaf's
    gradient (the pyramid and its live BN, the FPN, FCTail, the variance
    heads, the stacks, the RPN variance convs) within 1e-3 of its max|g|,
    the ReLU ties few, at 0 and pinned; the running statistics within 1e-5
    of max."""
    run = train_run
    print(f"FPN x UC ReLU ties: {[t[:3] for t in run.ties]}")
    assert len(run.ties) <= 64
    for *_, jx, tx, scale in run.ties:
        assert max(abs(jx), abs(tx)) <= 1e-5 * scale
    model = _train_port(run)
    t_optim.DetectorSGD(model, run.tcfg)
    losses, _aux = _forward(model, run)
    for k in LOSSES + ("total_loss",):
        np.testing.assert_allclose(float(losses[k].detach()), run.losses[k], rtol=1e-4, err_msg=k)
        assert np.isfinite(run.losses[k]) and run.losses[k] != 0, k
    for key, want in run.stats.items():
        assert _rel(model.state_dict()[key].numpy(), want) <= 1e-5, key
    losses["total_loss"].backward()
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert set(trained) == {k for k in run.grads if not k.endswith(("running_mean", "running_var"))}
    assert {"fpn.latlayer2.weight", "tail.t_fc3.weight", "backbone.layer4.1.conv2.weight",
            "backbone.layer4.1.bn2.weight", "rpn_cls_al_var_net.weight",
            "predictors.bbox_stack.bbox_fc2.weight"} <= set(trained)
    for name, p in trained.items():
        want = _torch_layout(run.grads[name])
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max() + 1e-12,
                                   err_msg=name)


def test_fpn_uc_train_step_dropout_is_live(train_run):
    """The step's masks: the pyramid's Bottlenecks (layer4 among them) and
    both stacks, none in the FPN or FCTail.  Other masks give other losses,
    the RPN's too: the pyramid drops in the step, not only the stacks."""
    run = train_run
    draws = run.draws()
    names = set(draws.uc.masks)
    assert {"backbone.layer1.0.drop2d", "backbone.layer4.2.drop3"} <= names
    assert {"predictors.cls_stack.cls_drop2", "predictors.bbox_stack.bbox_drop1"} <= names
    assert not any(n.startswith(("tail.", "fpn.")) for n in names)
    flipped = {k: ~v for k, v in draws.uc.masks.items()}
    flipped = draws._replace(uc=t_det.UCDraws(masks=flipped, normals=draws.uc.normals))
    with torch.no_grad():
        base, _ = _forward(_train_port(run), run)
        other, _ = _forward(_train_port(run), run, draws=flipped)
    changed = {k: abs(float(other[k]) / float(base[k]) - 1) for k in LOSSES}
    print(f"relative change of each loss under the flipped masks {changed}")
    assert min(changed.values()) > 1e-5, changed
