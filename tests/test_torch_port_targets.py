"""Training ops of the port vs the JAX package: IoU, anchor and proposal
targets (fed the JAX package's own random draws), losses, the RoI-align
gradient and the optimizer chain.  Inputs are made from numpy seeds; the
port runs its plain twins on CPU tensors.  Tolerances are stated per test.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list, default_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import iou as j_iou  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import losses as j_losses  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import roi_align as j_roi  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import targets as j_tg  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.training import optim as j_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import iou as t_iou  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import losses as t_losses  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import targets as t_tg  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.anchors import generate_anchors_pre  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import roi_align_batched  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import optim as t_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    to_flax_variables,
)

H, W = 128, 192
ANCHORS = generate_anchors_pre(H // 16, W // 16, 16, (2.0, 4.0, 8.0, 16.0, 32.0),
                               (0.5, 0.75, 1.0, 1.25, 2.0), 1.0)[0]  # (2400, 4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, n, hw=(H, W), size=(12.0, 90.0)):
    x1 = rng.uniform(0, hw[1] - size[0], n)
    y1 = rng.uniform(0, hw[0] - size[0], n)
    w = rng.uniform(*size, n)
    h = rng.uniform(*size, n)
    return np.stack([x1, y1, np.minimum(x1 + w, hw[1] - 1), np.minimum(y1 + h, hw[0] - 1)],
                    1).astype(np.float32)


def _gt(rng, counts, g=8, num_classes=3):
    gt = np.zeros((len(counts), g, 5), np.float32)
    mask = np.zeros((len(counts), g), bool)
    for i, n in enumerate(counts):
        gt[i, :n, :4] = _boxes(rng, n, size=(24.0, 100.0))
        gt[i, :n, 4] = rng.randint(1, num_classes, n)
        mask[i, :n] = True
    return gt, mask


def _keys_2(seed, b, n):
    """The JAX package's draws inside a vmapped target function: one key a
    frame (split(rng, b)), split again into fg and bg, uniform(n) each."""
    frame_keys = jax.random.split(jax.random.PRNGKey(seed), b)
    fg, bg = [], []
    for k in frame_keys:
        kf, kb = jax.random.split(k)
        fg.append(np.asarray(jax.random.uniform(kf, (n,))))
        bg.append(np.asarray(jax.random.uniform(kb, (n,))))
    return frame_keys, np.stack(fg), np.stack(bg)


# -- IoU: rtol 1e-6 (same float32 formula) ----------------------------------


def test_bbox_overlaps():
    rng = np.random.RandomState(0)
    a, q = _boxes(rng, 300), _boxes(rng, 17)
    a[:5] = q[:5]  # identical boxes: IoU exactly 1
    want = np.asarray(j_iou.bbox_overlaps(jnp.asarray(a), jnp.asarray(q)))
    got = t_iou.bbox_overlaps(_t(a), _t(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(np.diag(got[:5, :5]) == 1.0)
    # batched queries broadcast against shared boxes
    qb = np.stack([q, q[::-1]])
    got_b = t_iou.bbox_overlaps(_t(a), _t(qb)).numpy()
    np.testing.assert_allclose(got_b[1], want[:, ::-1], rtol=1e-6, atol=1e-7)


# -- anchor targets: exact lanes and labels, targets rtol 1e-5 --------------


def _anchor_case(case):
    rng = np.random.RandomState(1)
    gt, mask = _gt(rng, [3, 5])
    window = np.array([[0, W, 0, H], [0, W - 40, 0, H - 24]], np.float32)
    kw = dict(rpn_batchsize=64, fg_fraction=0.5, positive_overlap=0.7, negative_overlap=0.3,
              clobber_positives=False)
    if case == "zero_gt":
        mask[1] = False
    elif case == "clobber":
        kw["clobber_positives"] = True
    elif case == "tied_best":
        # a GT box halfway between two neighbouring anchors of one shape ties
        # their IoU: both take the per-GT-best fg label
        a = ANCHORS[(3 * 12 + 4) * 25 + 12]
        gt[0, 0, :4] = a + np.array([8.0, 0.0, 8.0, 0.0], np.float32)
        gt[0, 1:] = 0.0
        mask[0] = [True] + [False] * 7
    return gt, mask, window, kw


@pytest.mark.parametrize("case", ["normal", "zero_gt", "clobber", "tied_best"])
def test_anchor_target(case):
    gt, mask, window, kw = _anchor_case(case)
    b, n = 2, ANCHORS.shape[0]
    frame_keys, fg, bg = _keys_2(11, b, n)
    want = jax.vmap(lambda g, m, w, k: j_tg.anchor_target(jnp.asarray(ANCHORS), g, m, w, k, **kw))(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(window), frame_keys)
    got = t_tg.anchor_target(_t(ANCHORS), _t(gt), _t(mask), _t(window), _t(fg), _t(bg), **kw)
    labels = np.asarray(want.labels)
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    # every slot's lane, inactive ones included: both sides break ties by lane
    np.testing.assert_array_equal(got.sel.numpy(), np.asarray(want.sel))
    np.testing.assert_allclose(got.bbox_targets.numpy(), np.asarray(want.bbox_targets),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.bbox_inside_weights.numpy(),
                                  np.asarray(want.bbox_inside_weights))
    np.testing.assert_allclose(got.bbox_outside_weights.numpy(),
                               np.asarray(want.bbox_outside_weights), rtol=1e-7)
    assert (labels == 0).sum() > 0
    if case == "zero_gt":
        assert not (labels[1] == 1).any() and (labels[1] == 0).any()
    else:
        assert (labels == 1).sum() > 0
    if case == "tied_best":
        iou = np.asarray(j_iou.bbox_overlaps(jnp.asarray(ANCHORS), jnp.asarray(gt[0, :1, :4])))[:, 0]
        inside = (ANCHORS[:, 0] >= 0) & (ANCHORS[:, 1] >= 0) & (ANCHORS[:, 2] < W) & (ANCHORS[:, 3] < H)
        iou = np.where(inside, iou, -1.0)
        tied = set(np.flatnonzero(iou == iou.max()).tolist())
        fg_lanes = set(np.asarray(want.sel)[0][labels[0] == 1].tolist())
        assert len(tied) >= 2 and tied <= fg_lanes


def test_expand_anchor_targets():
    gt, mask, window, kw = _anchor_case("normal")
    n = ANCHORS.shape[0]
    frame_keys, fg, bg = _keys_2(12, 2, n)
    want = jax.vmap(lambda g, m, w, k: j_tg.expand_anchor_targets(
        j_tg.anchor_target(jnp.asarray(ANCHORS), g, m, w, k, **kw), n))(
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(window), frame_keys)
    got = t_tg.expand_anchor_targets(
        t_tg.anchor_target(_t(ANCHORS), _t(gt), _t(mask), _t(window), _t(fg), _t(bg), **kw), n)
    np.testing.assert_array_equal(got.sel.numpy(), np.asarray(want.sel))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for name in ("bbox_targets", "bbox_inside_weights", "bbox_outside_weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_rank_within():
    rng = np.random.RandomState(3)
    cand = rng.uniform(size=(3, 50)) < 0.4
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = np.stack([np.asarray(j_tg._rank_within(jnp.asarray(c), k)) for c, k in zip(cand, keys)])
    u = np.stack([np.asarray(jax.random.uniform(k, (50,))) for k in keys])
    np.testing.assert_array_equal(t_tg._rank_within(_t(cand), _t(u)).numpy(), want)


# -- proposal targets: exact labels and sampled rois, targets rtol 1e-5 -----


def _proposal_case(case):
    rng = np.random.RandomState(4)
    gt, mask = _gt(rng, [3, 4])
    r = 60
    rois = np.stack([_boxes(rng, r), _boxes(rng, r)])
    # jittered copies of the GT boxes: fg candidates
    for i, n in enumerate([3, 4]):
        for j in range(n):
            rois[i, j * 3:(j + 1) * 3] = gt[i, j, :4] + rng.uniform(-3, 3, (3, 4))
    valid = rng.uniform(size=(2, r)) < 0.9
    dc = np.zeros((2, 2, 4), np.float32)
    dc_mask = np.zeros((2, 2), bool)
    kw = dict(num_classes=3, roi_batch_size=32, fg_fraction=0.25, fg_thresh=0.6,
              bg_thresh_hi=0.5, bg_thresh_lo=0.0)
    if case == "only_fg":
        rois = np.repeat(rois[:, :3], 20, axis=1)  # every roi is near a GT box
        valid = np.ones((2, 60), bool)
    elif case == "only_bg":
        rois = rois + 1000.0  # far from every GT box: IoU 0
    elif case == "wrap":
        rois, valid = rois[:, :14], valid[:, :14]  # fewer candidates than slots
    elif case == "ignore_dc":
        dc[:, 0] = rois[:, 20] + 1.0  # don't-care areas over some proposals
        dc[:, 1] = rois[:, 1]  # and over one fg candidate
        dc_mask[:] = True
        kw.update(ignore_dc=True, dc_thresh=0.5)
    return rois.astype(np.float32), valid, gt, mask, dc, dc_mask, kw


@pytest.mark.parametrize("case", ["normal", "only_fg", "only_bg", "wrap", "ignore_dc"])
def test_proposal_target(case):
    rois, valid, gt, mask, dc, dc_mask, kw = _proposal_case(case)
    b, r = valid.shape
    means, stds = np.zeros(4, np.float32), np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    frame_keys, fg, bg = _keys_2(21, b, r)
    rois5 = np.concatenate([np.zeros((b, r, 1), np.float32), rois], -1)

    def one(r5, v, g, m, d, dm, k):
        return j_tg.proposal_target(r5, jnp.zeros(r), v, jnp.zeros((r, 7)), g, m,
                                    jnp.zeros((g.shape[0], 8)), d, dm, k, jnp.asarray(means),
                                    jnp.asarray(stds), **kw)

    want = jax.vmap(one)(*(jnp.asarray(a) for a in (rois5, valid, gt, mask, dc, dc_mask)),
                         frame_keys)
    got = t_tg.proposal_target(_t(rois), _t(valid), _t(gt), _t(mask), _t(dc), _t(dc_mask),
                               _t(fg), _t(bg), _t(means), _t(stds), **kw)
    labels = np.asarray(want.labels)
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois)[..., 1:5])
    np.testing.assert_allclose(got.bbox_targets.numpy(), np.asarray(want.bbox_targets),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.bbox_inside_weights.numpy(),
                                  np.asarray(want.bbox_inside_weights))
    np.testing.assert_array_equal(got.bbox_outside_weights.numpy(),
                                  np.asarray(want.bbox_outside_weights))
    n_fg = (labels > 0).sum(1)
    if case == "only_fg":
        assert (n_fg == 32).all()
    elif case == "only_bg":
        assert (n_fg == 0).all() and np.asarray(want.valid).all()
    else:
        assert (n_fg > 0).all() and (n_fg <= 8).all()


def test_proposal_targets_are_differentiable_in_the_rois():
    """The regression targets carry gradient back to the proposal boxes, as
    in the JAX package (ROADMAP F1): d sum(targets^2) / d rois equal."""
    rois, valid, gt, mask, dc, dc_mask, kw = _proposal_case("normal")
    b, r = valid.shape
    means, stds = np.zeros(4, np.float32), np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    frame_keys, fg, bg = _keys_2(22, b, r)

    def j_loss(x):
        r5 = jnp.concatenate([jnp.zeros((b, r, 1)), x], -1)
        pt = jax.vmap(lambda r5_, v, g, m, k: j_tg.proposal_target(
            r5_, jnp.zeros(r), v, jnp.zeros((r, 7)), g, m, jnp.zeros((8, 8)), jnp.zeros((1, 4)),
            jnp.zeros((1,), bool), k, jnp.asarray(means), jnp.asarray(stds), **kw))(
            r5, jnp.asarray(valid), jnp.asarray(gt), jnp.asarray(mask), frame_keys)
        return jnp.sum(pt.bbox_targets ** 2)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(rois)))
    x = _t(rois).requires_grad_(True)
    pt = t_tg.proposal_target(x, _t(valid), _t(gt), _t(mask), torch.zeros(b, 1, 4),
                              torch.zeros(b, 1, dtype=torch.bool), _t(fg), _t(bg), _t(means),
                              _t(stds), **kw)
    (pt.bbox_targets ** 2).sum().backward()
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# -- losses: rtol 1e-6 -----------------------------------------------------


def test_cross_entropy():
    rng = np.random.RandomState(5)
    logits = rng.normal(0, 3, (40, 4)).astype(np.float32)
    labels = rng.randint(0, 4, 40)
    w = (rng.uniform(size=40) < 0.6).astype(np.float32)
    for weights in (None, w, np.zeros(40, np.float32)):
        want = j_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                      None if weights is None else jnp.asarray(weights))
        got = t_losses.cross_entropy(_t(logits), _t(labels),
                                     None if weights is None else _t(weights))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,sum_axes", [((2, 30, 4), (1, 2)), ((2, 16, 12), (2,))])
def test_smooth_l1_loss(shape, sum_axes):
    rng = np.random.RandomState(6)
    pred, tgt = (rng.normal(0, 1.5, shape).astype(np.float32) for _ in range(2))
    inside = (rng.uniform(size=shape) < 0.5).astype(np.float32)
    outside = rng.uniform(size=shape).astype(np.float32)
    want = j_losses.smooth_l1_loss(*(jnp.asarray(a) for a in (pred, tgt, inside, outside)),
                                   sum_axes=sum_axes)
    got = t_losses.smooth_l1_loss(*(_t(a) for a in (pred, tgt, inside, outside)),
                                  sum_axes=sum_axes)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        t_losses.huber_loss(_t(pred), _t(tgt), 1.0).numpy(),
        np.asarray(j_losses.huber_loss(jnp.asarray(pred), jnp.asarray(tgt), 1.0)), rtol=1e-6)


# -- RoI-align gradient: the twin's autograd vs jax.vjp, 1e-5 * max|dF| -----


@pytest.mark.parametrize("fh,fw", [(6, 9), (9, 6)])  # w >= h and w < h einsum orders
def test_roi_align_feature_gradient(fh, fw):
    rng = np.random.RandomState(fh)
    feats = rng.normal(size=(2, fh, fw, 8)).astype(np.float32)
    rois = _boxes(rng, 10, hw=(fh * 16, fw * 16), size=(4.0, 70.0)).reshape(2, 5, 4)
    rois[0, 0] -= 40.0  # straddling the top-left edge
    rois[1, 1] += 500.0  # off the map
    g = rng.normal(size=(2, 5, 7, 7, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda f: j_roi.roi_align_batched(f, jnp.asarray(rois), 1 / 16),
                     jnp.asarray(feats))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    f = _t(feats).requires_grad_(True)
    r = _t(rois).requires_grad_(True)
    out = roi_align_batched(f, r, 1 / 16)
    out.backward(_t(g))
    assert r.grad is None  # the rois get no gradient
    np.testing.assert_allclose(f.grad.numpy(), want, atol=1e-5 * np.abs(want).max())


# -- optimizer ---------------------------------------------------------------


def _cfg(*extra):
    """The JAX package's config."""
    return cfg_from_list(default_config(), ("NET_TYPE", "image", "NET_VARIANT", "res50") + extra)


def _tcfg(*extra):
    """The port's config, from the same overrides."""
    return t_config.cfg_from_list(t_config.default_config(),
                                  ("NET_TYPE", "image", "NET_VARIANT", "res50") + extra)


@pytest.fixture(scope="module")
def res50_port():
    return t_det.init_detector(_tcfg("COMPUTE_DTYPE", "float32"), 2, seed=0)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize(
    "fixed_blocks,bias_decay,net",
    [(1, False, "res50"), (3, True, "res50"), (0, False, "res50"), (-1, True, "res50"),
     (-1, False, "res18"), (1, True, "res18")],
    ids=["1-False", "3-True", "0-False", "-1-True", "res18--1-False", "res18-1-True"],
)
def test_masks_match_jax(fixed_blocks, bias_decay, net):
    """The port's masks on the JAX model's keys equal JAX's; res18 has
    BasicBlock keys (bn2 the terminator, no conv3/bn3)."""
    extra = ("RESNET.FIXED_BLOCKS", str(fixed_blocks), "TRAIN.BIAS_DECAY", str(bias_decay),
             "NET_VARIANT", net)
    cfg, tcfg = _cfg(*extra), _tcfg(*extra)
    model = j_det.FasterRCNN(cfg=cfg, num_classes=2)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 4)))["params"]
    masks = {
        "frozen": (j_optim.frozen_mask(shapes, cfg), t_optim.frozen_mask),
        "bias": (j_optim.bias_mask(shapes), lambda keys, _cfg: t_optim.bias_mask(keys)),
        "decay": (j_optim.decay_mask(shapes, cfg), t_optim.decay_mask),
    }
    for name, (j_mask, t_fn) in masks.items():
        want = {flax_path_to_torch_key(p): bool(v) for p, v in _flat(j_mask)}
        got = t_fn(want.keys(), tcfg)
        assert got == want, name
    frozen = t_optim.frozen_mask(want.keys(), tcfg)
    assert any(frozen.values()) == (fixed_blocks >= 0) and not all(frozen.values())
    assert ("backbone.layer1.0.conv3.weight" in frozen) == (net != "res18")


def _clip_jax(grads, max_norm):
    tx = j_optim.safe_clip_by_global_norm(max_norm)
    out, _ = tx.update({str(i): jnp.asarray(g) for i, g in enumerate(grads)}, tx.init(None))
    return [np.asarray(out[str(i)]) for i in range(len(grads))]


@pytest.mark.parametrize("case", ["normal", "overflow", "zero", "nonfinite"])
def test_safe_clip(case):
    rng = np.random.RandomState(7)
    grads = [rng.normal(0, 5, (7, 3)).astype(np.float32), rng.normal(0, 1, (11,)).astype(np.float32)]
    if case == "overflow":  # squares overflow float32; the scaled norm does not
        grads = [g * np.float32(1e20) for g in grads]
    elif case == "zero":
        grads = [np.zeros_like(g) for g in grads]
    elif case == "nonfinite":
        grads[1][3] = np.inf
    want = _clip_jax(grads, 1.5)
    got = [_t(g) for g in grads]
    norm = t_optim.safe_clip_by_global_norm_(got, 1.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=0)
    if case == "overflow":
        assert np.isfinite(float(norm)) and all(np.isfinite(w).all() for w in want)
    if case == "nonfinite":
        assert not np.isfinite(float(norm)) and all((g == 0).all() for g in got)


def test_lr_schedule_boundaries():
    extra = ("TRAIN.LEARNING_RATE", "0.01", "TRAIN.GAMMA", "0.1", "TRAIN.STEPSIZE", "(3, 5, 5)")
    want = j_optim.lr_schedule(_cfg(*extra))
    got = t_optim.lr_schedule(_tcfg(*extra))
    for count in range(8):
        assert got(count) == float(np.float32(want(count))), count
    assert got(2) == float(np.float32(0.01)) and got(3) < got(2) and got(5) < got(4)


@pytest.mark.parametrize("double_bias,bias_decay", [(False, False), (True, True), (True, False)])
def test_three_updates_match_optax_chain(res50_port, double_bias, bias_decay):
    """The port's clip + SGD groups vs the JAX package's optax chain, on the
    same random gradients (frozen leaves get zero gradients on the JAX side,
    as make_train_step's stop_gradient gives them): deltas within
    1e-4 * max|delta| of each leaf plus 1e-6 * max|p| (float32 rounding of
    the two chains and of the parameter at each update)."""
    extra = ("TRAIN.LEARNING_RATE", "0.01", "TRAIN.MOMENTUM", "0.9", "TRAIN.STEPSIZE", "(1,)",
             "TRAIN.DOUBLE_BIAS", str(double_bias), "TRAIN.BIAS_DECAY", str(bias_decay))
    cfg, tcfg = _cfg(*extra), _tcfg(*extra)
    model = t_det.init_detector(tcfg, 2, seed=0)
    model.load_state_dict(res50_port.state_dict())
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = t_optim.DetectorSGD(model, tcfg)

    params = to_flax_variables(start)["params"]
    j_opt = j_optim.build_optimizer(params, cfg)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = j_opt.init(j_params)
    frozen = j_optim.frozen_mask(params, cfg)
    shapes = {path: np.shape(v) for path, v in _flat(params)}
    rng = np.random.RandomState(8)
    named = dict(model.named_parameters())
    for _ in range(3):
        flat = {}
        for path, is_frozen in _flat(frozen):
            key = flax_path_to_torch_key(path)
            shape = shapes[path]
            g = np.zeros(shape, np.float32) if is_frozen else rng.normal(0, 0.01, shape).astype(np.float32)
            flat[path] = g
            if key in named and named[key].requires_grad:
                named[key].grad = _t(to_torch_layout(g))
        j_grads = _unflat(flat)
        updates, j_state = j_opt.update(j_grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        opt.step()
    got = model.state_dict()
    n_moved = 0
    for path, v in _flat(j_params):
        key = flax_path_to_torch_key(path)
        want_delta = to_torch_layout(np.asarray(v)) - start[key].numpy()
        got_delta = (got[key] - start[key]).numpy()
        scale = np.abs(want_delta).max()
        # plus float32 rounding of the parameter itself at each update
        atol = 1e-4 * scale + 1e-6 * np.abs(start[key].numpy()).max()
        np.testing.assert_allclose(got_delta, want_delta, atol=atol, err_msg=key)
        n_moved += scale > 0
    assert n_moved == len(opt.params)


def to_torch_layout(v):
    if v.ndim == 4:
        return np.transpose(v, (3, 2, 0, 1))
    if v.ndim == 2:
        return v.T
    return v


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(v)
    return out
