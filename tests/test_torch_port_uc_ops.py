"""Uncertainty math of the PyTorch port against the JAX package, on the CPU.

Covered: compute_bbox_var (n = 1 and n = 5), categorical_entropy,
categorical_mutual_information, logit_distort and the three Bayesian
cross-entropies at the same normals (JAX draws them from its key, the port
is handed them), the weighted RPN form, smooth_l1_loss's aleatoric branch
(image and 7-DoF lidar), both uncertainty inverse transforms, the dropout
law of CheapDropout (scale 256 / keep_q exactly, keep share within 4 sigma
of keep_q / 256 over 10^6 draws, drop2d constant over each (sample,
channel) plane, JAX's layer on the same bits), UCDraws' record and replay,
and to_per_class_lists' per-class uncertainty rows at E = 7.  Inputs are
seeded numpy; float32 throughout, atol 1e-6 unless stated.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.models import resnet as j_resnet  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import box_transform as j_bt  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import filter as j_filter  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops import losses as j_losses  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import resnet as t_resnet  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import box_transform as t_bt  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import filter as t_filter  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops import losses as t_losses  # noqa: E402

N, C, A = 40, 5, 200  # rows, classes, logit draws


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol)


def _logits(seed, n=N, c=C):
    rng = np.random.RandomState(seed)
    score = rng.normal(0, 2.0, (n, c)).astype(np.float32)
    log_var = rng.uniform(-3, 1, (n, c)).astype(np.float32)
    labels = rng.randint(0, c, n).astype(np.int32)
    return score, np.exp(log_var).astype(np.float32), labels


@pytest.mark.parametrize("n", [1, 2, 5])
def test_compute_bbox_var(n):
    """Unbiased over max(n - 1, 1): 0 for one sample, never negative."""
    x = np.random.RandomState(n).normal(0.3, 0.05, (n, 3, 4, 7)).astype(np.float32)
    got = t_losses.compute_bbox_var(_t(x)).numpy()
    _close(got, j_losses.compute_bbox_var(jnp.asarray(x)))
    assert (got >= 0).all()
    if n == 1:
        assert (got == 0).all()


def test_entropy_and_mutual_information():
    rng = np.random.RandomState(0)
    p = rng.dirichlet(np.ones(C), N).astype(np.float32)
    p[0] = [1, 0, 0, 0, 0]  # the 1e-12 clip
    _close(t_losses.categorical_entropy(_t(p)), j_losses.categorical_entropy(jnp.asarray(p)))
    scores = rng.normal(0, 2, (7, N, C)).astype(np.float32)
    _close(t_losses.categorical_mutual_information(_t(scores)),
           j_losses.categorical_mutual_information(jnp.asarray(scores)))


def _normals(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def test_logit_distort_on_jax_normals():
    score, var, _ = _logits(1)
    var[0, 0] = 0.0  # the 1e-12 clip
    key = jax.random.PRNGKey(3)
    want = j_losses.logit_distort(jnp.asarray(score), jnp.asarray(var), A, key)
    got = t_losses.logit_distort(_t(score), _t(var), _t(_normals(key, (A, N, C))))
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("variant", ["full", "simple", "elu"])
def test_bayes_variants_on_jax_normals(variant):
    """Each UC.BAYES_VARIANT's loss and per-row mutual information against
    JAX's on the normals JAX draws from the same key."""
    score, var, labels = _logits(2)
    key = jax.random.PRNGKey(4)
    j_fn = {"full": j_losses.bayesian_cross_entropy,
            "simple": j_losses.bayesian_cross_entropy_simple,
            "elu": j_losses.bayesian_elu_cross_entropy}[variant]
    j_loss, j_mi = j_fn(jnp.asarray(score), jnp.asarray(var), jnp.asarray(labels), A, key)
    t_loss, t_mi = t_losses.BAYES_VARIANTS[variant](
        _t(score), _t(var), _t(labels), _t(_normals(key, (A, N, C))))
    _close(float(t_loss), float(j_loss), rtol=1e-6)
    _close(t_mi, j_mi)


def test_bayesian_cross_entropy_weights():
    """The RPN form: two classes, ignored lanes at weight 0, the weighted mean
    over max(sum of weights, 1); gradients to the logits and variances."""
    score, var, labels = _logits(5, n=64, c=2)
    w = (np.random.RandomState(6).rand(64) > 0.3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    j_loss, j_mi = j_losses.bayesian_cross_entropy(jnp.asarray(score), jnp.asarray(var),
                                                   jnp.asarray(labels), A, key, weights=jnp.asarray(w))
    j_g = jax.grad(lambda s, v: j_losses.bayesian_cross_entropy(
        s, v, jnp.asarray(labels), A, key, weights=jnp.asarray(w))[0], argnums=(0, 1))(
        jnp.asarray(score), jnp.asarray(var))
    ts, tv = _t(score).requires_grad_(), _t(var).requires_grad_()
    t_loss, t_mi = t_losses.bayesian_cross_entropy(ts, tv, _t(labels), _t(_normals(key, (A, 64, 2))),
                                                   weights=_t(w))
    t_loss.backward()
    _close(float(t_loss.detach()), float(j_loss), rtol=1e-6)
    _close(t_mi.detach(), j_mi)
    for got, want in zip((ts.grad, tv.grad), j_g):
        _close(got, want, atol=1e-6 * float(np.abs(np.asarray(want)).max()) + 1e-9)


@pytest.mark.parametrize("lidar", [False, True], ids=["image", "lidar"])
def test_smooth_l1_aleatoric(lidar):
    """0.5 * L * exp(-s) + 0.5 * s, times the inside weights, on the image
    branch and the 7-DoF one (sine heading, per-element weights)."""
    rng = np.random.RandomState(8)
    e = 7 if lidar else 4
    shape = (3, 16, 2 * e)
    pred, tgt = (rng.normal(0, 1.5, shape).astype(np.float32) for _ in range(2))
    inside = (rng.rand(*shape) > 0.5).astype(np.float32)
    outside = inside * rng.uniform(0.5, 1.0, shape).astype(np.float32)
    s = rng.uniform(-2, 2, shape).astype(np.float32)
    kw = dict(lidar_det=lidar, en_ry_sin=True, reg_loss_weight=(1.0, 1.0, 0.5, 1.0, 1.0, 0.5, 2.0),
              sum_axes=(2,))
    want = j_losses.smooth_l1_loss(*(jnp.asarray(a) for a in (pred, tgt, inside, outside, s)), **kw)
    got = t_losses.smooth_l1_loss(*(_t(a) for a in (pred, tgt, inside, outside, s)), **kw)
    _close(float(got), float(want), rtol=1e-6)
    plain = t_losses.smooth_l1_loss(*(_t(a) for a in (pred, tgt, inside, outside)), **kw)
    assert float(plain) != float(got)


def test_uncertainty_transforms():
    """Both inverse transforms, 4-element image layout (carried as the JAX
    package has it) and the 7-DoF lidar one, at K = 3 classes."""
    rng = np.random.RandomState(9)
    xy = rng.uniform(0, 200, (2, 30, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 80, (2, 30, 2))], -1).astype(np.float32)
    u4 = rng.uniform(0, 0.5, (2, 30, 12)).astype(np.float32)
    _close(t_bt.uncertainty_transform_inv(_t(boxes), _t(u4)),
           jax.vmap(j_bt.uncertainty_transform_inv)(jnp.asarray(boxes), jnp.asarray(u4)),
           atol=1e-6, rtol=1e-6)
    a3d = rng.uniform(1, 5, (2, 30, 7)).astype(np.float32)
    u7 = rng.uniform(0, 0.5, (2, 30, 21)).astype(np.float32)
    _close(t_bt.lidar_3d_uncertainty_transform_inv(_t(boxes), _t(a3d), _t(u7)),
           jax.vmap(j_bt.lidar_3d_uncertainty_transform_inv)(
               jnp.asarray(boxes), jnp.asarray(a3d), jnp.asarray(u7)), atol=1e-6, rtol=1e-6)


# -- the dropout law -----------------------------------------------------------


@pytest.mark.parametrize("rate,keep_q,scale", [(0.1, 230, 1.11304), (0.3, 179, 1.43017),
                                               (0.5, 128, 2.0)])
def test_dropout_law(rate, keep_q, scale):
    """keep_q = max(1, round((1 - rate) * 256)); the kept values are x times
    float32(256 / keep_q) exactly; the keep share over 10^6 draws within 4
    sigma of keep_q / 256; drop2d keeps or drops whole (sample, channel)
    planes of an NCHW input."""
    layer = t_resnet.CheapDropout(rate)
    assert layer.keep_q == keep_q
    assert abs(256.0 / keep_q - scale) < 1e-5
    x = torch.ones(1000, 1000)
    with t_resnet.live_dropout(t_resnet.UCDraws(torch.Generator().manual_seed(0)), layer):
        out = layer(x)
    assert layer(x) is x  # the identity outside live_dropout
    kept = out != 0
    assert bool((out[kept] == torch.tensor(256.0 / keep_q, dtype=torch.float32)).all())
    p, n = keep_q / 256, x.numel()
    assert abs(float(kept.float().mean()) - p) <= 4 * np.sqrt(p * (1 - p) / n)
    plane = t_resnet.CheapDropout(rate, channelwise=True)
    x4 = torch.ones(64, 32, 5, 6)
    with t_resnet.live_dropout(t_resnet.UCDraws(torch.Generator().manual_seed(1)), plane):
        out4 = plane(x4)
    per_plane = (out4 != 0).float().reshape(64, 32, 30)
    assert bool((per_plane.min(-1).values == per_plane.max(-1).values).all())
    assert 0 < float(per_plane[..., 0].mean()) < 1


@pytest.mark.parametrize("channelwise", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_jax_layer_on_the_same_mask(channelwise, dtype):
    """The port's CheapDropout on the mask JAX's layer drew (read back from
    JAX's output on ones under the same key): the same output as JAX's on
    the same input, in float32 and bfloat16, NHWC against NCHW."""
    rate = 0.3
    keep_q = max(1, round((1.0 - rate) * 256.0))
    x = np.random.RandomState(10).normal(0, 3, (4, 6, 5, 8)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    layer = j_resnet.CheapDropout(rate, broadcast_dims=(1, 2) if channelwise else ())
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = layer.apply({}, jnp.asarray(x, jdt), deterministic=False, rngs={"dropout": key})
    ones = layer.apply({}, jnp.ones((4, 6, 5, 8), jdt), deterministic=False,
                       rngs={"dropout": key})
    mask_nhwc = np.asarray(ones != 0)
    mask = np.transpose(mask_nhwc, (0, 3, 1, 2))
    if channelwise:
        assert (mask == mask[..., :1, :1]).all()
        mask = mask[..., :1, :1]
    port = t_resnet.CheapDropout(rate, channelwise=channelwise)
    port.path = "layer"
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    draws = t_resnet.UCDraws(masks={"layer": _t(mask)[None]})
    xt = _t(np.transpose(x, (0, 3, 1, 2))).to(tdt)
    with t_resnet.live_dropout(draws, port):
        got = port(xt)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.transpose(np.asarray(want, np.float32), (0, 3, 1, 2)))
    assert keep_q == 179


def test_draws_record_and_replay():
    """A forward that records its masks and normals, and one that is given
    them, compute the same thing; masks of samples stacked along the batch
    axis are kept one a sample."""
    layer = t_resnet.CheapDropout(0.5, channelwise=True)
    layer.path = "drop"
    rec = t_resnet.UCDraws(torch.Generator().manual_seed(2), record=True)
    x = torch.randn(2, 3, 4, 4)
    with t_resnet.live_dropout(rec, layer):
        rec.samples = range(0, 2)
        a = layer(torch.cat([x, x]))
        rec.samples = range(2, 3)
        b = layer(x)
    z = rec.normal("ce", (5, 2), torch.device("cpu"))
    assert rec.masks["drop"].shape == (3, 2, 3, 1, 1)
    replay = t_resnet.UCDraws(masks=rec.masks, normals=rec.normals)
    with t_resnet.live_dropout(replay, layer):
        replay.samples = range(0, 3)
        c = layer(torch.cat([x, x, x]))
    assert torch.equal(c, torch.cat([a, b]))
    assert torch.equal(replay.normal("ce", (5, 2), torch.device("cpu")), z)
    with pytest.raises(KeyError):
        t_resnet.UCDraws(masks={}).keep("drop", (2, 3, 1, 1), 128, torch.device("cpu"))


def test_to_per_class_lists_uncertainty_rows_at_seven_elements():
    """The per-class slice of a_bbox_var / e_bbox_var at E = 7 and the
    per-detection rows of the other keys, as JAX's to_per_class_lists."""
    rng = np.random.RandomState(12)
    k, m, s, e = 3, 6, 20, 7
    filtered = {
        "boxes": rng.normal(size=(k, m, e)).astype(np.float32),
        "scores": rng.rand(k, m).astype(np.float32),
        "valid": rng.rand(k, m) > 0.4,
        "src_idx": rng.randint(0, s, (k, m)),
    }
    unc = {"a_bbox_var": rng.rand(s, k * e).astype(np.float32),
           "e_bbox_var": rng.rand(s, k * e).astype(np.float32),
           "a_entropy": rng.rand(s).astype(np.float32),
           "e_cls_var": rng.rand(s, k).astype(np.float32)}
    tb, tu = t_filter.to_per_class_lists(filtered, unc, k, e)
    jb, ju = j_filter.to_per_class_lists(filtered, unc, k, e)
    for j in range(1, k):
        np.testing.assert_array_equal(tb[j], jb[j])
        assert set(tu[j]) == set(ju[j])
        for key in tu[j]:
            np.testing.assert_array_equal(tu[j][key], ju[j][key])
        if len(tb[j]):
            assert tu[j]["a_bbox_var"].shape == (len(tb[j]), e)
