"""Uncertainty in the PyTorch port against the JAX package, on the CPU: the
eight UC.* flags on the C4 image path and the LiDAR BEV path.

Covered: check_supported (the eight flags accepted on C4 image and lidar,
FPN x UC and an unknown Bayes variant refused with their reasons); the
weight bridge with every UC key (the RPN variance convs, the variance
heads, both epistemic stacks and their BN under lidar, with and without
live BN) both ways, at res18 (the UC keys do not depend on the depth);
serving (forward_test with all eight flags, T = 2 MC samples) of the res50
image (96x128 frames) and BEV detectors: rois, cls_prob, the decoded
boxes and every key of `uncertainties` and `rpn_uncertainties` within 1e-5
of max|x| (two cancelling keys within a float32 rounding bound beside it),
and each MC sample within 1e-5.  The training step is in
test_torch_port_uc_train.py.

The two sides draw alike: the port records the dropout masks it draws
(UCDraws(record=True)), and JAX's CheapDropout calls are replaced, from the
test only, by the same masks (flax.linen.intercept_methods, keyed by module
path and MC sample); JAX's chunked MC scan is replaced by a loop of one
sample a step (monkeypatch on detector._chunked_mc_scan) and its test-time
key fixed (FasterRCNN._test_rng), and the port is handed the normals JAX
draws from that key.
"""

from __future__ import annotations

import contextlib
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list, default_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import resnet as j_resnet  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    from_flax_variables,
    load_flax_variables,
    to_flax_variables,
)
from tests.test_torch_port_live_bn import _raster, _randomize_bn  # noqa: E402
from tests.test_torch_port_train import _flat  # noqa: E402

B, K, G, T = 2, 2, 8, 2
UC8 = (
    "UC.EN_RPN_BBOX_ALEATORIC", "True", "UC.EN_RPN_CLS_ALEATORIC", "True",
    "UC.EN_RPN_BBOX_EPISTEMIC", "True", "UC.EN_RPN_CLS_EPISTEMIC", "True",
    "UC.EN_BBOX_ALEATORIC", "True", "UC.EN_CLS_ALEATORIC", "True",
    "UC.EN_BBOX_EPISTEMIC", "True", "UC.EN_CLS_EPISTEMIC", "True",
    "UC.EN_BBOX_EPISTEMIC_INV_TRANSFORM", "True", "UC.E_NUM_SAMPLE", str(T),
)
COMMON = (
    "COMPUTE_DTYPE", "float32", "TRAIN.ROI_BATCH_SIZE", "32", "STATIC.NMS_PRE_TRAIN", "256",
    "TRAIN.RPN_POST_NMS_TOP_N", "64", "TRAIN.RPN_BATCHSIZE", "64", "STATIC.MAX_GT", str(G),
    "TRAIN.USE_GT", "True", "TRAIN.USE_GT_NOISE", "True", "TRAIN.LEARNING_RATE", "0.01",
    "STATIC.NMS_PRE_TEST", "256", "TEST.RPN_POST_NMS_TOP_N", "32",
)
IMAGE = ("NET_TYPE", "image", "NET_VARIANT", "res50", "PIXEL_STDDEVS", "[60.,60.,60.]",
         "TEST.SCALES", "(1.0,)") + COMMON + UC8
BEV_SCALE = 0.25
BEV = ("NET_TYPE", "lidar", "NET_VARIANT", "res50", "TRAIN.SCALES", f"({BEV_SCALE},)",
       "TEST.SCALES", f"({BEV_SCALE},)", "STATIC.MAX_POINTS", "9000",
       "LIDAR.REG_LOSS_WEIGHT", "(1.0, 1.0, 0.5, 1.0, 1.0, 0.5, 2.0)") + COMMON + UC8
LIVE18 = ("NET_VARIANT", "res18", "RESNET.FIXED_BLOCKS", "-1")
H, W = 96, 128
TEST_KEY = jax.random.PRNGKey(5)


def _cfgs(overrides):
    return (cfg_from_list(default_config(), overrides),
            t_config.cfg_from_list(t_config.default_config(), overrides))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the same draws on the JAX side ------------------------------------------------------

_INJECT = {"masks": {}, "sample": 0, "samples": []}


def _port_path(jpath) -> str:
    """A JAX CheapDropout's module path -> the port's module name."""
    parts = [m.group(1) if (m := re.fullmatch(r"block(\d+)", p)) else p for p in jpath]
    if len(jpath) > 2 and jpath[1].startswith("EpistemicStack_"):
        parts[1] = jpath[2].split("_")[0] + "_stack"
    return ".".join(parts)


def _dropout_from_table(next_fun, args, kwargs, context):
    mod = context.module
    if not (isinstance(mod, j_resnet.CheapDropout) and context.method_name == "__call__"):
        return next_fun(*args, **kwargs)
    x = args[0]
    deterministic = args[1] if len(args) > 1 else kwargs.get("deterministic", True)
    if deterministic or mod.rate == 0.0:
        return x
    keep_q = max(1, round((1.0 - mod.rate) * 256.0))
    mask = jnp.asarray(_INJECT["masks"][_port_path(mod.path)][_INJECT["sample"]])
    return jnp.where(mask, x * jnp.asarray(256.0 / keep_q, x.dtype), jnp.zeros_like(x))


def _jax_masks(masks):
    """The port's recorded masks ({name: (T, N, C, H, W) or (T, N, F)}) in
    JAX's layout (NHWC)."""
    return {k: np.transpose(v.numpy(), (0, 1, 3, 4, 2)) if v.dim() == 5 else v.numpy()
            for k, v in masks.items()}


@contextlib.contextmanager
def _jax_draws_alike(masks):
    """Within the block, JAX's dropout takes `masks` (JAX layout) and its MC
    loop runs one sample a step."""
    def one_sample_a_step(mdl, body, carry, t, chunk):
        outs = []
        for i in range(t):
            _INJECT["sample"] = i
            if body is j_det._mc_roi_head_chunk:
                pooled, rois = carry
                outs.append(mdl.pooled_head(pooled, rois.shape[0], rois.shape[1],
                                            deterministic=False))
            else:
                outs.append(mdl.rpn_scores(mdl.features(carry, deterministic=False)["rpn"]))
        _INJECT["sample"] = 0
        out = jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
        _INJECT["samples"].append(out)
        return out

    _INJECT["masks"], _INJECT["sample"], _INJECT["samples"] = masks, 0, []
    with pytest.MonkeyPatch.context() as mp, nn.intercept_methods(_dropout_from_table):
        mp.setattr(j_det, "_chunked_mc_scan", one_sample_a_step)
        mp.setattr(j_det.FasterRCNN, "_test_rng", lambda self: TEST_KEY)
        yield
    _INJECT["masks"] = {}


# -- support and the bridge --------------------------------------------------------------


def test_check_supported_takes_the_eight_flags():
    """All eight flags on the C4 image and the lidar paths, on FPN and on
    VGG16, in serving and training; an unknown Bayes variant and an unknown
    net still raise, each with its reason."""
    fpn = ("USE_FPN", "True", "POOLING_MODE", "multiscale")
    for overrides in (IMAGE, BEV, IMAGE + LIVE18, BEV + LIVE18, IMAGE + fpn, BEV + fpn,
                      IMAGE + ("NET_VARIANT", "vgg16")):
        _, tcfg = _cfgs(overrides)
        t_det.check_supported(tcfg)
        t_det.check_supported(tcfg, training=True)
    _, tcfg = _cfgs(IMAGE)
    for extra, match in (
        (("UC.BAYES_VARIANT", "probit"), "BAYES_VARIANT"),
        (("NET_VARIANT", "alexnet"), "NET_VARIANT"),
    ):
        with pytest.raises(NotImplementedError, match=re.escape(match)):
            t_det.check_supported(t_config.cfg_from_list(tcfg, extra), training=True)


@pytest.mark.parametrize("overrides,live", [
    (BEV + LIVE18, True),
    (IMAGE + ("NET_VARIANT", "res18", "RESNET.FIXED_BLOCKS", "1"), False),
    (IMAGE + ("NET_VARIANT", "res18", "UC.EN_CLS_EPISTEMIC", "False",
              "UC.EN_RPN_CLS_ALEATORIC", "False"), False),
], ids=["bev-live", "image-frozen", "image-box-stack-only"])
def test_bridge_round_trip_with_every_uc_key(overrides, live):
    """JAX variables -> port -> JAX, every leaf equal, both ways strict: the
    RPN variance convs, the variance heads, the stacks (EpistemicStack_0 is
    the box stack when there is no class stack) and the stacks' BN, whose
    statistics stay under `params` with live BN."""
    cfg, tcfg = _cfgs(overrides)
    lidar = cfg.net_type == "lidar"
    x = jnp.zeros((1, 64, 64, cfg.lidar.num_channel if lidar else 3))
    model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, jnp.asarray([[0, 64, 0, 64.0]]))
    rng = np.random.RandomState(1)
    v = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    keys = {"/".join(p) for p, _ in _flat(v["params"])}
    uc_keys = [k for k in keys if "al_var" in k or "EpistemicStack" in k]
    assert any(k.startswith("rpn_bbox_al_var_net") for k in uc_keys)
    assert any("bbox_al_var_net" in k for k in uc_keys)
    if lidar:
        assert "predictors/EpistemicStack_0/cls_bn1/mean" in keys
        assert "predictors/EpistemicStack_1/bbox_bn2/scale" in keys
    t_model = t_det.FasterRCNN(tcfg, K)
    load_flax_variables(t_model, v)
    sd = t_model.state_dict()
    back = to_flax_variables(sd, live_bn=live)
    assert set(back) == set(v)
    for coll in v:
        want, got = dict(_flat(v[coll])), dict(_flat(back[coll]))
        assert set(got) == set(want), coll
        for path, w in want.items():
            np.testing.assert_array_equal(got[path], w, err_msg="/".join(path))
    for k in uc_keys:
        assert flax_path_to_torch_key(tuple(k.split("/"))) in sd
    assert len(from_flax_variables(v)) == len(sd)


# -- serving ----------------------------------------------------------------------------


RPN_1X1 = ("rpn_cls_score_net", "rpn_bbox_pred_net", "rpn_bbox_al_var_net", "rpn_cls_al_var_net")


def _shared_variables(tcfg):
    """The port's init (the JAX package's initializers, init_params) as JAX
    variables, BN statistics and affines randomized (_randomize_bn), and the
    RPN's 1x1 heads scaled by 0.02: on a random res50 C4 map their init
    gives logits of ~300, deltas of ~400 and log-variances of ~100 (exp
    overflows float32, and every proposal is a frame-wide box whose rounding
    moves its pooled RoI), a trained RPN's are a few units.  With frozen BN
    the residual terminators at 0.25, as bench.py scales random weights."""
    live = tcfg.resnet.fixed_blocks == -1
    v = _randomize_bn(to_flax_variables(t_det.init_detector(tcfg, K).state_dict(), live_bn=live),
                      seed=0)
    for path, leaf in _flat(v["params"]):
        if path[-2:] == ("bn3", "scale") and not live:
            leaf[...] = 0.25
        elif path[-1] == "kernel" and any(p in RPN_1X1 for p in path):
            leaf *= 0.02
    return v


@pytest.fixture(scope="module", params=["image", "bev"])
def serving_run(request):
    lidar = request.param == "bev"
    cfg, tcfg = _cfgs(BEV if lidar else IMAGE)
    rng = np.random.RandomState(2)
    if lidar:
        x, window = _raster(tcfg, seed=6)
    else:
        x = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
        window = np.array([[0, W, 0, H], [0, W - 40, 0, H - 24]], np.float32)
    variables = _shared_variables(tcfg)
    port = t_det.FasterRCNN(tcfg, K)
    load_flax_variables(port, variables)
    port.eval()
    a = cfg.uc.a_num_ce_sample
    p = cfg.test.rpn_post_nms_top_n
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
        return model.apply(v, images, win, method=j_det.FasterRCNN.forward_test), _INJECT["samples"]

    with _jax_draws_alike(_jax_masks(draws.masks)):
        want, j_samples = jax.tree.map(np.asarray, jax.jit(forward_test)(
            variables, jnp.asarray(x), jnp.asarray(window)))
    return types.SimpleNamespace(name=request.param, got=got, want=jax.tree.map(np.asarray, want),
                                 masks=draws.masks, lidar=lidar, samples=samples,
                                 j_samples=j_samples)


def test_serving_masks_cover_every_dropout_layer(serving_run):
    """The recorded masks: every Bottleneck's three layers of the backbone
    (RPN samples) and of the tail, and both stacks' two, one a sample."""
    names = set(serving_run.masks)
    assert "backbone.layer1.0.drop2d" in names and "tail.layer4.2.drop3" in names
    assert {"predictors.cls_stack.cls_drop2", "predictors.bbox_stack.bbox_drop1"} <= names
    assert all(m.shape[0] == T for m in serving_run.masks.values())
    assert serving_run.masks["backbone.layer1.0.drop2d"].shape[-2:] == (1, 1)


def test_serving_outputs_match_jax(serving_run):
    """rois and their validity equal within 1e-5 of max; cls_prob (the mean
    of the T softmaxes) and the decoded boxes within 1e-5 of max; for lidar
    each proposal's 3D anchor equal."""
    got, want = serving_run.got, serving_run.want
    np.testing.assert_array_equal(got["roi_valid"].numpy(), want["roi_valid"])
    assert _rel(got["rois"].numpy(), want["rois"]) <= 1e-5
    if serving_run.lidar:
        np.testing.assert_array_equal(got["anchors_3d"].numpy(), want["anchors_3d"])
    for k in ("roi_scores", "cls_prob", "bbox_pred"):
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, k


def test_serving_mc_samples_match_jax(serving_run):
    """Each of the T Monte-Carlo samples, the RPN's (backbone and RPN head
    with live dropout: logits, fg_prob, deltas, both log-variances) and the
    head's (tail and predictors over the once-pooled RoIs: scores, deltas,
    both log-variances), within 1e-5 of max of JAX's sample."""
    rpn, det = serving_run.samples
    j_rpn, j_det_out = serving_run.j_samples
    for got, want in ((rpn, j_rpn), (det, j_det_out)):
        assert set(want) <= set(got)
        for k in want:
            assert got[k].shape[0] == T
            assert _rel(got[k].numpy(), want[k]) <= 1e-5, k


# float32's unit roundoff.  Two keys are differences of nearly equal float32
# sums, in the form JAX computes them: e_cls_var is sum(p^2) - (sum p)^2 / T
# over T softmaxes (compute_bbox_var), terms up to T / (T - 1); a mutual
# information is the entropy of the mean less the mean entropy, terms up to
# log2(classes) bits.  Each package rounds those terms, so beside 1e-5 of
# max the two may differ by a few roundoffs of the terms.
EPS32 = float(np.finfo(np.float32).eps)


def _cancellation_slack(key: str, classes: int) -> float:
    if key == "e_cls_var":
        return 4 * EPS32 * T / (T - 1)
    if key.endswith("mutual_info"):
        return 4 * EPS32 * np.log2(classes)
    return 0.0


@pytest.mark.parametrize("stage", ["uncertainties", "rpn_uncertainties"])
def test_serving_uncertainties_match_jax(serving_run, stage):
    """Every key of both uncertainty dicts (a_entropy, a_mutual_info,
    a_cls_var, a_bbox_var, e_entropy, e_mutual_info, e_cls_var, e_bbox_var)
    within 1e-5 of max|x| of JAX's, and not all zero; e_cls_var and the
    mutual informations within that plus 4 float32 roundoffs of the terms
    they cancel (_cancellation_slack: JAX's own e_cls_var is 1.2e-7 off the
    float64 variance of its samples here, 3e-4 of its max, and the port's
    compute_bbox_var on JAX's samples gives JAX's bits; the samples
    themselves agree within 1e-5, test_serving_mc_samples_match_jax)."""
    got, want = serving_run.got[stage], serving_run.want[stage]
    assert set(got) == set(want) and len(want) == 8, (set(got), set(want))
    errs = {k: _rel(got[k].numpy(), want[k]) for k in want}
    print(f"{serving_run.name} {stage}: error / max|x| {errs}")
    for k, err in errs.items():
        assert np.isfinite(want[k]).all() and np.abs(want[k]).max() > 0, k
        slack = _cancellation_slack(k, K if stage == "uncertainties" else 2)
        assert err * np.abs(want[k]).max() <= 1e-5 * np.abs(want[k]).max() + slack, (k, err)
