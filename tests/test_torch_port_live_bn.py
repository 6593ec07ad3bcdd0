"""Live batch norm, zero-init residual terminators and the BasicBlock
(res18/34), port vs the JAX package, on the CPU (RESNET.FIXED_BLOCKS -1:
training from scratch).

Covered: LiveBatchNorm against JAX FrozenBatchNorm(live=True) in float32 and
bfloat16 (train-mode output, running statistics, gradients, eval output);
res18/res34 ResNetC4, ResNetLayer4 and ResNetPyramid, frozen and live,
at 64x96; the weight bridge with the `batch_stats` collection; init_params'
zeroed terminators; the optimizer masks on res18 keys; a bfloat16 step
whose running-statistics update lands on the model's float32 buffers; and
the CLIs at res18 with live BN.  One res18 live-BN training step each of
the image C4, FPN and LiDAR BEV detectors against JAX's jitted step is in
tests/test_torch_port_live_bn_step.py, on this file's configurations,
weights and raster.

The shared weights are JAX's init with every BN scale in [0.5, 1.5] (the
terminators too, which the init zeroes), BN biases and running means small
normals and running variances in [0.5, 1.5], all from numpy seeds.
"""

from __future__ import annotations

import types
from functools import partial

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.config import cfg_from_list, default_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import resnet as j_resnet  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.ops.voxelize import (  # noqa: E402
    voxelize_bev as j_voxelize,
)
from faster_rcnn_pytorch_multimodal_tpu.training import optim as j_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import resnet as t_resnet  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import optim as t_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as t_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    from_flax_variables,
    load_flax_variables,
    to_flax_variables,
)
from tests.test_torch_port_train import _flat  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402,F401  (the repo root on sys.path, for the tests that import this file)

B, H, W, K, G = 2, 128, 192, 2, 8
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box")
LIVE = ("NET_VARIANT", "res18", "RESNET.FIXED_BLOCKS", "-1")
# tests/test_torch_port_train.py's training overrides at res18 with live BN
IMAGE = (
    "NET_TYPE", "image", "COMPUTE_DTYPE", "float32", "PIXEL_STDDEVS", "[60.,60.,60.]",
    "TRAIN.ROI_BATCH_SIZE", "32", "STATIC.NMS_PRE_TRAIN", "256",
    "TRAIN.RPN_POST_NMS_TOP_N", "64", "TRAIN.RPN_BATCHSIZE", "64", "STATIC.MAX_GT", str(G),
    "TRAIN.USE_GT", "True", "TRAIN.USE_GT_NOISE", "True", "TRAIN.LEARNING_RATE", "0.01",
    "TRAIN.MOMENTUM", "0.9", "TEST.SCALES", "(1.0,)", "STATIC.NMS_PRE_TEST", "256",
    "TEST.RPN_POST_NMS_TOP_N", "32",
) + LIVE
FPN = IMAGE + ("USE_FPN", "True", "POOLING_MODE", "multiscale", "STATIC.NMS_PRE_TRAIN", "2048",
               "STATIC.NMS_PRE_TEST", "2048")
BEV_SCALE = 0.25
BEV = (
    "NET_TYPE", "lidar", "COMPUTE_DTYPE", "float32", "TRAIN.SCALES", f"({BEV_SCALE},)",
    "TEST.SCALES", f"({BEV_SCALE},)", "STATIC.MAX_POINTS", "9000", "TRAIN.ROI_BATCH_SIZE", "32",
    "STATIC.NMS_PRE_TRAIN", "256", "TRAIN.RPN_POST_NMS_TOP_N", "64",
    "TRAIN.RPN_BATCHSIZE", "64", "STATIC.MAX_GT", str(G), "TRAIN.USE_GT", "True",
    "TRAIN.USE_GT_NOISE", "True", "TRAIN.LEARNING_RATE", "0.01", "TRAIN.MOMENTUM", "0.9",
    "LIDAR.REG_LOSS_WEIGHT", "(1.0, 1.0, 0.5, 1.0, 1.0, 0.5, 2.0)",
    "STATIC.NMS_PRE_TEST", "256", "TEST.RPN_POST_NMS_TOP_N", "32",
) + LIVE


def _cfgs(overrides):
    return (cfg_from_list(default_config(), overrides),
            t_config.cfg_from_list(t_config.default_config(), overrides))


def _t(a):
    return torch.from_numpy(np.array(a))


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach()


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale + 1e-12, (what, err, scale)


def _is_bn(path) -> bool:
    return path[-2].startswith("bn") or path[-2] == "downsample_bn"


def _randomize_bn(variables, seed):
    """The variables with every BN scale in [0.5, 1.5], BN biases and
    running means normal(0, 0.1), running variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    out = {}
    for coll, tree in variables.items():
        flat = {}
        for path, v in _flat(tree):
            v = np.array(v, np.float32)
            if path[-1] == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif path[-1] == "mean" or (path[-1] == "bias" and _is_bn(path)):
                v = rng.normal(0, 0.1, v.shape)
            elif path[-1] == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            flat[path] = v.astype(np.float32)
        node = out.setdefault(coll, {})
        for path, v in flat.items():
            n = node
            for p in path[:-1]:
                n = n.setdefault(p, {})
            n[path[-1]] = v
    return out


# -- LiveBatchNorm ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_live_batch_norm_matches_jax(dtype):
    """Train mode: the output, the running statistics after the update and
    the gradients of x, weight and bias; then eval mode on the updated
    statistics.  float32 within 1e-5 of max; bfloat16 activations within one
    bf16 ulp of max (the statistics and the affine in float32, the affine
    rounded to bf16 on both sides, as JAX does)."""
    rng = np.random.RandomState(0)
    c = 12
    x = rng.normal(1.5, 2.0, (4, 7, 5, c)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.normal(0, 0.1, c).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)},
    }
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j_bn = j_resnet.FrozenBatchNorm(c, live=True)

    def loss(params, xx):
        y, mut = j_bn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            xx.astype(jdt), True, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * dy), (y, mut)

    (_, (j_y, j_mut)), (j_gp, j_gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    j_eval = j_bn.apply({"params": variables["params"], **j_mut}, jnp.asarray(x).astype(jdt), False)

    t_bn = t_resnet.LiveBatchNorm(c)
    sd = from_flax_variables({coll: {"backbone": {"stem": {"bn1": tree}}}
                              for coll, tree in variables.items()})
    t_bn.load_state_dict({k[len("backbone.bn1."):]: v for k, v in sd.items()}, strict=True)
    assert set(t_bn.state_dict()) == {"weight", "bias", "running_mean", "running_var"}
    assert [n for n, _ in t_bn.named_parameters()] == ["weight", "bias"]
    t_bn.train()
    tx = _t(x).permute(0, 3, 1, 2).to(tdt).detach().requires_grad_(True)
    t_y = t_bn(tx)
    assert t_y.dtype == tdt and t_bn.running_mean.dtype == torch.float32
    t_y.float().backward(_t(dy).permute(0, 3, 1, 2))
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    _close(_nhwc(t_y).float().numpy(), np.asarray(j_y, np.float32), tol, "train output")
    _close(t_bn.running_mean.numpy(), j_mut["batch_stats"]["mean"], 1e-5, "running mean")
    _close(t_bn.running_var.numpy(), j_mut["batch_stats"]["var"], 1e-5, "running var")
    got = {"dx": _nhwc(tx.grad).float().numpy(), "dweight": t_bn.weight.grad.numpy(),
           "dbias": t_bn.bias.grad.numpy()}
    want = {"dx": np.asarray(j_gx, np.float32), "dweight": np.asarray(j_gp["scale"]),
            "dbias": np.asarray(j_gp["bias"])}
    if dtype == "float32":
        for k in got:
            _close(got[k], want[k], 1e-4, k)
    else:
        # both against float64 batch norm on the same bf16 input: the port's
        # gradients within two bf16 ulps of max; JAX's CPU backend sums the
        # weight and bias gradients in bf16 (1.9e-2 off on this input), so
        # it is held within four, and the two within the sum
        x64 = _t(x).to(torch.bfloat16).double().permute(0, 3, 1, 2).requires_grad_(True)
        w64, b64 = (_t(variables["params"][k]).double().requires_grad_(True)
                    for k in ("scale", "bias"))
        mean = x64.mean((0, 2, 3), keepdim=True)
        var = (x64 - mean).square().mean((0, 2, 3), keepdim=True)
        y64 = (x64 - mean) / torch.sqrt(var + 1e-5) * w64[:, None, None] + b64[:, None, None]
        y64.backward(_t(dy).double().permute(0, 3, 1, 2))
        ref = {"dx": _nhwc(x64.grad).numpy(), "dweight": w64.grad.numpy(),
               "dbias": b64.grad.numpy()}
        ulp = 2.0 ** -7
        for k in got:
            _close(got[k], ref[k], 2 * ulp, f"{k} port vs float64")
            _close(want[k], ref[k], 4 * ulp, f"{k} JAX vs float64")
            _close(got[k], want[k], 6 * ulp, f"{k} port vs JAX")
    t_bn.eval()
    with torch.no_grad():
        t_eval = t_bn(_t(x).permute(0, 3, 1, 2).to(tdt))
    _close(_nhwc(t_eval).float().numpy(), np.asarray(j_eval, np.float32), tol, "eval output")


# -- backbones -------------------------------------------------------------------


def _flax_backbone(kind, depth, live):
    kw = dict(live_bn=live, zero_init_residual=live)
    if kind == "c4":
        return j_resnet.ResNetC4(depth, remat=False, **kw), ("backbone",)
    if kind == "pyramid":
        return j_resnet.ResNetPyramid(depth, remat=False, **kw), ("backbone",)
    return j_resnet.ResNetLayer4(depth, **kw), ("tail",)


def _torch_backbone(kind, depth, live):
    kw = dict(live_bn=live, zero_init_residual=live)
    if kind == "c4":
        return t_resnet.ResNetC4(depth, **kw)
    if kind == "pyramid":
        return t_resnet.ResNetPyramid(depth, **kw)
    return t_resnet.ResNetLayer4(depth, **kw)


@pytest.mark.parametrize("live", [False, True], ids=["frozen", "live"])
@pytest.mark.parametrize("kind", ["c4", "layer4", "pyramid"])
@pytest.mark.parametrize("depth", [18, 34])
def test_basic_backbones_match_jax(depth, kind, live):
    """res18/res34 at 64x96 (layer4: 6 pooled 7x7 RoIs): the outputs within
    1e-4 of max (the serving slices' tolerance for the C4 map: 8 to 16
    blocks of float32 convs summed in another order; live BN over c5's 12
    rows a channel magnifies it), in train mode for live BN, then the
    running statistics within 1e-5 and the eval-mode outputs; the
    out_channels the detector reads."""
    if kind == "layer4":
        x = np.random.RandomState(1).normal(size=(6, 7, 7, 256)).astype(np.float32)
    else:
        x = np.random.RandomState(1).normal(size=(2, 64, 96, 3)).astype(np.float32)
    j_mod, root = _flax_backbone(kind, depth, live)
    variables = _randomize_bn(j_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=2)
    if live:
        j_out, j_mut = j_mod.apply(variables, jnp.asarray(x), True, True, mutable=["batch_stats"])
        j_eval = j_mod.apply({**variables, **j_mut}, jnp.asarray(x))
    else:
        j_out = j_mod.apply(variables, jnp.asarray(x))
    sd = from_flax_variables({coll: {root[0]: tree} for coll, tree in variables.items()})
    prefix = root[0] + "."
    t_mod = _torch_backbone(kind, depth, live)
    t_mod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    if not live:
        t_mod.eval()
    assert all(isinstance(m, (t_resnet.LiveBatchNorm if live else t_resnet.FrozenBatchNorm))
               for m in t_mod.modules() if isinstance(m, t_resnet.FrozenBatchNorm))
    with torch.no_grad():
        t_out = t_mod(_t(x).permute(0, 3, 1, 2))
    outs = (t_out,) if kind != "pyramid" else t_out
    j_outs = (j_out,) if kind != "pyramid" else j_out
    for got, want in zip(outs, j_outs):
        _close(_nhwc(got).numpy(), want, 1e-4, f"res{depth} {kind} output")
    want_ch = {"c4": 256, "layer4": 512, "pyramid": (64, 128, 256, 512)}[kind]
    assert t_mod.out_channels == want_ch
    assert [o.shape[1] for o in outs] == list(np.atleast_1d(want_ch))
    if live:
        stats = dict(_flat(j_mut["batch_stats"]))
        for path, v in stats.items():
            key = flax_path_to_torch_key((root[0],) + path)[len(prefix):]
            _close(t_mod.state_dict()[key].numpy(), v, 1e-5, key)
        t_mod.eval()
        with torch.no_grad():
            t_eval = t_mod(_t(x).permute(0, 3, 1, 2))
        for got, want in zip((t_eval,) if kind != "pyramid" else t_eval,
                             (j_eval,) if kind != "pyramid" else j_eval):
            _close(_nhwc(got).numpy(), want, 1e-4, f"res{depth} {kind} eval output")


# -- the detector's modules, bridge, init and masks --------------------------------


@pytest.fixture(scope="module")
def c4_init():
    cfg, tcfg = _cfgs(IMAGE)
    x = np.zeros((1, 64, 96, 3), np.uint8)
    window = np.array([[0, 96, 0, 64]], np.float32)
    variables = j_det.FasterRCNN(cfg=cfg, num_classes=K).init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(window))
    return types.SimpleNamespace(cfg=cfg, tcfg=tcfg, variables=jax.tree.map(np.asarray, variables))


@pytest.mark.parametrize("depth", [18, 34, 50, 101])
@pytest.mark.parametrize("net", ["image", "fpn", "lidar"])
@pytest.mark.parametrize("fixed_blocks", [1, -1])
def test_detector_builds_every_depth(depth, net, fixed_blocks):
    """res18/34/50/101, frozen and live, for image C4, FPN and lidar: the
    widths come from the built backbone, check_supported accepts the
    config in serving and training, and the modules are live or frozen."""
    base = {"image": IMAGE, "fpn": FPN, "lidar": BEV}[net]
    tcfg = t_config.cfg_from_list(t_config.default_config(), base + (
        "NET_VARIANT", f"res{depth}", "RESNET.FIXED_BLOCKS", str(fixed_blocks)))
    t_det.check_supported(tcfg)
    t_det.check_supported(tcfg, training=True)
    with torch.device("meta"):
        model = t_det.FasterRCNN(tcfg, K)
    exp = 1 if depth in (18, 34) else 4
    if net == "fpn":
        assert model.fpn.latlayer2.in_channels == 64 * exp
        assert model.fpn.latlayer5.in_channels == 512 * exp
        assert model.tail.t_fc1.in_features == 256 * 7 * 7
        assert model.rpn.rpn_net.in_channels == 256
    else:
        assert model.rpn.rpn_net.in_channels == 256 * exp
        assert model.predictors.cls_score_net.in_features == 512 * exp
    bns = [m for m in model.modules() if isinstance(m, t_resnet.FrozenBatchNorm)]
    live = fixed_blocks == -1
    assert bns and all(isinstance(m, t_resnet.LiveBatchNorm) == live for m in bns)


def test_check_supported_still_raises():
    """With live BN, fault F2, an unknown Bayes variant, an unknown net and
    VGG16 with FPN still raise; UC with FPN, VGG16 and MobileNet, FPN on
    lidar and USE_LIDAR_FPN are accepted."""
    _, tcfg = _cfgs(IMAGE)
    for extra, match in (
        (("UC.BAYES_VARIANT", "probit"), "BAYES_VARIANT"),
        (("NET_VARIANT", "res200"), "NET_VARIANT"),
        (("USE_FPN", "True", "POOLING_MODE", "align"), "F2"),
        (("NET_VARIANT", "vgg16", "USE_FPN", "True", "POOLING_MODE", "multiscale"), "ResNet-only"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            t_det.check_supported(t_config.cfg_from_list(tcfg, extra), training=True)
    for extra in (("UC.EN_CLS_ALEATORIC", "True", "USE_FPN", "True", "POOLING_MODE", "multiscale"),
                  ("NET_VARIANT", "vgg16"), ("NET_VARIANT", "mobile")):
        t_det.check_supported(t_config.cfg_from_list(tcfg, extra), training=True)
    _, lidar = _cfgs(BEV)
    t_det.check_supported(lidar.replace(use_lidar_fpn=True), training=True)
    t_det.check_supported(lidar.replace(use_fpn=True, pooling_mode="multiscale"))


def test_bridge_round_trip_with_batch_stats(c4_init):
    """JAX live variables -> port -> JAX, every leaf equal, the statistics
    under `batch_stats` and none under `params`; a strict load both ways:
    an unmapped leaf, a statistic under `params` or a scale under
    `batch_stats` raises."""
    v = c4_init.variables
    assert "batch_stats" in v and not any(p[-1] in ("mean", "var") for p, _ in _flat(v["params"]))
    sd = from_flax_variables(v)
    assert "backbone.layer1.0.bn2.running_var" in sd and "tail.layer4.1.conv2.weight" in sd
    assert "backbone.layer2.0.downsample.1.running_mean" in sd
    model = t_det.FasterRCNN(c4_init.tcfg, K)
    load_flax_variables(model, v)
    back = to_flax_variables(model.state_dict(), live_bn=True)
    assert set(back) == {"params", "batch_stats"}
    for coll in ("params", "batch_stats"):
        want, got = dict(_flat(v[coll])), dict(_flat(back[coll]))
        assert set(got) == set(want), coll
        for p in want:
            np.testing.assert_array_equal(got[p], want[p])
    bad_stat = jax.tree.map(lambda a: a, v)
    bad_stat["params"]["backbone"]["stem"]["bn1"]["mean"] = np.zeros(64, np.float32)
    with pytest.raises(KeyError, match="params"):
        from_flax_variables(bad_stat)
    bad_scale = jax.tree.map(lambda a: a, v)
    bad_scale["batch_stats"]["backbone"]["stem"]["bn1"]["scale"] = np.ones(64, np.float32)
    with pytest.raises(KeyError, match="batch_stats"):
        from_flax_variables(bad_scale)
    unmapped = jax.tree.map(lambda a: a, v)
    unmapped["params"]["backbone"]["layer1"]["block0"]["gate"] = {"kernel": np.zeros((1, 1, 1, 1))}
    with pytest.raises(KeyError):
        from_flax_variables(unmapped)
    with pytest.raises(KeyError):
        to_flax_variables({"backbone.layer1.0.gate.weight": torch.zeros(1)}, live_bn=True)
    missing = from_flax_variables(v)
    missing.pop("tail.layer4.0.bn1.running_mean")
    with pytest.raises(RuntimeError):
        t_det.FasterRCNN(c4_init.tcfg, K).load_state_dict(missing, strict=True)


@pytest.mark.parametrize("net,depth,fixed_blocks", [
    ("image", 18, -1), ("image", 18, 1), ("image", 50, -1), ("image", 50, 0),
    ("fpn", 18, -1), ("lidar", 18, -1),
])
def test_init_zeroes_terminators_as_jax(net, depth, fixed_blocks):
    """Every BN leaf of init_params against JAX's init: scale 1 but the
    residual terminators' (bn2 of a BasicBlock, bn3 of a Bottleneck) 0, and
    only at FIXED_BLOCKS -1; bias and mean 0, var 1."""
    base = {"image": IMAGE, "fpn": FPN, "lidar": BEV}[net]
    extra = ("NET_VARIANT", f"res{depth}", "RESNET.FIXED_BLOCKS", str(fixed_blocks))
    cfg, tcfg = _cfgs(base + extra)
    c = cfg.lidar.num_channel if net == "lidar" else 3
    x = np.zeros((1, 64, 64, c), np.float32 if net == "lidar" else np.uint8)
    window = np.array([[0, 64, 0, 64]], np.float32)
    variables = j_det.FasterRCNN(cfg=cfg, num_classes=K).init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(window))
    sd = t_det.init_detector(tcfg, K, seed=0).state_dict()
    n_zero = 0
    for coll in variables:
        for path, v in _flat(variables[coll]):
            if path[-1] in ("scale", "mean", "var") or (path[-1] == "bias" and _is_bn(path)):
                key = flax_path_to_torch_key(path)
                np.testing.assert_array_equal(sd[key].numpy(), np.asarray(v), err_msg=key)
                n_zero += path[-1] == "scale" and not np.asarray(v).any()
    blocks = sum(t_resnet.STAGE_BLOCKS[depth])
    assert n_zero == (blocks if fixed_blocks == -1 else 0)


@pytest.mark.parametrize("fixed_blocks,bias_decay", [(-1, False), (-1, True), (1, False)])
def test_masks_match_jax_on_res18(c4_init, fixed_blocks, bias_decay):
    """frozen_mask, decay_mask and bias_mask on res18 keys, live BN and
    frozen, against the JAX package's; at -1 the stem and every BN affine
    train and decay as JAX's masks say, the statistics never train."""
    extra = ("RESNET.FIXED_BLOCKS", str(fixed_blocks), "TRAIN.BIAS_DECAY", str(bias_decay))
    cfg, tcfg = _cfgs(IMAGE + extra)
    params = c4_init.variables["params"]
    if fixed_blocks >= 0:
        x = np.zeros((1, 64, 96, 3), np.uint8)
        window = np.array([[0, 96, 0, 64]], np.float32)
        params = j_det.FasterRCNN(cfg=cfg, num_classes=K).init(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(window))["params"]
    want = {name: {flax_path_to_torch_key(p): bool(v) for p, v in _flat(fn(params))}
            for name, fn in (("frozen", lambda t: j_optim.frozen_mask(t, cfg)),
                             ("decay", lambda t: j_optim.decay_mask(t, cfg)),
                             ("bias", j_optim.bias_mask))}
    with torch.device("meta"):
        model = t_det.FasterRCNN(tcfg, K)
    keys = [n for n, _ in model.named_parameters()] if fixed_blocks < 0 else list(want["frozen"])
    assert t_optim.frozen_mask(keys, tcfg) == want["frozen"]
    assert t_optim.decay_mask(keys, tcfg) == want["decay"]
    assert t_optim.bias_mask(keys) == want["bias"]
    if fixed_blocks < 0:
        assert set(keys) == set(want["frozen"])
        assert not any(want["frozen"].values())
        assert want["decay"]["backbone.bn1.weight"] and not want["decay"]["backbone.bn1.bias"] \
            or bias_decay
        assert all(t_optim.is_frozen(f"backbone.layer1.0.bn1.{k}", tcfg)
                   for k in ("running_mean", "running_var"))


# -- one training step -------------------------------------------------------------


def _raster(tcfg, seed):
    """Two synthetic LiDAR frames rasterized as the JAX loader does."""
    db = SyntheticDataset(tcfg, num_frames=B, mode="train", seed=seed)
    frames = [db.frame(i) for i in range(B)]
    p = tcfg.static.max_points
    pts = np.zeros((B, p, 5), np.float32)
    valid = np.zeros((B, p), bool)
    for i, f in enumerate(frames):
        pts[i, : len(f["points"])] = f["points"][:p]
        valid[i, : len(f["points"])] = True
    grid = raster_kwargs(tcfg, BEV_SCALE)
    x = np.asarray(jax.jit(jax.vmap(partial(j_voxelize, **grid)))(jnp.asarray(pts),
                                                                   jnp.asarray(valid)))
    return x, np.stack([f["window"] for f in frames])


# -- bfloat16: the running statistics land on the model ----------------------------


def test_bf16_step_updates_the_float32_running_stats():
    """A bfloat16 step (functional_call on cast_for_compute) moves the
    model's float32 running statistics in place, to what a float32 forward
    on the bf16-rounded weights gives, within bf16 rounding; the statistics
    are never cast, and the eval pass (solver.detect) reads them and leaves
    the model in train mode."""
    tcfg = t_config.cfg_from_list(t_config.default_config(), IMAGE + ("COMPUTE_DTYPE", "bfloat16"))
    model, opt = t_solver.create_train_state(tcfg, K, "cpu", seed=0)
    stats = t_det.live_bn_stats(model)
    assert stats and all(v.dtype == torch.float32 for v in stats.values())
    casts = t_solver.cast_for_compute(model)
    assert all(casts[k] is v for k, v in stats.items())
    assert casts["backbone.bn1.weight"].dtype == torch.bfloat16
    ids = {k: id(v) for k, v in stats.items()}
    before = {k: v.clone() for k, v in stats.items()}
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 256, (B, 64, 96, 3)).astype(np.uint8))
    gt = torch.zeros((B, G, 5))
    gt[:, 0] = torch.tensor([10.0, 12.0, 60.0, 50.0, 1.0])
    mask = torch.zeros((B, G), dtype=torch.bool)
    mask[:, 0] = True
    batch = {"data": x, "gt_boxes": gt, "gt_mask": mask,
             "window": torch.tensor([[0.0, 96.0, 0.0, 64.0]] * B)}
    draws = t_solver.draw_train_keys(model, batch, torch.Generator().manual_seed(0))
    # the stem's statistics of a float32 forward on bf16-rounded weights and input
    xf = ((x.float() - torch.tensor(tcfg.pixel_means)) / torch.tensor(tcfg.pixel_stddevs))
    xb = xf.to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        conv = torch.nn.functional.conv2d(xb, model.backbone.conv1.weight.to(torch.bfloat16),
                                          stride=2, padding=3).float()
    mean = conv.mean((0, 2, 3))
    losses, _ = t_solver.make_train_step(model, opt)(batch, draws)
    assert np.isfinite(float(losses["total_loss"]))
    after = t_det.live_bn_stats(model)
    assert {k: id(v) for k, v in after.items()} == ids
    assert all(v.dtype == torch.float32 for v in after.values())
    moved = [k for k in stats if not torch.equal(after[k], before[k])]
    assert len(moved) == len(stats), set(stats) - set(moved)
    want = 0.9 * before["backbone.bn1.running_mean"] + 0.1 * mean
    np.testing.assert_allclose(after["backbone.bn1.running_mean"].numpy(), want.numpy(),
                               atol=2e-2 * float(want.abs().max()))
    model.train()
    frozen = {k: v.clone() for k, v in after.items()}
    out = t_solver.detect(model, x, batch["window"])
    assert model.training and out["cls_prob"].dtype == torch.float32
    assert all(torch.equal(after[k], frozen[k]) for k in frozen)


def test_to_device_keeps_live_stats_float32():
    """Serving a live-BN model: to_device casts it to bfloat16 and eval
    mode, the running statistics stay float32 (and exact), as they do
    through any cast of the module."""
    bn = t_resnet.LiveBatchNorm(4)
    bn.running_var.fill_(1 + 2 ** -20)
    bn.bfloat16().half()
    assert bn.weight.dtype == torch.float16 and bn.running_mean.dtype == torch.float32
    assert (bn.running_var == 1 + 2 ** -20).all()
    tcfg = t_config.cfg_from_list(t_config.default_config(), IMAGE + ("COMPUTE_DTYPE", "bfloat16"))
    model = t_det.init_detector(tcfg, K, seed=0)
    with torch.no_grad():
        for v in t_det.live_bn_stats(model).values():
            v.add_(torch.rand(v.shape, generator=torch.Generator().manual_seed(1)) * 1e-3)
    before = {k: v.clone() for k, v in t_det.live_bn_stats(model).items()}
    served = t_det.to_device(model, "cpu")
    assert not served.training
    assert served.backbone.conv1.weight.dtype == torch.bfloat16
    assert served.backbone.bn1.weight.dtype == torch.bfloat16
    after = t_det.live_bn_stats(served)
    assert set(after) == set(before)
    for k, v in after.items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 64, 96, 3)).astype(np.uint8))
    with torch.inference_mode():
        out = served.forward_test(x, torch.tensor([[0.0, 96.0, 0.0, 64.0]]))
    assert torch.isfinite(out["cls_prob"]).all()


def _tool(name):
    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("net_type", ["image", "lidar"])
def test_clis_take_res18_with_live_bn(net_type, tmp_path, monkeypatch):
    """tools/trainval_net_torch.py and tools/test_net_torch.py with --net
    res18 --fixed_blocks -1: two training steps with finite losses, and a
    serving pass of a res34 live-BN model.  The Solver's logs are JSONL
    only here: torch.utils.tensorboard would import TensorFlow into the test
    process."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    small = ["--scale", "0.25"] if net_type == "lidar" else []
    sets = ["STATIC.MAX_POINTS", "8192"] if net_type == "lidar" else []
    res = _tool("trainval_net_torch").main(
        ["--device", "cpu", "--net", "res18", "--fixed_blocks", "-1", "--net_type", net_type,
         "--iters", "2", "--batch_size", "2", "--out_dir", str(tmp_path)] + small
        + ["--set", "STATIC.NMS_PRE_TRAIN", "256", "TRAIN.RPN_POST_NMS_TOP_N", "64",
           "TRAIN.ROI_BATCH_SIZE", "32"] + sets)
    assert len(res["ms"]) == 2
    assert all(np.isfinite(v) for losses in res["history"] for v in losses.values())
    m_ap = _tool("test_net_torch").main(
        ["--device", "cpu", "--net", "res34", "--fixed_blocks", "-1", "--net_type", net_type,
         "--max_frames", "2", "--batch_size", "2", "--out_dir", str(tmp_path)]
        + small + ["--set", "STATIC.NMS_PRE_TEST", "256", "TEST.RPN_POST_NMS_TOP_N", "32"] + sets)
    assert 0.0 <= m_ap <= 1.0
