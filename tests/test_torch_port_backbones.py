"""VGG16 and MobileNetV1 in the PyTorch port against the JAX package, on the
CPU, in float32.

Covered: the backbone and tail modules (VGG16 and MobileNet at depth
multipliers 1 and 0.5) through the detector's `features` and
`pooled_head`, VGG16's drop6 / drop7 given the same masks; the weight
bridge both ways, bitwise, image and BEV; the converters against the JAX
package's on the same dict, bitwise: a torchvision-layout vgg16 state dict
(fc6's CHW -> HWC rows), a reference-layout MobileNet one, the tf-slim
renames of all three nets, `replicate_conv1_for_lidar` and the port's
tf-slim tool; the preload of RGB weights into a BEV stem; the frozen, decay
and bias masks leaf by leaf at FIXED_BLOCKS 1, 3 and -1 (MobileNet's dw_bn
/ pw_bn names, its separable layers as the frozen blocks, its BN affine
trained at -1); and image (64x96 frames) and BEV (200 x 175 x 15 rasters
at scale 0.25) serving and one training step of each net: serving outputs
within 1e-5 of max|x|, the losses within rtol 1e-4 and every trainable
leaf's gradient within 1e-3 of its max|g|, the second stage pinned to
JAX's proposal lanes and fed JAX's draws (test_torch_port_train), each
ReLU unit at 0 within rounding given JAX's gate (chip_smoke.pinned_ties).
A VGG16 feature map floors (four 2x2 pools): a 200 x 175 raster gives 12 x
10 cells where ResNet's C4 gives 13 x 11, and the anchors follow it.
"""

from __future__ import annotations

import sys
import types
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_port_threads import two_threads  # noqa: E402, F401
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.models import detector as j_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.training import optim as j_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.utils import convert as j_convert  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import optim as t_optim  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as t_solver  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils import convert as t_convert  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    flax_path_to_torch_key,
    from_flax_variables,
    load_flax_variables,
    to_flax_variables,
)
from tests.test_torch_port_fpn import _jax_site as _resnet_site  # noqa: E402
from tests.test_torch_port_fpn import _torch_layout  # noqa: E402
from tests.test_torch_port_live_bn import _raster  # noqa: E402
from tests.test_torch_port_train import _flat, jax_draws  # noqa: E402
from tests.test_torch_port_uc import _cfgs, _jax_draws_alike, _jax_masks, _rel, _t  # noqa: E402

import chip_smoke  # noqa: E402  (the repo root is on sys.path: test_torch_port_live_bn)

B, K, G = 2, 2, 8
H, W = 64, 96
LOSSES = ("rpn_cross_entropy", "rpn_loss_box", "cross_entropy", "loss_box")
COMMON = (
    "COMPUTE_DTYPE", "float32", "TRAIN.ROI_BATCH_SIZE", "32", "STATIC.NMS_PRE_TRAIN", "256",
    "TRAIN.RPN_POST_NMS_TOP_N", "64", "TRAIN.RPN_BATCHSIZE", "64", "STATIC.MAX_GT", str(G),
    "TRAIN.USE_GT", "True", "TRAIN.USE_GT_NOISE", "True", "STATIC.NMS_PRE_TEST", "256",
    "TEST.RPN_POST_NMS_TOP_N", "32",
)
IMAGE = ("NET_TYPE", "image", "PIXEL_STDDEVS", "[60.,60.,60.]", "TEST.SCALES", "(1.0,)") + COMMON
BEV = ("NET_TYPE", "lidar", "TRAIN.SCALES", "(0.25,)", "TEST.SCALES", "(0.25,)",
       "STATIC.MAX_POINTS", "9000",
       "LIDAR.REG_LOSS_WEIGHT", "(1.0, 1.0, 0.5, 1.0, 1.0, 0.5, 2.0)") + COMMON
# VGG16 at its published widths, over 3x3 pooled RoIs: fc6 takes 3 * 3 *
# 512 inputs (25,088 at the default 7x7, 400 MB of float32 a copy: the
# converter test alone builds that one)
VGG = ("NET_VARIANT", "vgg16", "POOLING_SIZE", "3")
MOBILE = ("NET_VARIANT", "mobile")
HALF = ("MOBILENET.DEPTH_MULTIPLIER", "0.5")
CASES = {"vgg16-image": IMAGE + VGG, "mobile-image": IMAGE + MOBILE,
         "vgg16-bev": BEV + VGG, "mobile-bev": BEV + MOBILE + HALF}
PLAIN_BN = ("bn0", "dw_bn", "pw_bn")


def _clipped_normal(w, std, g):
    """init_params' truncated normal drawn faster (normal, clipped at 2
    std): torch's trunc_normal_ (erfinv) takes seconds over VGG16's 50M
    weights."""
    w.normal_(0.0, std / t_det._TRUNC, generator=g).clamp_(-2.0 * std / t_det._TRUNC,
                                                         2.0 * std / t_det._TRUNC)


def _variables(tcfg, seed=0):
    """The port's init (the JAX package's initializers, init_params; the
    truncated normals drawn by _clipped_normal) as JAX variables,
    MobileNet's BN randomized: scales and variances in [0.5, 1.5], biases
    and means normal(0, 0.1).  VGG16 and MobileNet keep every BN statistic
    under `params` (no live BN)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_det, "_trunc_normal", _clipped_normal)
        v = to_flax_variables(t_det.init_detector(tcfg, K, seed).state_dict())
    rng = np.random.RandomState(seed)
    for path, leaf in _flat(v["params"]):
        if path[-2] in PLAIN_BN:
            if path[-1] in ("scale", "var"):
                leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)
            else:
                leaf[...] = rng.normal(0, 0.1, leaf.shape)
    return v


def _port(tcfg, variables):
    """A port model holding `variables` (a JAX tree, or the port's state
    dict from_flax_variables made of it), built on the meta device: no
    init of its own to overwrite."""
    with torch.device("meta"):
        model = t_det.FasterRCNN(tcfg, K)
    model = model.to_empty(device="cpu")
    if "params" in variables:
        load_flax_variables(model, variables)
    else:
        model.load_state_dict(variables, strict=True)
    return model


def _random_state(tcfg, seed):
    """A port state dict of standard normals, drawn fast (no init)."""
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=g) for k, v in _meta_port(tcfg).state_dict().items()}


def _frames(tcfg, rng):
    if tcfg.net_type == "lidar":
        return _raster(tcfg, seed=6)
    x = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    return x, np.array([[0, W, 0, H], [0, W - 40, 0, H - 24]], np.float32)


# -- modules ------------------------------------------------------------------------------


@pytest.mark.parametrize("net", ["vgg16", "mobile", "mobile-0.5"])
def test_backbone_and_tail_match_jax(net):
    """`features` (VGG16Head: 13 convs, four floored pools; MobileNetV1Head:
    conv0, bn0, layers 1-11) on two 64x96 frames and `pooled_head` (VGG16's
    fc6 / fc7 over RoIs flattened in (y, x, c) order, drop6 and drop7 live
    with the same masks; MobileNet's layers 12-13 at stride 1 and the mean)
    on random (2, 5, P, P, C) RoIs, within 1e-5 of max|x|."""
    overrides = IMAGE + (VGG if net == "vgg16" else MOBILE + (HALF if net.endswith("0.5") else ()))
    cfg, tcfg = _cfgs(overrides)
    v = _variables(tcfg)
    port = _port(tcfg, v).eval()
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    jm = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    want = np.asarray(jax.jit(partial(jm.apply, method=lambda m, a: m.features(a)["rpn"]))(
        v, jnp.asarray(x)))
    with torch.no_grad():
        got = port.features(_t(x))
    assert got.shape == want.shape == (B, H // 16, W // 16, port.backbone.out_channels)
    assert port.backbone.out_channels == (512 if net != "mobile-0.5" else 256)
    assert _rel(got.numpy(), want) <= 1e-5
    p = tcfg.pooling_size
    pooled = rng.normal(0, 1, (B, 5, p, p, port.backbone.out_channels)).astype(np.float32)
    draws = t_det.UCDraws(torch.Generator().manual_seed(1), record=True)
    with torch.no_grad(), t_det.live_dropout(draws, port.tail):
        got = port.pooled_head(_t(pooled), B, 5)
    if net == "vgg16":
        assert set(draws.masks) == {"tail.drop6", "tail.drop7"}
        assert draws.masks["tail.drop6"].shape == (1, B * 5, 4096)
    else:
        assert not draws.masks  # MobileNet has no dropout layer
    with _jax_draws_alike(_jax_masks(draws.masks)):
        want = jm.apply(v, jnp.asarray(pooled), B, 5, deterministic=False,
                        method=j_det.FasterRCNN.pooled_head)
    for k in ("cls_score", "bbox_pred"):
        assert _rel(got[k].numpy(), np.asarray(want[k])) <= 1e-5, k


# -- the bridge, the converters, preload --------------------------------------------------


def _jax_shapes(cfg, hw=(64, 64)):
    x = jnp.zeros((1,) + hw + (cfg.lidar.num_channel if cfg.net_type == "lidar" else 3,))
    model = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), x, jnp.asarray([[0, 64, 0, 64.0]]))


@pytest.mark.parametrize("case", ["vgg16-image", "mobile-bev"])
def test_bridge_round_trip_bitwise(case):
    """Random JAX variables -> the port (strict) -> JAX: every leaf equal;
    fc6's kernel (y, x, c) rows and the depthwise kernels (3, 3, 1, C)
    against (C, 1, 3, 3) included; MobileNet's BN statistics under
    `params`."""
    cfg, tcfg = _cfgs(CASES[case])
    shapes = _jax_shapes(cfg)
    rng = np.random.RandomState(1)
    v = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    assert set(v) == {"params"}
    model = _port(tcfg, v)
    sd = model.state_dict()
    if case.startswith("vgg16"):
        assert sd["tail.fc6.weight"].shape == (4096, 3 * 3 * 512)
        np.testing.assert_array_equal(sd["tail.fc6.weight"].numpy(),
                                      v["params"]["tail"]["fc6"]["kernel"].T)
        assert sd["backbone.early_conv0.weight"].shape[1] == 3
    else:
        dw = v["params"]["backbone"]["layer2"]["depthwise"]["kernel"]
        assert dw.shape[2] == 1
        assert sd["backbone.layer2.depthwise.weight"].shape == (dw.shape[3], 1, 3, 3)
        assert sd["backbone.conv0.weight"].shape[1] == tcfg.lidar.num_channel
    back = to_flax_variables(sd)
    want, got = dict(_flat(v["params"])), dict(_flat(back["params"]))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg="/".join(path))
    assert len(from_flax_variables(v)) == len(sd) == len(want)


def _meta_port(tcfg):
    with torch.device("meta"):
        model = t_det.FasterRCNN(tcfg, K)
    return model.to_empty(device="cpu")


def _jax_loaded(cfg, load, sd):
    """JAX's loader on `sd` into a zero tree -> (port state dict, count)."""
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), _jax_shapes(cfg))
    new, n = load(zeros, sd)
    return from_flax_variables(new), n


def _check_loaded(model, want, n_port, n_jax, keys):
    assert n_port == n_jax == len(keys), (n_port, n_jax, len(keys))
    sd = model.state_dict()
    for k in keys:
        assert torch.equal(sd[k], want[k]), k


def test_torchvision_vgg16_loader_bitwise():
    """A torchvision-layout vgg16 state dict (13 convs with biases, the
    classifier's fc6 / fc7 and the dropped 1000-way fc) loads into the
    port as JAX's load_vgg16_state_dict loads it, bitwise: fc6's rows go
    from torch's CHW flattening to the tail's (y, x, c)."""
    cfg, tcfg = _cfgs(CASES["vgg16-image"] + ("POOLING_SIZE", "7"))
    g = torch.Generator().manual_seed(2)
    sd, cin = {}, 3
    for idx, cout in zip(t_convert._VGG_CONV_IDX, (64, 64, 128, 128) + (256,) * 3 + (512,) * 6):
        sd[f"features.{idx}.weight"] = torch.randn((cout, cin, 3, 3), generator=g)
        sd[f"features.{idx}.bias"] = torch.randn(cout, generator=g)
        cin = cout
    for name, shape in (("0", (4096, 25088)), ("3", (4096, 4096)), ("6", (1000, 4096))):
        sd[f"classifier.{name}.weight"] = torch.randn(shape, generator=g)
        sd[f"classifier.{name}.bias"] = torch.zeros(shape[0])
    want, n_jax = _jax_loaded(cfg, j_convert.load_vgg16_state_dict, sd)
    model = _meta_port(tcfg)
    n = t_convert.load_vgg16_state_dict(model, sd)
    keys = [k for k in model.state_dict() if k.startswith(("backbone.", "tail."))]
    _check_loaded(model, want, n, n_jax, keys)
    # a known fc6 input, (y 2, x 3, c 100) of the pooled RoI, reads torch's (100, 2, 3) column
    fc6 = model.state_dict()["tail.fc6.weight"]
    assert torch.equal(fc6[:, (2 * 7 + 3) * 512 + 100],
                       sd["classifier.0.weight"][:, (100 * 7 + 2) * 7 + 3])


def _reference_mobilenet(rng, mult=1.0):
    """A reference-layout MobileNet state dict ('mobilenet.Conv2d_<i>')."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.mobilenet import (
        HEAD_BLOCKS, STEM_CHANNELS, TAIL_BLOCKS, _depth)

    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def bn(prefix, c):
        var = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
        return {f"{prefix}.weight": f(c), f"{prefix}.bias": f(c), f"{prefix}.running_mean": f(c),
                f"{prefix}.running_var": var,
                f"{prefix}.num_batches_tracked": torch.zeros((), dtype=torch.int64)}

    cin = _depth(STEM_CHANNELS, mult)
    sd = {"mobilenet.Conv2d_0.0.weight": f(cin, 3, 3, 3), **bn("mobilenet.Conv2d_0.1", cin)}
    for i, (_s, ch) in enumerate(HEAD_BLOCKS + TAIL_BLOCKS, start=1):
        cout = _depth(ch, mult)
        p = f"mobilenet.Conv2d_{i}"
        sd.update({f"{p}.depthwise.0.weight": f(cin, 1, 3, 3), **bn(f"{p}.depthwise.1", cin),
                   f"{p}.pointwise.0.weight": f(cout, cin, 1, 1), **bn(f"{p}.pointwise.1", cout)})
        cin = cout
    return sd


def test_reference_mobilenet_loader_bitwise():
    """A reference-layout MobileNet state dict loads into the port as JAX's
    load_mobilenet_state_dict loads it, bitwise: layers 0-11 into the
    backbone, 12-13 into the tail, the depthwise kernels as they are."""
    cfg, tcfg = _cfgs(CASES["mobile-image"])
    sd = _reference_mobilenet(np.random.RandomState(3))
    want, n_jax = _jax_loaded(cfg, j_convert.load_mobilenet_state_dict, sd)
    model = _meta_port(tcfg)
    n = t_convert.load_mobilenet_state_dict(model, sd)
    keys = [k for k in model.state_dict() if k.startswith(("backbone.", "tail."))]
    _check_loaded(model, want, n, n_jax, keys)
    assert torch.equal(model.state_dict()["tail.layer13.depthwise.weight"],
                       sd["mobilenet.Conv2d_13.depthwise.0.weight"])


def _same_dicts(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def _tf_vars(rng):
    """Raw tf-slim variables of the three nets, with the global step and an
    optimizer slot the renames drop."""
    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)

    res = {"resnet_v1_101/conv1/weights": f(7, 7, 3, 64),
           "resnet_v1_101/conv1/BatchNorm/gamma": f(64),
           "resnet_v1_101/conv1/BatchNorm/moving_variance": f(64),
           "resnet_v1_101/block1/unit_1/bottleneck_v1/conv2/weights": f(3, 3, 64, 64),
           "resnet_v1_101/block1/unit_1/bottleneck_v1/conv3/BatchNorm/beta": f(256),
           "resnet_v1_101/block1/unit_1/bottleneck_v1/shortcut/weights": f(1, 1, 64, 256),
           "resnet_v1_101/block1/unit_1/bottleneck_v1/shortcut/BatchNorm/moving_mean": f(256),
           "resnet_v1_101/block3/unit_12/bottleneck_v1/conv1/weights": f(1, 1, 1024, 256),
           "resnet_v1_101/rpn_conv/3x3/weights": f(3, 3, 1024, 512),
           "resnet_v1_101/rpn_conv/3x3/biases": f(512),
           "resnet_v1_101/cls_score/weights": f(2048, 9),
           "resnet_v1_101/bbox_pred/biases": f(36),
           "Variable": np.asarray(7), "resnet_v1_101/conv1/weights/Momentum": f(7, 7, 3, 64)}
    vgg = {"vgg_16/conv1/conv1_1/weights": f(3, 3, 3, 64), "vgg_16/conv1/conv1_1/biases": f(64),
           "vgg_16/conv5/conv5_3/weights": f(3, 3, 512, 512),
           # bytes, not float32: the renames move elements, whatever their type
           "vgg_16/fc6/weights": np.frombuffer(rng.bytes(25088 * 4096), np.uint8).reshape(
               25088, 4096),
           "vgg_16/fc7/biases": f(4096), "vgg_16/rpn_conv/3x3/weights": f(3, 3, 512, 512),
           "vgg_16/cls_score/biases": f(9), "Variable": np.asarray(3)}
    mob = {"MobilenetV1/Conv2d_0/weights": f(3, 3, 3, 32),
           "MobilenetV1/Conv2d_0/BatchNorm/gamma": f(32),
           "MobilenetV1/Conv2d_3_depthwise/depthwise_weights": f(3, 3, 128, 1),
           "MobilenetV1/Conv2d_3_depthwise/BatchNorm/moving_mean": f(128),
           "MobilenetV1/Conv2d_3_pointwise/weights": f(1, 1, 128, 128),
           "MobilenetV1/Conv2d_3_pointwise/BatchNorm/beta": f(128),
           "MobilenetV1/rpn_conv/3x3/weights": f(3, 3, 512, 512),
           "MobilenetV1/bbox_pred/weights": f(1024, 8)}
    return {"resnet": res, "vgg": vgg, "mobilenet": mob}


@pytest.mark.parametrize("net", ["resnet", "vgg", "mobilenet"])
def test_tf_slim_renames_bitwise(net):
    """tf_slim_{resnet,vgg,mobilenet}_to_torch give JAX's keys in JAX's
    order and its arrays bit for bit (unit_N -> N - 1, fc6's HWC -> CHW
    rows, the depthwise HWC1 -> (C, 1, H, W))."""
    tf_vars = _tf_vars(np.random.RandomState(4))[net]
    fn = f"tf_slim_{net}_to_torch"
    got = getattr(t_convert, fn)({k: v.copy() for k, v in tf_vars.items()})
    want = getattr(j_convert, fn)({k: v.copy() for k, v in tf_vars.items()})
    _same_dicts(got, want)
    assert not any("Momentum" in k or k == "Variable" for k in got)


def test_replicate_conv1_for_lidar_bitwise():
    """The RGB stem spread over 12 height slices and the 3 meta channels as
    JAX's replicate_conv1_for_lidar spreads it, bitwise; under another key
    (the port's stem names) the same values."""
    rng = np.random.RandomState(5)
    w = torch.from_numpy(rng.normal(size=(64, 3, 7, 7)).astype(np.float32))
    sd = {"conv1.weight": w, "bn1.weight": torch.ones(64)}
    got = t_convert.replicate_conv1_for_lidar(sd, 12, 15)
    _same_dicts(got, j_convert.replicate_conv1_for_lidar(sd, 12, 15))
    assert got["conv1.weight"].shape == (64, 15, 7, 7)
    other = t_convert.replicate_conv1_for_lidar({"backbone.conv0.weight": w}, 12, 15,
                                                key="backbone.conv0.weight")
    np.testing.assert_array_equal(other["backbone.conv0.weight"], got["conv1.weight"])


def _convert_tool():
    """tools/convert_from_tensorflow_torch.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "convert_from_tensorflow_torch",
        chip_smoke.REPO / "tools" / "convert_from_tensorflow_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_convert_tool_mobilenet_lidar(tmp_path):
    """tools/convert_from_tensorflow_torch.py on an .npz of tf-slim
    MobileNet variables for a BEV net: the port's state dict it writes holds
    the renamed tensors, the stem spread over the 15 channels
    (replicate_conv1_for_lidar), and --to_npz the renamed dict."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.mobilenet import HEAD_BLOCKS, TAIL_BLOCKS

    rng = np.random.RandomState(6)
    tf_vars, cin = {"MobilenetV1/Conv2d_0/weights": rng.normal(size=(3, 3, 3, 32))}, 32
    for i, (_s, cout) in enumerate(HEAD_BLOCKS + TAIL_BLOCKS, start=1):
        tf_vars[f"MobilenetV1/Conv2d_{i}_depthwise/depthwise_weights"] = rng.normal(
            size=(3, 3, cin, 1))
        tf_vars[f"MobilenetV1/Conv2d_{i}_pointwise/weights"] = rng.normal(size=(1, 1, cin, cout))
        tf_vars[f"MobilenetV1/Conv2d_{i}_pointwise/BatchNorm/gamma"] = rng.normal(size=cout)
        cin = cout
    tf_vars = {k: v.astype(np.float32) for k, v in tf_vars.items()}
    np.savez(tmp_path / "tf.npz", **tf_vars)
    tool = _convert_tool()
    tool.main([str(tmp_path / "tf.npz"), "--net", "mobile", "--net_type", "lidar",
               "--out", str(tmp_path / "w.pt"), "--to_npz", str(tmp_path / "sd.npz")])
    renamed = dict(np.load(tmp_path / "sd.npz"))
    _same_dicts(renamed, j_convert.tf_slim_mobilenet_to_torch(dict(tf_vars)))
    tool.main([str(tmp_path / "tf.npz"), "--net", "mobile", "--net_type", "lidar",
               "--out", str(tmp_path / "w.pt")])
    sd = torch.load(tmp_path / "w.pt", weights_only=True)
    w = renamed["mobilenet.Conv2d_0.0.weight"]
    assert sd["backbone.conv0.weight"].shape == (32, 15, 3, 3)
    np.testing.assert_array_equal(sd["backbone.conv0.weight"][:, :12].numpy(),
                                  np.repeat(w[:, :1], 12, 1))
    np.testing.assert_array_equal(sd["backbone.conv0.weight"][:, 12:14].numpy(), w[:, 1:3])
    np.testing.assert_array_equal(sd["tail.layer13.pointwise.weight"].numpy(),
                                  renamed["mobilenet.Conv2d_13.pointwise.0.weight"])
    np.testing.assert_array_equal(sd["backbone.layer5.pw_bn.weight"].numpy(),
                                  renamed["mobilenet.Conv2d_5.pointwise.1.weight"])


def _tf_slim_resnet50(rng) -> dict:
    """Every variable of a tf-slim resnet_v1_50 (stem, 16 bottlenecks with
    their shortcuts and BNs), float32, and one RPN head conv."""
    out = {}

    def conv(scope, shape):
        out[f"resnet_v1_50/{scope}/weights"] = rng.standard_normal(shape, np.float32)
        for leaf in ("gamma", "beta", "moving_mean", "moving_variance"):
            out[f"resnet_v1_50/{scope}/BatchNorm/{leaf}"] = rng.standard_normal(
                shape[-1], np.float32)

    conv("conv1", (7, 7, 3, 64))
    cin = 64
    for stage, (units, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512)), start=1):
        for u in range(1, units + 1):
            scope = f"block{stage}/unit_{u}/bottleneck_v1"
            if u == 1:
                conv(f"{scope}/shortcut", (1, 1, cin, 4 * width))
            conv(f"{scope}/conv1", (1, 1, cin, width))
            conv(f"{scope}/conv2", (3, 3, width, width))
            conv(f"{scope}/conv3", (1, 1, width, 4 * width))
            cin = 4 * width
    out["resnet_v1_50/rpn_conv/3x3/weights"] = rng.standard_normal((3, 3, 1024, 512), np.float32)
    return out


def test_convert_tool_resnet50(tmp_path):
    """The tool on an .npz of tf-slim resnet_v1_50 variables: every backbone
    and C4 tail tensor of the port's res50 (stem, layer1-3, layer4 in the
    tail) holds the renamed one bit for bit, loaded strictly
    (load_torchvision_resnet); the RPN head conv is left out."""
    tf_vars = _tf_slim_resnet50(np.random.default_rng(7))
    np.savez(tmp_path / "tf.npz", **tf_vars)
    _convert_tool().main([str(tmp_path / "tf.npz"), "--net", "res50",
                          "--out", str(tmp_path / "w.pt")])
    renamed = {k[len("resnet."):]: v
               for k, v in j_convert.tf_slim_resnet_to_torch(dict(tf_vars)).items()
               if k.startswith("resnet.")}
    sd = torch.load(tmp_path / "w.pt", weights_only=True)
    port = {k.split(".", 1)[1]: v for k, v in sd.items() if k.startswith(("backbone.", "tail."))}
    assert set(port) == set(renamed)
    assert any(k.startswith("layer4.") for k in renamed)
    for k, v in renamed.items():
        np.testing.assert_array_equal(port[k].numpy(), v, err_msg=k)
    assert sd["tail.layer4.0.downsample.0.weight"].shape == (2048, 1024, 1, 1)


@pytest.mark.parametrize("net", ["vgg16", "mobile"])
def test_preload_image_weights_into_a_bev_stem(net, tmp_path, monkeypatch):
    """Solver.load_pretrained (mode 1) of an image net's weights into the
    BEV net: the 3-channel stem is spread over the 15 (replicate_conv1_for
    _lidar under the port's stem key), every other backbone and tail key
    copied; before, the stem's shape raised."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset

    # the MetricsWriters' JSONL logs only (torch.utils.tensorboard pulls in TensorFlow)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    extra = VGG if net == "vgg16" else MOBILE + HALF
    _, image_cfg = _cfgs(IMAGE + extra)
    _, bev_cfg = _cfgs(BEV + extra)
    src = _random_state(image_cfg, 1)
    torch.save(src, tmp_path / "image.pt")
    model = _port(bev_cfg, _random_state(bev_cfg, 2))
    ds = SyntheticDataset(bev_cfg, num_frames=2, num_classes=K, seed=0)
    solver = t_solver.Solver(bev_cfg, model, BatchLoader(ds, bev_cfg, 1, device="cpu"), None,
                             output_dir=str(tmp_path / "out"))
    keys = solver.load_pretrained(str(tmp_path / "image.pt"), 1)
    stem = t_det.stem_key(model)
    assert stem == ("backbone.early_conv0.weight" if net == "vgg16" else "backbone.conv0.weight")
    sd = model.state_dict()
    want = t_convert.replicate_conv1_for_lidar(src, 12, 15, key=stem)[stem]
    np.testing.assert_array_equal(sd[stem].numpy(), want)
    assert set(keys) == {k for k in sd if k.startswith(("backbone.", "tail."))}
    assert all(torch.equal(sd[k], src[k]) for k in keys if k != stem)


@pytest.mark.parametrize("net", ["vgg16", "mobile"])
@pytest.mark.parametrize("fixed", [1, 3, -1])
def test_optimizer_masks_equal_jax(net, fixed):
    """The frozen, decay and bias masks over the port's keys equal JAX's
    frozen_mask, decay_mask and bias_mask leaf by leaf: VGG16 freezes
    nothing but nothing is named `stem` or layerN in it; MobileNet's
    bn0 / dw_bn / pw_bn are frozen unless FIXED_BLOCKS is -1 and its
    layer1..FIXED_BLOCKS are; at -1 the BN affines train (AffineBatchNorm
    parameters) and the statistics do not."""
    cfg, tcfg = _cfgs(IMAGE + (VGG if net == "vgg16" else MOBILE)
                      + ("RESNET.FIXED_BLOCKS", str(fixed)))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), _jax_shapes(cfg))["params"]
    want = {name: {flax_path_to_torch_key(p): bool(v) for p, v in _flat(mask)}
            for name, mask in (("frozen", j_optim.frozen_mask(params, cfg)),
                               ("decay", j_optim.decay_mask(params, cfg)),
                               ("bias", j_optim.bias_mask(params)))}
    model = _meta_port(tcfg)
    keys = list(model.state_dict())
    assert t_optim.frozen_mask(keys, tcfg) == want["frozen"]
    assert t_optim.decay_mask(keys, tcfg) == want["decay"]
    assert t_optim.bias_mask(keys) == want["bias"]
    t_optim.DetectorSGD(model, tcfg)
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trained == {k for k, f in want["frozen"].items() if not f}
    if net == "mobile":
        assert ("backbone.layer2.dw_bn.weight" in trained) == (fixed == -1)
        assert ("backbone.layer3.pointwise.weight" in trained) == (fixed < 3)
        assert "backbone.layer1.dw_bn.running_var" not in trained
    else:
        assert "backbone.early_conv0.weight" in trained


# -- serving and one training step, image and BEV -----------------------------------------


def _stages(m, images, window):
    """JAX forward_train's train-phase proposal lanes."""
    feats = m.features(images)
    rpn = m.rpn_scores(feats["rpn"])
    rpn["anchors"] = m._anchors(feats["rpn"])
    rois, _s, a3d, valid, src = m._propose_batch(rpn, window, "train")
    return rois, a3d, valid, src


def _gt(lanes, lidar, rng):
    """GT boxes jittered from some of JAX's proposals (test_torch_port_uc_train)."""
    rois, a3d, pvalid, _src = lanes
    gt = np.zeros((B, G, 8 if lidar else 5), np.float32)
    mask = np.zeros((B, G), bool)
    for i, n in enumerate([3, 5]):
        pick = np.flatnonzero(pvalid[i])[::7][:n]
        n = len(pick)
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
    return gt, mask


def _site(inter, path, residual):
    """JAX's input to a chip_smoke.relu_sites ReLU: a VGG16 conv or fc, a
    MobileNet BN (by their names, alike in both packages), else the ResNet
    sites of test_torch_port_fpn."""
    parts = path.split(".")
    if parts[-1].startswith(("early_conv", "late_conv", "fc6", "fc7")) or parts[-1] in PLAIN_BN:
        node = inter
        for p in parts:
            node = node[p]
        return np.asarray(node["__call__"][0])
    return _resnet_site(inter, path, residual)


def _relu_ties(make_port, forward, inter, rounds=4):
    """test_torch_port_fpn._relu_ties over these nets' ReLU sites: every
    ReLU input within 1e-4 of its max of JAX's, the units of another sign
    pinned to JAX's gate until none is new."""
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
            assert np.abs(tx.numpy() - jx).max() <= 1e-4 * np.abs(jx).max() + 1e-12, path
            want[(path, residual)] = torch.from_numpy(np.ascontiguousarray(jx))
        new = chip_smoke.find_ties(want, got, skip={t[:3] for t in ties})
        if not new:
            break
        ties += new
    return ties


def serve_and_step(name, overrides, variables_fn=_variables):
    """Serving and one training step of a configuration on the same weights
    (variables_fn(tcfg)) and frames, each side once: the port's
    forward_test and JAX's jitted forward_test; JAX's jitted forward_train
    value and gradient (with its intermediates, for the ReLU ties) and its
    proposal lanes."""
    cfg, tcfg = _cfgs(overrides)
    lidar = tcfg.net_type == "lidar"
    rng = np.random.RandomState(1)
    x, window = _frames(tcfg, rng)
    variables = variables_fn(tcfg)
    state = from_flax_variables(variables)
    jm = j_det.FasterRCNN(cfg=cfg, num_classes=K)
    with torch.no_grad():
        served = _port(tcfg, state).eval().forward_test(_t(x), _t(window))
    # one compile for both: the serving outputs and the train-phase lanes
    want, lanes = jax.jit(partial(jm.apply, method=lambda m, images, win: (
        m.forward_test(images, win), _stages(m, images, win))))(
        variables, jnp.asarray(x), jnp.asarray(window))
    lanes = tuple(np.asarray(a) for a in lanes)
    gt, mask = _gt(lanes, lidar, rng)
    batch = {"data": x, "gt_boxes": gt, "gt_mask": mask, "window": window}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step_rng = jax.random.fold_in(jax.random.PRNGKey(3), jnp.int32(0))

    def losses_fn(params):
        losses, mut = jm.apply({"params": params}, jb["data"], jb["gt_boxes"], jb["gt_mask"],
                               jb["window"], step_rng, method=j_det.FasterRCNN.forward_train,
                               capture_intermediates=True, mutable=["intermediates"])
        return losses["total_loss"], (losses, mut["intermediates"])

    (_, (losses, inter)), grads = jax.jit(jax.value_and_grad(losses_fn, has_aux=True))(
        variables["params"])
    n, r = _meta_port(tcfg).train_lane_counts(x.shape[1:3], G)
    out = types.SimpleNamespace(
        name=name, cfg=cfg, tcfg=tcfg, lidar=lidar, variables=variables, state=state, batch=batch,
        served=served, want={k: np.asarray(v) for k, v in want.items()
                             if k in ("rois", "roi_scores", "roi_valid", "anchors_3d",
                                      "cls_prob", "bbox_pred")},
        src=_t(lanes[3]).long(), valid=_t(lanes[2]), draws=jax_draws(step_rng, B, n, r, G),
        n_anchors=n, losses={k: float(v) for k, v in losses.items()},
        grads={flax_path_to_torch_key(p): np.asarray(v) for p, v in _flat(grads)})
    out.ties = _relu_ties(lambda: _port(tcfg, state).train(),
                          lambda m: _forward(m, out, ties=()), inter)
    return out


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    return serve_and_step(request.param, CASES[request.param])


def _forward(model, run, ties=None):
    tb = {k: _t(v) for k, v in run.batch.items()}
    with chip_smoke.pinned_ties(model, run.ties if ties is None else ties):
        return model.forward_train(tb["data"], tb["gt_boxes"], tb["gt_mask"], tb["window"],
                                   run.draws, proposals=(run.src, run.valid))


def check_serving(run, tol=1e-5):
    got, want = run.served, run.want
    np.testing.assert_array_equal(got["roi_valid"].numpy(), want["roi_valid"])
    assert want["roi_valid"].sum() >= B * 8
    if run.lidar:
        np.testing.assert_array_equal(got["anchors_3d"].numpy(), want["anchors_3d"])
    errs = {k: _rel(got[k].numpy(), want[k])
            for k in ("rois", "roi_scores", "cls_prob", "bbox_pred")}
    print(f"{run.name} serving: error / max|x| {errs}")
    for k, err in errs.items():
        assert err <= tol, k


def test_serving_matches_jax(run):
    """Proposals, their validity and scores, each proposal's 3D anchor
    (lidar), the class probabilities and the decoded boxes (clipped image
    boxes, or 7-DoF BEV boxes) within 1e-5 of max|x| of JAX's."""
    check_serving(run)


def test_feature_map_and_anchor_lanes(run):
    """The RPN map's size, and so the anchor lanes TrainDraws carries, is
    JAX's: VGG16 floors 200 x 175 to 12 x 10, MobileNet (stride-2 convs,
    padding 1) rounds up to 13 x 11, as ResNet's C4 does."""
    hw = run.batch["data"].shape[1:3]
    model = _port(run.tcfg, run.state)
    fh, fw = model.feature_hw(hw)
    assert run.n_anchors == fh * fw * run.tcfg.num_anchors
    with torch.no_grad():
        feat = model.features(_t(run.batch["data"]))
    assert tuple(feat.shape[1:3]) == (fh, fw)
    if run.name.startswith("vgg16"):
        assert (fh, fw) == (hw[0] // 16, hw[1] // 16)
    else:
        assert (fh, fw) == (-(-hw[0] // 16), -(-hw[1] // 16))


def check_train_step(run, expect=()):
    """The four losses within rtol 1e-4 of JAX's; every trainable leaf's
    gradient (the keys `expect` among them) within 1e-3 of its max|g|;
    the ReLU ties few, at 0 within rounding, and pinned to JAX's gate."""
    print(f"{run.name} ReLU ties: {[t[:3] for t in run.ties]}")
    assert len(run.ties) <= 8
    for *_, jx, tx, scale in run.ties:
        assert max(abs(jx), abs(tx)) <= 1e-5 * scale
    model = _port(run.tcfg, run.state).train()
    t_optim.DetectorSGD(model, run.tcfg)
    losses, aux = _forward(model, run)
    for k in LOSSES + ("total_loss",):
        np.testing.assert_allclose(float(losses[k].detach()), run.losses[k], rtol=1e-4, err_msg=k)
        assert np.isfinite(run.losses[k]), k
    assert (aux.proposal_targets.labels > 0).sum() >= 4
    losses["total_loss"].backward()
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert set(expect) <= set(trained)
    worst = (0.0, None)
    for name, p in trained.items():
        want = _torch_layout(run.grads[name])
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max() + 1e-12, err_msg=name)
        worst = max(worst, (float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12)), name))
    print(f"{run.name}: largest gradient error / max|g| {worst}")


def test_train_step_losses_and_gradients(run):
    """The four losses within rtol 1e-4 of JAX's jitted forward_train; every
    trainable leaf's gradient within 1e-3 of its max|g|, with the ReLU ties
    few, at 0 within rounding, and pinned to JAX's gate."""
    check_train_step(run, {"tail.fc6.weight", "backbone.late_conv12.weight"}
                     if run.name.startswith("vgg16") else
                     {"tail.layer13.pointwise.weight", "backbone.layer11.depthwise.weight"})
