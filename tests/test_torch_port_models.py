"""Port modules vs their flax counterparts at narrow widths.

Each flax module is initialized, its parameters are randomized from a numpy
seed, and the weights are carried into the port through the weight bridge
(`from_flax_variables`).  Tolerance: 1e-5 * max|y| -- the same float32 math
with a different convolution algorithm and summation order."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.models import heads as j_heads  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu.models import resnet as j_resnet  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch import config as t_config  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import detector as t_det  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import heads as t_heads  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.models import resnet as t_resnet  # noqa: E402
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.convert import (  # noqa: E402
    from_flax_variables,
    load_torchvision_resnet,
)


def _randomize(tree, rng):
    """Random values for every leaf: conv/dense kernels and biases small
    normals, BN scale near 1, mean normal, var in [0.5, 1.5]."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize(dict(v), rng)
            continue
        shape = np.shape(v)
        if k == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            val = rng.normal(0, 1.0 / np.sqrt(fan_in), shape)
        elif k == "scale":
            val = rng.normal(1.0, 0.2, shape)
        elif k == "var":
            val = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            val = rng.normal(0, 0.2, shape)
        out[k] = val.astype(np.float32)
    return out


def _port_weights(flax_params, scope):
    """Carry a module's flax params into the port: nest them at `scope` of
    the detector tree, convert with the bridge, strip the torch prefix."""
    tree = flax_params
    for name in reversed(scope):
        tree = {name: tree}
    sd = from_flax_variables({"params": tree})
    prefix = {
        ("backbone", "stem"): "backbone.",
        ("backbone", "stem", "bn1"): "backbone.bn1.",
        ("backbone", "layer1"): "backbone.layer1.",
        ("backbone", "layer1", "block0"): "backbone.layer1.0.",
        ("rpn",): "rpn.",
        ("predictors",): "predictors.",
    }[tuple(scope)]
    assert all(k.startswith(prefix) for k in sd)
    return {k[len(prefix):]: v for k, v in sd.items()}


def _compare(flax_mod, torch_mod, x_nhwc, scope, seed):
    rng = np.random.RandomState(seed)
    params = _randomize(flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x_nhwc))["params"], rng)
    want = np.asarray(flax_mod.apply({"params": params}, jnp.asarray(x_nhwc)))
    torch_mod.load_state_dict(_port_weights(params, scope), strict=True)
    torch_mod.eval()
    with torch.no_grad():
        got = torch_mod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), np.abs(got - want).max()
    return got


def _x(seed, shape):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def test_frozen_batchnorm():
    x = _x(0, (2, 5, 6, 12))
    _compare(j_resnet.FrozenBatchNorm(12), t_resnet.FrozenBatchNorm(12), x,
             ("backbone", "stem", "bn1"), seed=1)


@pytest.mark.parametrize(
    "cin,planes,stride,caffe,ds",
    [
        (32, 8, 1, False, False),   # identity shortcut
        (16, 8, 1, False, True),    # channel-changing downsample
        (16, 8, 2, False, True),    # stride on conv2 (torchvision placement)
        (32, 16, 2, True, True),    # caffe stride on conv1 (layers 2-3)
    ],
)
def test_bottleneck(cin, planes, stride, caffe, ds):
    x = _x(2, (2, 9, 11, cin))
    flax_mod = j_resnet.Bottleneck(planes, stride, caffe_stride=caffe,
                                   has_downsample=ds, downsample_stride=stride)
    torch_mod = t_resnet.Bottleneck(cin, planes, stride, caffe, ds)
    _compare(flax_mod, torch_mod, x, ("backbone", "layer1", "block0"), seed=3)


@pytest.mark.parametrize("planes,stride,caffe", [(8, 1, False), (16, 2, True)])
def test_res_stage(planes, stride, caffe):
    x = _x(4, (1, 12, 10, 24))
    flax_mod = j_resnet.ResStage(planes, 2, stride, caffe_stride=caffe)
    torch_mod = t_resnet.ResStage(24, planes, 2, stride, caffe)
    _compare(flax_mod, torch_mod, x, ("backbone", "layer1"), seed=5)


def test_resnet_stem():
    # odd sizes exercise the 7x7/2 pad-3 conv and the -inf-padded maxpool edges
    x = _x(6, (2, 33, 47, 3))
    got = _compare(j_resnet.ResNetStem(), t_resnet.ResNetStem(3), x, ("backbone", "stem"), seed=7)
    assert got.shape == (2, 9, 12, 64)


def test_rpn_head():
    x = _x(8, (2, 6, 7, 32))
    flax_mod = j_heads.RPNHead(rpn_channels=16, num_anchors=5)
    rng = np.random.RandomState(9)
    params = _randomize(flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want_cls, want_bbox = flax_mod.apply({"params": params}, jnp.asarray(x))
    torch_mod = t_heads.RPNHead(32, 16, 5)
    torch_mod.load_state_dict(_port_weights(params, ("rpn",)), strict=True)
    with torch.no_grad():
        cls, bbox = torch_mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, want in ((cls, want_cls), (bbox, want_bbox)):
        got, want = got.permute(0, 2, 3, 1).numpy(), np.asarray(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_detection_predictors():
    x = _x(10, (20, 64))
    flax_mod = j_heads.DetectionPredictors(num_classes=3, num_bbox_elem=4, det_channels=64)
    rng = np.random.RandomState(11)
    params = _randomize(flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    want = flax_mod.apply({"params": params}, jnp.asarray(x))
    torch_mod = t_heads.DetectionPredictors(64, 3, 4)
    torch_mod.load_state_dict(_port_weights(params, ("predictors",)), strict=True)
    with torch.no_grad():
        got = torch_mod(torch.from_numpy(x))
    assert set(got) == set(want) == {"cls_score", "bbox_pred"}
    for k in got:
        w = np.asarray(want[k])
        assert np.abs(got[k].numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_frozen_batchnorm_bf16_affine_in_float32():
    """bf16 activations: the affine is computed in float32 from the stored
    values, then applied in bf16 (JAX resnet.py:110-117)."""
    rng = np.random.RandomState(12)
    params = _randomize({"scale": np.ones(8), "bias": np.zeros(8), "mean": np.zeros(8),
                         "var": np.ones(8)}, rng)
    x = _x(13, (1, 3, 4, 8))
    want = np.asarray(
        j_resnet.FrozenBatchNorm(8).apply(
            {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)},
            jnp.asarray(x, jnp.bfloat16),
        ).astype(jnp.float32)
    )
    mod = t_resnet.FrozenBatchNorm(8)
    mod.load_state_dict(_port_weights(params, ("backbone", "stem", "bn1")))
    mod = mod.to(torch.bfloat16)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).float().numpy()
    # both round the same float32 affine to bf16; one bf16 ulp of slack for
    # the fused vs unfused multiply-add
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


def test_torchvision_resnet_state_dict_loads_directly():
    """Backbone and tail keys are torchvision's: a torchvision ResNet state
    dict (with its fc head and BN step counters) loads key for key."""
    cfg = t_config.cfg_from_list(t_config.default_config(), (
        "NET_TYPE", "image", "NET_VARIANT", "res50", "COMPUTE_DTYPE", "float32"))
    src = t_det.build_detector(cfg, 2, "cpu", seed=1)
    tv = {k.split(".", 1)[1]: v for k, v in src.state_dict().items()
          if k.startswith(("backbone.", "tail."))}
    for k in [k for k in tv if k.endswith("running_var")]:
        tv[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    tv["fc.weight"], tv["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    dst = t_det.build_detector(cfg, 2, "cpu", seed=2)
    n = load_torchvision_resnet(dst, tv)
    assert n == sum(1 for k in tv if not k.startswith("fc.") and "num_batches" not in k)
    for k, v in src.state_dict().items():
        if k.startswith(("backbone.", "tail.")):
            assert torch.equal(dst.state_dict()[k], v), k
