"""ResNet backbone and C4 tail with the reference's detection surgery, and
the FPN's pyramid backbone.

Port of faster_rcnn_pytorch_multimodal_tpu/models/resnet.py:46-474:
  * FrozenBatchNorm, and LiveBatchNorm for RESNET.FIXED_BLOCKS -1 (training
    from scratch): batch statistics in train mode, running statistics
    updated at momentum 0.1 and used in eval mode;
  * BasicBlock (res18/34) and Bottleneck (res50/101/152), the latter with
    caffe-style stride placement: layers 2 and 3 put the stride on the 1x1
    conv1 instead of the 3x3 conv2, and the downsample conv carries it;
  * stride-1 layer4 as the C4 detection tail;
  * ResNetPyramid for FPN: stem and layer1..4 -> (c2, c3, c4, c5), with a
    stride-2 layer4 that places its stride as torchvision does (on the 3x3
    conv2 and the downsample), unlike layers 2 and 3.

`drop_rate` > 0 (the JAX package's `dropout_en`, under epistemic
uncertainty) makes each Bottleneck's drop1, drop2d (whole (sample, channel)
planes) and drop3 CheapDropout layers at that rate; BasicBlock has none.
A CheapDropout layer is the identity until `live_dropout` hands it a
UCDraws, where it takes its masks.

`live_bn` puts LiveBatchNorm in every BN place (stem, blocks, downsample);
`zero_init_residual` marks each block's residual terminator (bn3 of a
Bottleneck, bn2 of a BasicBlock) for a zero scale at init
(models.detector.init_params).  The JAX package switches both on together,
at FIXED_BLOCKS -1.

Modules are NCHW, as PyTorch's convolutions are; the detector runs them on
channels_last tensors, so the NHWC views it hands to RoI align are free.
Module names follow torchvision's ResNet (conv1, bn1, layer1.0.conv1,
layer1.0.downsample.0/1, ...), so a torchvision state dict maps key for key.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh, spatial
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.tensor_parallel import (
    column_input,
    own_channels,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import span

# layers-per-stage per depth (ref resnet.py:242-295)
STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BASIC_DEPTHS = (18, 34)
EXPANSION = 4  # Bottleneck's; a BasicBlock's is 1


def _expansion(num_layers: int) -> int:
    """A stage's output channels over its planes at this depth."""
    return 1 if num_layers in BASIC_DEPTHS else EXPANSION


def _stage_blocks(num_layers: int) -> tuple:
    if num_layers not in STAGE_BLOCKS:
        raise NotImplementedError(f"res{num_layers}: the port has depths {sorted(STAGE_BLOCKS)}")
    return STAGE_BLOCKS[num_layers]


def _bn_affine(x, mean, var, weight, bias, eps: float) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * weight + bias as the JAX package
    computes it (resnet.py:110-117): the per-channel affine in float32,
    applied in the activation dtype (with bfloat16 compute only the
    C-element affine runs in float32)."""
    inv = torch.rsqrt(var.float() + eps)
    a = inv * weight.float()
    b = bias.float() - mean.float() * a
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)


class FrozenBatchNorm(nn.Module):
    """BN as a fixed affine map: y = (x - mean) * rsqrt(var + eps) * weight + bias."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # torchvision BatchNorm2d checkpoints carry a step counter we ignore
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _bn_affine(x, self.running_mean, self.running_var, self.weight, self.bias, self.eps)


class AffineBatchNorm(FrozenBatchNorm):
    """FrozenBatchNorm's fixed statistics with a trainable scale and bias:
    the JAX package's FrozenBatchNorm where its optimizer's frozen mask
    lets the affine train (the epistemic stacks' BN; MobileNet's BN at
    FIXED_BLOCKS -1).  Where the mask freezes it, training.optim sets
    requires_grad False."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__(features, eps)
        del self.weight, self.bias
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


class LiveBatchNorm(FrozenBatchNorm):
    """Train-mode BN with the JAX package's arithmetic (FrozenBatchNorm with
    live=True, resnet.py:57-117) and FrozenBatchNorm's keys; weight and bias
    are trainable parameters.

    In train mode the statistics are the float32 mean and biased variance of
    the input over every axis but the channel (N*H*W, or in the C4 tail the
    B*R*7*7 pooled rows); gradients flow through them, and the float32
    running statistics move in place at `momentum` towards the mean and the
    unbiased variance var * n / max(n - 1, 1).  In eval mode the running
    statistics normalize, as in FrozenBatchNorm.  Not nn.BatchNorm2d: with
    bfloat16 activations it normalizes in float32 and rounds once, where the
    JAX package rounds the per-channel affine to bfloat16 first.

    The running statistics stay float32 when the module is cast (`_apply`),
    as the JAX package's `batch_stats` collection does.  The update is in
    place on the tensors the module holds, so under
    torch.func.functional_call it lands on the model only when the call is
    given the model's own buffers (training.solver.cast_for_compute).
    With `update_stats` False (training.solver.make_eval_step) train mode
    still takes the batch's statistics but leaves the running ones as they
    are, as the JAX package's step does when `batch_stats` is not mutable.

    Inside parallel.data_parallel (a data-parallel step) the statistics are
    the global batch's, as under JAX's SPMD step (resnet.py:14-23, "jnp.mean
    reduces over the GLOBAL batch"): the mean from the all-reduced sum, then
    the variance from the all-reduced sum of squared deviations from it
    (the same two passes), both differentiable, over n = the rank's rows
    times the data ranks (the shards are of one shape); the running
    update's n / (n - 1) takes that n.  The sums run over the data group:
    a model group's ranks hold the same rows (or, in the tail, other
    channels of them).  In a backbone pass split by rows (parallel.spatial)
    they run over every rank, each slab counted once: n is the rank's
    frames times the data ranks times the map's whole height and width."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(features, eps)
        self.momentum = momentum
        self.update_stats = True
        del self.weight, self.bias
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def _apply(self, fn, recurse=True):
        # .to(dtype), .bfloat16() and the like: the float32 statistics
        # follow the module's device only
        stats = {k: self._buffers[k] for k in ("running_mean", "running_var")}
        super()._apply(fn, recurse)
        for k, v in stats.items():
            if self._buffers[k].dtype != v.dtype:
                self._buffers[k] = v.to(self._buffers[k].device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        n = xf.numel() // xf.shape[1]
        world = mesh.world_size()
        split = spatial.active()
        if world == 1 and split is None:
            mean = xf.mean(dims)
            # jnp.var: the mean of the squared deviations
            var = (xf - mean.reshape(shape)).square().mean(dims)
        else:
            axis = "data" if split is None else "all"
            n *= world
            if split is not None:  # the rank's slab of the map's rows
                n = n // x.shape[2] * split.height(x)
            mean = mesh.global_sum(xf.sum(dims), axis) / n
            var = mesh.global_sum((xf - mean.reshape(shape)).square().sum(dims), axis) / n
        if not self.update_stats:
            return _bn_affine(x, mean, var, self.weight, self.bias, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * (var * (n / max(n - 1, 1))))
        return _bn_affine(x, mean, var, self.weight, self.bias, self.eps)


class UCDraws:
    """The random numbers of one forward's uncertainty: the keep masks of
    the live dropout layers (CheapDropout) and the standard normals of the
    logit draws.

    Each comes from `masks` ({layer path: (T, ...) bool, one mask a sample,
    in the layer's layout}) or `normals` ({key: tensor}) when the caller
    gives it, else from `generator`.  With record=True what is drawn is kept
    in `masks` and `normals`, so that another forward (on another device)
    can take the same numbers.  `samples` is the range of Monte-Carlo
    samples a forward holds stacked along its batch axis, sample-major (the
    detector sets it; one sample, 0, otherwise).

    `shard` = (rank, world) makes the draws a data-parallel rank's: each
    draw is the global batch's (world times the rank's frames, from the
    same generator on every rank) and the rank takes its row block, so the
    ranks together draw what one process draws for the global batch.  The
    frame axis is a mask's leading axis within a sample (frames, or a
    frame's RoIs frame-major) and a normal's axis 1.  On a model axis a
    layer's mask is the whole layer's, cut to the rank's channels (the
    tail's shards: `keep`'s channels) or rows (a backbone slab: its
    rows)."""

    def __init__(
        self,
        generator: Optional[torch.Generator] = None,
        masks: Optional[Dict[str, torch.Tensor]] = None,
        normals: Optional[Dict[str, torch.Tensor]] = None,
        record: bool = False,
        shard: Tuple[int, int] = (0, 1),
    ):
        self.generator = generator
        self.masks = dict(masks or {})
        self.normals = dict(normals or {})
        self.record = record
        self.samples = range(1)
        self.shard = shard

    def normal(self, key: str, shape: tuple, device: torch.device) -> torch.Tensor:
        """The standard normals named `key`, given or drawn."""
        if key in self.normals:
            return self.normals[key]
        rank, world = self.shard
        if world == 1:
            x = torch.randn(shape, generator=self.generator, device=device)
        else:
            n = shape[1]
            x = torch.randn((shape[0], n * world) + tuple(shape[2:]), generator=self.generator,
                            device=device)[:, rank * n:(rank + 1) * n].contiguous()
        if self.record:
            self.normals[key] = x
        return x

    def keep(
        self, path: str, shape: tuple, keep_q: int, device: torch.device,
        memory_format: torch.memory_format = torch.contiguous_format,
        channels: Optional[Tuple[int, int]] = None, rows: Optional[Tuple[int, int, int]] = None,
    ) -> torch.Tensor:
        """The keep mask of the layer at `path` for the stacked samples:
        given, or uint8 draws below keep_q (P(keep) = keep_q / 256) laid out
        in `memory_format` (the activation's, so that applying the mask is
        one elementwise pass).  channels (j, m): `shape` holds shard j of m
        of the layer's channels; rows (lo, hi, h): rows lo..hi of a map of
        h rows; the whole layer's mask is drawn and cut to them."""
        t0, t1 = self.samples.start, self.samples.stop
        given = self.masks.get(path)
        if given is not None and given.shape[0] >= t1:
            return given[t0:t1].reshape(shape)
        if self.generator is None:
            raise KeyError(f"UCDraws: no mask for {path} samples {t0}..{t1 - 1} and no generator")
        rank, world = self.shard
        frames = shape[0] // (t1 - t0)  # frames (or RoIs) a sample
        full = [(t1 - t0) * frames * world] + list(shape[1:])
        if channels is not None:
            full[1] *= channels[1]
        if rows is not None:
            full[2] = rows[2]
        bits = torch.empty(full, dtype=torch.uint8, device=device, memory_format=memory_format)
        keep = bits.random_(0, 256, generator=self.generator) < keep_q
        if world > 1:
            keep = keep.reshape([t1 - t0, frames * world] + full[1:])[
                :, rank * frames:(rank + 1) * frames].reshape([shape[0]] + full[1:])
        if channels is not None:
            keep = keep.narrow(1, channels[0] * shape[1], shape[1])
        if rows is not None:
            keep = keep.narrow(2, rows[0], rows[1] - rows[0])
        if world > 1 or channels is not None or rows is not None:
            keep = keep.contiguous(memory_format=memory_format)
        if self.record:
            per = keep.reshape((t1 - t0, shape[0] // (t1 - t0)) + tuple(shape[1:]))
            self.masks[path] = per if given is None else torch.cat([given, per])
        return keep


class CheapDropout(nn.Module):
    """Dropout with the JAX package's law (resnet.py:120-153): the keep
    probability quantized to keep_q / 256, keep_q = max(1, round((1 - rate)
    * 256)), and the kept values scaled by 256 / keep_q in the activation
    dtype, so E[out] = x exactly (rate 0.5: keep_q 128, scale 2; 0.3: 179,
    1.43017; 0.1: 230, 1.11304).  `channelwise` drops whole (sample,
    channel) planes of an NCHW input (Dropout2d; the JAX mask (N, 1, 1, C)).

    The identity unless `draws` is set (live_dropout), and at rate 0; the
    mask comes from draws.keep under this layer's `path` in the model.  In
    a sharded tail `channel_shard` (j, m) says the input holds channel shard
    j of m (parallel.tensor_parallel); in a backbone pass split by rows the
    input is the rank's slab (parallel.spatial)."""

    def __init__(self, rate: float = 0.0, channelwise: bool = False):
        super().__init__()
        self.rate = rate
        self.channelwise = channelwise
        self.keep_q = max(1, round((1.0 - rate) * 256.0))
        self.path = ""
        self.draws: Optional[UCDraws] = None
        self.channel_shard: Optional[Tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.draws is None or self.rate == 0.0:
            return x
        shape = tuple(x.shape)
        if self.channelwise:
            shape = shape[:2] + (1,) * (x.dim() - 2)
        channels_last = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)
        split = spatial.active()
        rows = None
        if split is not None and not self.channelwise:
            h = split.height(x)
            rows = split.rows(h) + (h,)
        keep = self.draws.keep(self.path, shape, self.keep_q, x.device,
                               torch.channels_last if channels_last else torch.contiguous_format,
                               channels=self.channel_shard, rows=rows)
        scale = torch.tensor(256.0 / self.keep_q, dtype=x.dtype, device=x.device)
        return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


@contextlib.contextmanager
def live_dropout(draws: UCDraws, *modules: nn.Module) -> Iterator[None]:
    """Within the block, every CheapDropout layer of `modules` drops with
    masks from `draws`; after it they are identities again."""
    layers = [m for mod in modules for m in mod.modules() if isinstance(m, CheapDropout)]
    for m in layers:
        m.draws = draws
    try:
        yield
    finally:
        for m in layers:
            m.draws = None


def _norm(live_bn: bool):
    return LiveBatchNorm if live_bn else FrozenBatchNorm


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return spatial.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class Bottleneck(nn.Module):
    """ref resnet.py:74-128 plus the wrapper's stride surgery (:227-238).

    `drop1`, `drop2d` and `drop3` are the MC-dropout layers at `drop_rate`
    (after relu1, channelwise after relu2, after the residual relu).
    """

    def __init__(
        self,
        cin: int,
        planes: int,
        stride: int = 1,
        caffe_stride: bool = False,
        has_downsample: bool = False,
        live_bn: bool = False,
        zero_init_residual: bool = False,
        drop_rate: float = 0.0,
    ):
        super().__init__()
        norm = _norm(live_bn)
        self.zero_init_residual = zero_init_residual
        s1 = stride if caffe_stride else 1
        s2 = 1 if caffe_stride else stride
        self.conv1 = _conv(cin, planes, 1, s1)
        self.bn1 = norm(planes)
        self.drop1 = CheapDropout(drop_rate)
        self.conv2 = _conv(planes, planes, 3, s2)
        self.bn2 = norm(planes)
        self.drop2d = CheapDropout(drop_rate, channelwise=True)
        self.conv3 = _conv(planes, planes * EXPANSION, 1)
        self.bn3 = norm(planes * EXPANSION)
        self.drop3 = CheapDropout(drop_rate)
        self.downsample = (
            nn.Sequential(_conv(cin, planes * EXPANSION, 1, stride), norm(planes * EXPANSION))
            if has_downsample
            else None
        )

    @property
    def terminator(self) -> FrozenBatchNorm:
        """The BN that ends the residual branch."""
        return self.bn3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # in a sharded tail (parallel.tensor_parallel) each conv computes
        # this rank's output channels from its whole input; the identity is
        # the rank's channels of the block's input
        with span("det.block"):
            x = column_input(x, self.conv1)
            identity = x if self.downsample is None else self.downsample(x)
            identity = own_channels(identity, self.bn3.weight.shape[0])
            out = self.drop1(torch.relu(self.bn1(self.conv1(x))))
            out = self.drop2d(torch.relu(self.bn2(self.conv2(column_input(out, self.conv2)))))
            out = self.bn3(self.conv3(column_input(out, self.conv3)))
            return self.drop3(torch.relu(out + identity))


class BasicBlock(nn.Module):
    """ref resnet.py:40-72 (res18/34): conv1 3x3 with the stride, bn1, relu,
    conv2 3x3, bn2 (the terminator), plus the identity or a 1x1 downsample.
    No caffe-stride move and no dropout places, as in the JAX package."""

    def __init__(
        self,
        cin: int,
        planes: int,
        stride: int = 1,
        has_downsample: bool = False,
        live_bn: bool = False,
        zero_init_residual: bool = False,
    ):
        super().__init__()
        norm = _norm(live_bn)
        self.zero_init_residual = zero_init_residual
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = norm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = norm(planes)
        self.downsample = (
            nn.Sequential(_conv(cin, planes, 1, stride), norm(planes)) if has_downsample else None
        )

    @property
    def terminator(self) -> FrozenBatchNorm:
        """The BN that ends the residual branch."""
        return self.bn2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("det.block"):
            x = column_input(x, self.conv1)  # as Bottleneck's, in a sharded tail
            identity = x if self.downsample is None else self.downsample(x)
            identity = own_channels(identity, self.bn2.weight.shape[0])
            out = torch.relu(self.bn1(self.conv1(x)))
            return torch.relu(self.bn2(self.conv2(column_input(out, self.conv2))) + identity)


class ResStage(nn.Sequential):
    """One layerN group of blocks, named 0..n-1 like torchvision."""

    def __init__(
        self,
        cin: int,
        planes: int,
        num_blocks: int,
        stride: int = 1,
        caffe_stride: bool = False,
        basic: bool = False,
        live_bn: bool = False,
        zero_init_residual: bool = False,
        drop_rate: float = 0.0,
    ):
        exp = 1 if basic else EXPANSION
        bn = dict(live_bn=live_bn, zero_init_residual=zero_init_residual)
        blocks = []
        for i in range(num_blocks):
            s = stride if i == 0 else 1
            needs_ds = i == 0 and (s != 1 or cin != planes * exp)
            if basic:
                blocks.append(BasicBlock(cin, planes, s, needs_ds, **bn))
            else:
                blocks.append(Bottleneck(cin, planes, s, caffe_stride, needs_ds, **bn,
                                         drop_rate=drop_rate))
            cin = planes * exp
        super().__init__(*blocks)


def _stem_forward(conv1: nn.Conv2d, bn1: FrozenBatchNorm, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(bn1(conv1(x)))
    return spatial.max_pool2d(x, 3, stride=2, padding=1)


class ResNetStem(nn.Module):
    """conv1 7x7/2 (pad 3), bn1, relu, maxpool 3x3/2 (pad 1, -inf padding)."""

    def __init__(self, cin: int = 3, live_bn: bool = False):
        super().__init__()
        self.conv1 = spatial.Conv2d(cin, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _norm(live_bn)(64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _stem_forward(self.conv1, self.bn1, x)


class _Backbone(nn.Module):
    """The stem and layer1..layer3 of ResNetC4 and ResNetPyramid."""

    def __init__(self, num_layers: int, in_channels: int, live_bn: bool, zero_init_residual: bool,
                 drop_rate: float):
        super().__init__()
        blocks = _stage_blocks(num_layers)
        exp = _expansion(num_layers)
        self._stage_kw = dict(basic=exp == 1, live_bn=live_bn,
                              zero_init_residual=zero_init_residual, drop_rate=drop_rate)
        self.conv1 = spatial.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _norm(live_bn)(64)
        self.layer1 = ResStage(64, 64, blocks[0], 1, **self._stage_kw)
        self.layer2 = ResStage(64 * exp, 128, blocks[1], 2, caffe_stride=True, **self._stage_kw)
        self.layer3 = ResStage(128 * exp, 256, blocks[2], 2, caffe_stride=True, **self._stage_kw)


class ResNetC4(_Backbone):
    """Stem + layer1..layer3 -> the stride-16 feature map of `out_channels`:
    1024 at Bottleneck depths, 256 at BasicBlock depths.

    The stem's modules sit at the top level (conv1, bn1) as in torchvision;
    layer4 lives in the detection tail (ResNetLayer4)."""

    def __init__(
        self, num_layers: int = 101, in_channels: int = 3, live_bn: bool = False,
        zero_init_residual: bool = False, drop_rate: float = 0.0,
    ):
        super().__init__(num_layers, in_channels, live_bn, zero_init_residual, drop_rate)
        self.out_channels = 256 * _expansion(num_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _stem_forward(self.conv1, self.bn1, x)
        return self.layer3(self.layer2(self.layer1(x)))


class ResNetLayer4(nn.Module):
    """The C4 detection tail: stride-1 layer4 over pooled RoIs, to
    `out_channels` (2048, or 512 at BasicBlock depths)."""

    def __init__(
        self, num_layers: int = 101, live_bn: bool = False, zero_init_residual: bool = False,
        drop_rate: float = 0.0,
    ):
        super().__init__()
        blocks = _stage_blocks(num_layers)
        exp = _expansion(num_layers)
        self.out_channels = 512 * exp
        self.layer4 = ResStage(256 * exp, 512, blocks[3], stride=1, basic=exp == 1,
                               live_bn=live_bn, zero_init_residual=zero_init_residual,
                               drop_rate=drop_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer4(x)


class ResNetPyramid(_Backbone):
    """Stem + layer1..layer4 -> (c2, c3, c4, c5) at strides 4, 8, 16, 32
    (ref resnet.py:431-474), of `out_channels` (256, 512, 1024, 2048), or
    (64, 128, 256, 512) at BasicBlock depths.  The stem sits at the top
    level (conv1, bn1), as in ResNetC4, and layer4 lives here, not in a
    tail."""

    def __init__(
        self, num_layers: int = 101, in_channels: int = 3, live_bn: bool = False,
        zero_init_residual: bool = False, drop_rate: float = 0.0,
    ):
        super().__init__(num_layers, in_channels, live_bn, zero_init_residual, drop_rate)
        exp = _expansion(num_layers)
        self.out_channels = tuple(p * exp for p in (64, 128, 256, 512))
        # torchvision's stride placement
        self.layer4 = ResStage(256 * exp, 512, _stage_blocks(num_layers)[3], 2, **self._stage_kw)

    def forward(self, x: torch.Tensor) -> tuple:
        c2 = self.layer1(_stem_forward(self.conv1, self.bn1, x))
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        return c2, c3, c4, self.layer4(c4)
