"""ResNet backbone and C4 tail with the reference's detection surgery, and
the FPN's pyramid backbone.

Port of faster_rcnn_pytorch_multimodal_tpu/models/resnet.py:57-474:
  * FrozenBatchNorm (frozen mode; live BN is for training),
  * Bottleneck with caffe-style stride placement: layers 2 and 3 put the
    stride on the 1x1 conv1 instead of the 3x3 conv2, and the downsample
    conv carries it,
  * stride-1 layer4 as the C4 detection tail;
  * ResNetPyramid for FPN: stem and layer1..4 -> (c2, c3, c4, c5), with a
    stride-2 layer4 that places its stride as torchvision does (on the 3x3
    conv2 and the downsample), unlike layers 2 and 3.

Modules are NCHW, as PyTorch's convolutions are; the detector runs them on
channels_last tensors, so the NHWC views it hands to RoI align are free.
Module names follow torchvision's ResNet (conv1, bn1, layer1.0.conv1,
layer1.0.downsample.0/1, ...), so a torchvision state dict maps key for key.
"""

from __future__ import annotations

import torch
from torch import nn

# layers-per-stage per depth (ref resnet.py:242-295); Bottleneck depths only
STAGE_BLOCKS = {
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
EXPANSION = 4


class FrozenBatchNorm(nn.Module):
    """BN as a fixed affine map: y = (x - mean) * rsqrt(var + eps) * weight + bias.

    The per-channel affine is computed in float32 from the stored values and
    applied in the activation dtype, as the JAX package does
    (resnet.py:110-117): with bfloat16 compute the stored values are bf16 and
    only the C-element affine runs in float32.
    """

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
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        a = inv * self.weight.float()
        b = self.bias.float() - self.running_mean.float() * a
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class Bottleneck(nn.Module):
    """ref resnet.py:74-128 plus the wrapper's stride surgery (:227-238).

    `drop1`, `drop2d` and `drop3` hold the places of the MC-dropout layers
    (after relu1, channelwise after relu2, after the residual relu); the
    serving path is deterministic, so they are identities here.
    """

    def __init__(
        self,
        cin: int,
        planes: int,
        stride: int = 1,
        caffe_stride: bool = False,
        has_downsample: bool = False,
    ):
        super().__init__()
        s1 = stride if caffe_stride else 1
        s2 = 1 if caffe_stride else stride
        self.conv1 = _conv(cin, planes, 1, s1)
        self.bn1 = FrozenBatchNorm(planes)
        self.drop1 = nn.Identity()
        self.conv2 = _conv(planes, planes, 3, s2)
        self.bn2 = FrozenBatchNorm(planes)
        self.drop2d = nn.Identity()
        self.conv3 = _conv(planes, planes * EXPANSION, 1)
        self.bn3 = FrozenBatchNorm(planes * EXPANSION)
        self.drop3 = nn.Identity()
        self.downsample = (
            nn.Sequential(
                _conv(cin, planes * EXPANSION, 1, stride),
                FrozenBatchNorm(planes * EXPANSION),
            )
            if has_downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.drop1(torch.relu(self.bn1(self.conv1(x))))
        out = self.drop2d(torch.relu(self.bn2(self.conv2(out))))
        out = self.bn3(self.conv3(out))
        return self.drop3(torch.relu(out + identity))


class ResStage(nn.Sequential):
    """One layerN group of Bottleneck blocks, named 0..n-1 like torchvision."""

    def __init__(
        self,
        cin: int,
        planes: int,
        num_blocks: int,
        stride: int = 1,
        caffe_stride: bool = False,
    ):
        blocks = []
        for i in range(num_blocks):
            s = stride if i == 0 else 1
            needs_ds = i == 0 and (s != 1 or cin != planes * EXPANSION)
            blocks.append(Bottleneck(cin, planes, s, caffe_stride, needs_ds))
            cin = planes * EXPANSION
        super().__init__(*blocks)


def _stem_forward(conv1: nn.Conv2d, bn1: FrozenBatchNorm, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(bn1(conv1(x)))
    return nn.functional.max_pool2d(x, 3, stride=2, padding=1)


class ResNetStem(nn.Module):
    """conv1 7x7/2 (pad 3), bn1, relu, maxpool 3x3/2 (pad 1, -inf padding)."""

    def __init__(self, cin: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _stem_forward(self.conv1, self.bn1, x)


class ResNetC4(nn.Module):
    """Stem + layer1..layer3 -> stride-16, 1024-channel feature map.

    The stem's modules sit at the top level (conv1, bn1) as in torchvision;
    layer4 lives in the detection tail (ResNetLayer4)."""

    out_channels = 256 * EXPANSION

    def __init__(self, num_layers: int = 101, in_channels: int = 3):
        super().__init__()
        if num_layers not in STAGE_BLOCKS:
            raise NotImplementedError(
                f"res{num_layers}: the port has Bottleneck depths {sorted(STAGE_BLOCKS)}"
            )
        blocks = STAGE_BLOCKS[num_layers]
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = ResStage(64, 64, blocks[0], 1)
        self.layer2 = ResStage(256, 128, blocks[1], 2, caffe_stride=True)
        self.layer3 = ResStage(512, 256, blocks[2], 2, caffe_stride=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _stem_forward(self.conv1, self.bn1, x)
        return self.layer3(self.layer2(self.layer1(x)))


class ResNetLayer4(nn.Module):
    """The C4 detection tail: stride-1 layer4 over pooled RoIs."""

    out_channels = 512 * EXPANSION

    def __init__(self, num_layers: int = 101):
        super().__init__()
        if num_layers not in STAGE_BLOCKS:
            raise NotImplementedError(
                f"res{num_layers}: the port has Bottleneck depths {sorted(STAGE_BLOCKS)}"
            )
        self.layer4 = ResStage(1024, 512, STAGE_BLOCKS[num_layers][3], stride=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer4(x)


class ResNetPyramid(nn.Module):
    """Stem + layer1..layer4 -> (c2, c3, c4, c5) at strides 4, 8, 16, 32
    (ref resnet.py:431-474).  The stem sits at the top level (conv1, bn1),
    as in ResNetC4, and layer4 lives here, not in a tail."""

    out_channels = (64 * EXPANSION, 128 * EXPANSION, 256 * EXPANSION, 512 * EXPANSION)

    def __init__(self, num_layers: int = 101, in_channels: int = 3):
        super().__init__()
        if num_layers not in STAGE_BLOCKS:
            raise NotImplementedError(
                f"res{num_layers}: the port has Bottleneck depths {sorted(STAGE_BLOCKS)}"
            )
        blocks = STAGE_BLOCKS[num_layers]
        self.conv1 = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = ResStage(64, 64, blocks[0], 1)
        self.layer2 = ResStage(256, 128, blocks[1], 2, caffe_stride=True)
        self.layer3 = ResStage(512, 256, blocks[2], 2, caffe_stride=True)
        self.layer4 = ResStage(1024, 512, blocks[3], 2)  # torchvision's stride placement

    def forward(self, x: torch.Tensor) -> tuple:
        c2 = self.layer1(_stem_forward(self.conv1, self.bn1, x))
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        return c2, c3, c4, self.layer4(c4)
