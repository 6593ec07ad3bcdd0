"""MobileNetV1 backbone and tail.

Port of faster_rcnn_pytorch_multimodal_tpu/models/mobilenet.py:
  * MobileNetV1Head: conv0 (3x3, stride 2, no bias), bn0, ReLU6, then the
    depthwise-separable layers 1-11: a stride-16 map of
    `_depth(512, m)` channels;
  * MobileNetV1Tail: layers 12 and 13 over the pooled RoIs, then the
    spatial mean.  The JAX package lists layer 12 at stride 2
    (`_TAIL_BLOCKS`) but builds both tail layers at stride 1, so the 7x7
    RoI stays 7x7; the port builds what JAX builds.

A separable layer (`SepConv`) is a depthwise 3x3 conv (groups = C, no
bias), `dw_bn`, ReLU6, a pointwise 1x1 conv (no bias), `pw_bn`, ReLU6.
Widths are `_depth(ch, m) = max(int(ch * m), 8)` at MOBILENET.DEPTH_MULTIPLIER
m.  Every BN is a FrozenBatchNorm at every RESNET.FIXED_BLOCKS, as in the
JAX package, whose scale and bias are parameters: training.optim's frozen
mask holds them fixed unless FIXED_BLOCKS is -1, where they train and the
statistics stay as they are (`AffineBatchNorm`).

Modules are NCHW; the detector runs them on channels_last tensors.  On a
model axis the head's convs split by rows inside a backbone pass
(parallel.spatial), and the tail's layers hold a rank's shard of their
channels (parallel.tensor_parallel): a depthwise conv its channels (it
takes the rank's channels of its input, with no gather), a pointwise conv
its output channels from the whole input.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from faster_rcnn_pytorch_multimodal_tpu_torch.models.resnet import AffineBatchNorm
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import spatial
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.tensor_parallel import (
    column_input,
    depthwise_input,
)

# (stride, channels) of layers 1-11, then of the tail's layers 12-13 as built
HEAD_BLOCKS = ((1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
               (1, 512), (1, 512), (1, 512), (1, 512), (1, 512))
TAIL_BLOCKS = ((1, 1024), (1, 1024))
STEM_CHANNELS = 32


def _depth(ch: int, mult: float) -> int:
    return max(int(ch * mult), 8)


class SepConv(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.depthwise = spatial.Conv2d(cin, cin, 3, stride=stride, padding=1, groups=cin,
                                        bias=False)
        self.dw_bn = AffineBatchNorm(cin)
        self.pointwise = spatial.Conv2d(cin, cout, 1, bias=False)
        self.pw_bn = AffineBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu6(self.dw_bn(self.depthwise(depthwise_input(x, self.depthwise))))
        return F.relu6(self.pw_bn(self.pointwise(column_input(x, self.pointwise))))


class MobileNetV1Head(nn.Module):
    def __init__(self, depth_multiplier: float = 1.0, in_channels: int = 3):
        super().__init__()
        m = depth_multiplier
        cin = _depth(STEM_CHANNELS, m)
        self.conv0 = spatial.Conv2d(in_channels, cin, 3, stride=2, padding=1, bias=False)
        self.bn0 = AffineBatchNorm(cin)
        for i, (stride, ch) in enumerate(HEAD_BLOCKS):
            self.add_module(f"layer{i + 1}", SepConv(cin, _depth(ch, m), stride))
            cin = _depth(ch, m)
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu6(self.bn0(self.conv0(x)))
        for i in range(len(HEAD_BLOCKS)):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


class MobileNetV1Tail(nn.Module):
    """Layers 12-13 over (R, C, 7, 7) RoIs -> (R, C', 7, 7); the detector
    takes the spatial mean."""

    def __init__(self, depth_multiplier: float = 1.0):
        super().__init__()
        m = depth_multiplier
        cin = _depth(HEAD_BLOCKS[-1][1], m)
        first = len(HEAD_BLOCKS) + 1
        for i, (stride, ch) in enumerate(TAIL_BLOCKS):
            self.add_module(f"layer{first + i}", SepConv(cin, _depth(ch, m), stride))
            cin = _depth(ch, m)
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x
