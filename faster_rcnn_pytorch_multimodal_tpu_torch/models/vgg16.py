"""VGG16 backbone and tail.

Port of faster_rcnn_pytorch_multimodal_tpu/models/vgg16.py:
  * VGG16Head: the 13 3x3 convs (each with a bias and a ReLU) and the four
    2x2 max pools of `_CFG`, without the final pool: a stride-16 map of
    512 channels.  Each pool floors, so a 350-wide BEV raster gives 21
    columns where ResNet's C4 gives 22.  The convs are named early_conv0..3
    and late_conv4..12, as the JAX package names them, so the weight bridge
    maps them by name.
  * VGG16Tail: fc6 and fc7 (4096 wide), each followed by a ReLU and a
    CheapDropout at 0.5 (drop6, drop7), over each pooled 7x7x512 RoI
    flattened in (y, x, c) order by the caller.  The dropout is the identity
    unless live_dropout hands it draws: under epistemic uncertainty, in
    training and in the Monte-Carlo samples, as the JAX package runs it.

Modules are NCHW; the detector runs the head on channels_last tensors.
The head's convs and pools split by rows inside a backbone pass on a model
axis (parallel.spatial); fc6 and fc7 are column parallel there, each rank
computing its shard of their 4096 outputs (parallel.tensor_parallel).
"""

from __future__ import annotations

import torch
from torch import nn

from faster_rcnn_pytorch_multimodal_tpu_torch.models.resnet import CheapDropout
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import spatial
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.tensor_parallel import column_input

_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
        512, 512, 512)
EARLY_CONVS = 4  # conv1_1..conv2_2, the JAX package's `early` scope
FC_CHANNELS = 4096
DROP_RATE = 0.5


def conv_names() -> list:
    """The 13 convs' module names, in order."""
    n = sum(1 for s in _CFG if s != "M")
    return [f"{'early' if i < EARLY_CONVS else 'late'}_conv{i}" for i in range(n)]


class VGG16Head(nn.Module):
    """The conv stack to stride 16 (torchvision's features[:-1]): each conv
    followed by a ReLU, the pools (pool0..3, no parameters) between."""

    out_channels = 512

    def __init__(self, in_channels: int = 3):
        super().__init__()
        names = iter(conv_names())
        cin, pools = in_channels, 0
        for spec in _CFG:
            if spec == "M":
                self.add_module(f"pool{pools}", spatial.MaxPool2d(2, 2))
                pools += 1
            else:
                self.add_module(next(names), spatial.Conv2d(cin, spec, 3, padding=1))
                cin = spec

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x) if isinstance(layer, nn.MaxPool2d) else torch.relu(layer(x))
        return x


class VGG16Tail(nn.Module):
    """fc6 -> ReLU -> drop6 -> fc7 -> ReLU -> drop7 over flat (R, 7 * 7 *
    512) RoIs; returns the flat (R, 4096) fc7."""

    out_channels = FC_CHANNELS

    def __init__(self, in_features: int = 7 * 7 * 512):
        super().__init__()
        self.fc6 = nn.Linear(in_features, FC_CHANNELS)
        self.drop6 = CheapDropout(DROP_RATE)
        self.fc7 = nn.Linear(FC_CHANNELS, FC_CHANNELS)
        self.drop7 = CheapDropout(DROP_RATE)

    def forward(self, flat: torch.Tensor) -> torch.Tensor:
        x = self.drop6(torch.relu(self.fc6(column_input(flat, self.fc6))))
        return self.drop7(torch.relu(self.fc7(column_input(x, self.fc7))))
