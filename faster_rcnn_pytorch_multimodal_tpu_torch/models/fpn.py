"""Feature Pyramid Network (port of faster_rcnn_pytorch_multimodal_tpu/
models/fpn.py:18-51).

Lateral 1x1 convs (latlayer2..5) and 3x3 anti-alias convs (aalayer2..4),
all with bias.  As in the JAX package (and the reference), only p2 and p3
pass through their anti-alias conv; aalayer4 is built and never applied, so
a bridged checkpoint loads strictly.  The top-down path upsamples with
bilinear interpolation, align_corners=False, to the next map's size.

`jax.image.resize` renormalizes its triangle kernel at the borders where
F.interpolate clamps the source index; when upsampling the two give the
same weights, also at ratios other than 2 (a frame whose size is not a
multiple of 32), which tests/test_torch_port_fpn.py shows at 120x200.

Modules are NCHW; the detector runs them on channels_last tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F


def _upsample_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=like.shape[-2:], mode="bilinear", align_corners=False)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], planes: int = 256):
        super().__init__()
        c2, c3, c4, c5 = in_channels
        self.latlayer2 = nn.Conv2d(c2, planes, 1)
        self.latlayer3 = nn.Conv2d(c3, planes, 1)
        self.latlayer4 = nn.Conv2d(c4, planes, 1)
        self.latlayer5 = nn.Conv2d(c5, planes, 1)
        self.aalayer2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.aalayer3 = nn.Conv2d(planes, planes, 3, padding=1)
        self.aalayer4 = nn.Conv2d(planes, planes, 3, padding=1)  # never applied, see above

    def forward(self, c2, c3, c4, c5) -> Tuple[torch.Tensor, ...]:
        p5 = self.latlayer5(c5)
        p4 = _upsample_to(p5, c4) + self.latlayer4(c4)
        p3 = self.aalayer3(_upsample_to(p4, c3) + self.latlayer3(c3))
        p2 = self.aalayer2(_upsample_to(p3, c2) + self.latlayer2(c2))
        return p2, p3, p4, p5
