"""RPN head and second-stage predictors.

Port of faster_rcnn_pytorch_multimodal_tpu/models/heads.py:35-59 (RPNHead),
:62-78 (FCTail) and :109-163 (DetectionPredictors) without the uncertainty
branches:

  rpn_net (3x3 conv -> rpn_channels) -> rpn_cls_score_net (1x1, 2A),
                                        rpn_bbox_pred_net (1x1, 4A)
  FPN tail: flat pooled RoI -> t_fc1 -> t_fc2 -> t_fc3 (each + ReLU) = fc7
  fc7 -> cls_score_net (K), bbox_pred_net (E*K)

Init (ref imagenet.py:65-91) is done by models.detector.init_params.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn


class RPNHead(nn.Module):
    """3x3 conv + twin 1x1 predictors over the RPN feature map (NCHW)."""

    def __init__(self, in_channels: int, rpn_channels: int = 512, num_anchors: int = 25):
        super().__init__()
        self.rpn_net = nn.Conv2d(in_channels, rpn_channels, 3, padding=1)
        self.rpn_cls_score_net = nn.Conv2d(rpn_channels, num_anchors * 2, 1)
        self.rpn_bbox_pred_net = nn.Conv2d(rpn_channels, num_anchors * 4, 1)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.rpn_net(feat))
        return self.rpn_cls_score_net(x), self.rpn_bbox_pred_net(x)


class FCTail(nn.Module):
    """Three dense layers with ReLU over the flattened pooled RoI (the FPN
    tail).  The caller flattens NHWC pooled RoIs in (y, x, c) order, as the
    JAX package does, so a bridged t_fc1 weight applies as it is."""

    def __init__(self, in_features: int, fc7_channels: int = 2048):
        super().__init__()
        self.t_fc1 = nn.Linear(in_features, fc7_channels)
        self.t_fc2 = nn.Linear(fc7_channels, fc7_channels)
        self.t_fc3 = nn.Linear(fc7_channels, fc7_channels)

    def forward(self, flat: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.t_fc1(flat))
        x = torch.relu(self.t_fc2(x))
        return torch.relu(self.t_fc3(x))


class DetectionPredictors(nn.Module):
    """fc7 -> class scores and box deltas."""

    def __init__(self, det_channels: int, num_classes: int, num_bbox_elem: int = 4):
        super().__init__()
        self.cls_score_net = nn.Linear(det_channels, num_classes)
        self.bbox_pred_net = nn.Linear(det_channels, num_bbox_elem * num_classes)

    def forward(self, fc7: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {
            "cls_score": self.cls_score_net(fc7),
            "bbox_pred": self.bbox_pred_net(fc7),
        }
