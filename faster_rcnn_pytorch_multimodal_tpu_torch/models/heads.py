"""RPN head and second-stage predictors.

Port of faster_rcnn_pytorch_multimodal_tpu/models/heads.py: RPNHead
(:35-59), FCTail (:62-78), EpistemicStack (:81-106) and DetectionPredictors
(:109-163) with its uncertainty branches:

  rpn_net (3x3 conv -> rpn_channels) -> rpn_cls_score_net (1x1, 2A),
                                        rpn_bbox_pred_net (1x1, 4A)
  FPN tail: flat pooled RoI -> t_fc1 -> t_fc2 -> t_fc3 (each + ReLU) = fc7
  fc7 [-> cls_stack] -> cls_score_net (K) [, cls_al_var_net (K)]
  fc7 [-> bbox_stack] -> bbox_pred_net (E*K) [, bbox_al_var_net (E*K)]

A stack (epistemic uncertainty) is fc1, BN under lidar, ReLU, dropout, fc2,
BN, ReLU, dropout (the BN an AffineBatchNorm: the JAX package trains its
scale and bias, since its frozen mask does not match the `cls_bn1` /
`bbox_bn2` names), at the JAX package's rates (0.3 before the class head,
0.1 before the box head); the aleatoric heads predict log-variances.  The
RPN's variance convs sit on the detector (models.detector).

Init (ref imagenet.py:65-91) is done by models.detector.init_params.

On a model axis (parallel.tensor_parallel) FCTail is column parallel (each
rank computes its shard of every layer's outputs from the whole input) and
the predictors' and stacks' dense layers are row parallel (`row_linear`:
the rank's rows of the input, the products summed over the model group, the
bias added once), so every output comes out whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from faster_rcnn_pytorch_multimodal_tpu_torch.models.resnet import AffineBatchNorm, CheapDropout
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.tensor_parallel import (
    column_input,
    row_linear,
)

CLS_DROP_RATE = 0.3
BBOX_DROP_RATE = 0.1


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
        x = torch.relu(self.t_fc1(column_input(flat, self.t_fc1)))
        x = torch.relu(self.t_fc2(column_input(x, self.t_fc2)))
        return torch.relu(self.t_fc3(column_input(x, self.t_fc3)))


class EpistemicStack(nn.Module):
    """{prefix}_fc1 [-> {prefix}_bn1] -> ReLU -> {prefix}_drop1 ->
    {prefix}_fc2 [-> {prefix}_bn2] -> ReLU -> {prefix}_drop2, `features`
    wide.  The dropout layers are live in training and in the MC samples
    (models.resnet.live_dropout)."""

    def __init__(self, in_features: int, features: int, drop_rate: float,
                 batchnorm_en: bool = False, prefix: str = "cls"):
        super().__init__()
        self.prefix = prefix
        for i, cin in ((1, in_features), (2, features)):
            self.add_module(f"{prefix}_fc{i}", nn.Linear(cin, features))
            if batchnorm_en:
                self.add_module(f"{prefix}_bn{i}", AffineBatchNorm(features))
            self.add_module(f"{prefix}_drop{i}", CheapDropout(drop_rate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.prefix
        for i in (1, 2):
            x = row_linear(getattr(self, f"{p}_fc{i}"), x)
            bn = getattr(self, f"{p}_bn{i}", None)
            if bn is not None:
                x = bn(x)
            x = getattr(self, f"{p}_drop{i}")(torch.relu(x))
        return x


class DetectionPredictors(nn.Module):
    """fc7 -> class scores and box deltas, through an epistemic stack each
    when asked, and the aleatoric log-variances of either."""

    def __init__(
        self,
        fc7_channels: int,
        num_classes: int,
        num_bbox_elem: int = 4,
        det_channels: Optional[int] = None,
        en_cls_aleatoric: bool = False,
        en_bbox_aleatoric: bool = False,
        en_cls_epistemic: bool = False,
        en_bbox_epistemic: bool = False,
        lidar_bn: bool = False,
    ):
        super().__init__()
        k, ek = num_classes, num_bbox_elem * num_classes
        det = det_channels or fc7_channels
        self.cls_stack = (EpistemicStack(fc7_channels, det, CLS_DROP_RATE, lidar_bn, "cls")
                          if en_cls_epistemic else None)
        self.bbox_stack = (EpistemicStack(fc7_channels, det, BBOX_DROP_RATE, lidar_bn, "bbox")
                           if en_bbox_epistemic else None)
        cls_in = det if en_cls_epistemic else fc7_channels
        bbox_in = det if en_bbox_epistemic else fc7_channels
        self.cls_score_net = nn.Linear(cls_in, k)
        self.bbox_pred_net = nn.Linear(bbox_in, ek)
        self.cls_al_var_net = nn.Linear(cls_in, k) if en_cls_aleatoric else None
        self.bbox_al_var_net = nn.Linear(bbox_in, ek) if en_bbox_aleatoric else None

    def forward(self, fc7: torch.Tensor) -> Dict[str, torch.Tensor]:
        cls_in = fc7 if self.cls_stack is None else self.cls_stack(fc7)
        bbox_in = fc7 if self.bbox_stack is None else self.bbox_stack(fc7)
        out = {"cls_score": row_linear(self.cls_score_net, cls_in),
               "bbox_pred": row_linear(self.bbox_pred_net, bbox_in)}
        if self.cls_al_var_net is not None:
            out["cls_al_var"] = row_linear(self.cls_al_var_net, cls_in)
        if self.bbox_al_var_net is not None:
            out["bbox_al_var"] = row_linear(self.bbox_al_var_net, bbox_in)
        return out
