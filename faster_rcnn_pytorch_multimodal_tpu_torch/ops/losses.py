"""Detection losses without uncertainty.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/losses.py `huber_loss`,
`smooth_l1_loss` (:17-78: the image and the 7-DoF lidar branch, no aleatoric
variance) and `cross_entropy`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def huber_loss(
    pred: torch.Tensor, targets: torch.Tensor, huber_delta: float, sin_en: bool = False
) -> torch.Tensor:
    """Elementwise smooth-L1 / Huber; with sin_en of the sine of the residual
    (heading channels)."""
    diff = pred - targets
    if sin_en:
        diff = torch.sin(diff)
    abs_diff = diff.abs()
    quad = 0.5 * diff**2
    lin = huber_delta * (abs_diff - 0.5 * huber_delta)
    return torch.where(abs_diff < huber_delta, quad, lin)


def smooth_l1_loss(
    bbox_pred: torch.Tensor,
    bbox_targets: torch.Tensor,
    bbox_inside_weights: torch.Tensor,
    bbox_outside_weights: torch.Tensor,
    *,
    lidar_det: bool = False,
    en_ry_sin: bool = True,
    reg_loss_weight: Tuple[float, ...] = (1.0,) * 7,
    sum_axes: Tuple[int, ...] = (1,),
) -> torch.Tensor:
    """Box regression loss: Huber(delta 1) of the inside-weighted residual,
    times the outside weights, summed over `sum_axes`, then the mean.

    lidar_det: (..., 7K) second-stage 7-DoF boxes; the heading channel's
    residual goes through its sine when en_ry_sin, and each of the 7
    elements is weighted by reg_loss_weight (LIDAR.REG_LOSS_WEIGHT)."""
    pred = bbox_pred * bbox_inside_weights
    targets = bbox_targets * bbox_inside_weights
    if lidar_det:
        p7, t7 = pred.reshape(-1, 7), targets.reshape(-1, 7)
        loss = torch.cat([huber_loss(p7[:, :6], t7[:, :6], 1.0),
                          huber_loss(p7[:, 6:7], t7[:, 6:7], 1.0, sin_en=en_ry_sin)], dim=1)
        weight = torch.tensor(reg_loss_weight, dtype=loss.dtype, device=loss.device)
        in_loss = (loss * weight).reshape(pred.shape)
    else:
        in_loss = huber_loss(pred, targets, 1.0)
    out_loss = bbox_outside_weights * in_loss
    return out_loss.sum(dim=tuple(sum_axes)).mean()


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Softmax cross-entropy of (N, C) logits at (N,) labels; with (N,)
    weights the weighted mean over max(sum of weights, 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    if weights is None:
        return nll.mean()
    w = weights.to(nll.dtype)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
