"""Detection losses without uncertainty.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/losses.py `huber_loss`,
`smooth_l1_loss` (image branch, no aleatoric variance) and `cross_entropy`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def huber_loss(pred: torch.Tensor, targets: torch.Tensor, huber_delta: float) -> torch.Tensor:
    """Elementwise smooth-L1 / Huber."""
    diff = pred - targets
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
    sum_axes: Tuple[int, ...] = (1,),
) -> torch.Tensor:
    """Box regression loss: Huber(delta 1) of the inside-weighted residual,
    times the outside weights, summed over `sum_axes`, then the mean."""
    pred = bbox_pred * bbox_inside_weights
    targets = bbox_targets * bbox_inside_weights
    out_loss = bbox_outside_weights * huber_loss(pred, targets, 1.0)
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
