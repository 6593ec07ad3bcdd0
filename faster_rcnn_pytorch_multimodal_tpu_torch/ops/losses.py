"""Detection losses, aleatoric attenuation, Bayesian cross-entropy and the
uncertainty statistics.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/losses.py: `huber_loss`,
`smooth_l1_loss` (:17-78, the image and the 7-DoF lidar branch, with the
aleatoric variance), `compute_bbox_var`, `categorical_entropy`,
`categorical_mutual_information`, `logit_distort`, the three Bayesian
cross-entropies (:81-187) and `cross_entropy`.

Nothing here draws: the logit draws take their (T, N, C) standard normals
from the caller, where the JAX package takes a key.

Every mean over the batch goes through `batch_mean` or
`weighted_batch_mean`.  Outside a data-parallel step they are the plain
means.  Inside one (parallel.data_parallel) a rank returns its share of the
global batch's loss, so that the global loss is the sum over the data
group, as JAX's SPMD step computes it over the global batch: a plain mean
over equal shards is the rank's mean over the data ranks, and a weighted
mean divides the rank's weighted sum by max(the global sum of the weights,
1).  The sums run over the data group only: a model group's ranks hold the
same rows and the same losses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import span


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean(); in a data-parallel step this rank's share of the global
    batch's mean (the shards are of one shape) over the data group."""
    world = mesh.world_size()
    return x.mean() if world == 1 else x.mean() / world


def weighted_batch_mean(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum(values * weights) / max(sum(weights), 1), the sum of the weights
    taken over the global batch (the data group) in a data-parallel step
    (without gradient: the weights are masks)."""
    w = weights.to(values.dtype)
    return (values * w).sum() / torch.clamp(mesh.reduce_sum(w.sum()), min=1.0)


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
    bbox_var: Optional[torch.Tensor] = None,
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
    elements is weighted by reg_loss_weight (LIDAR.REG_LOSS_WEIGHT).

    bbox_var: a predicted log-variance s for aleatoric attenuation: the
    elementwise loss L becomes (0.5 * L * exp(-s) + 0.5 * s) times the
    inside weights; None leaves L as it is."""
    pred = bbox_pred * bbox_inside_weights
    targets = bbox_targets * bbox_inside_weights
    if lidar_det:
        p7, t7 = pred.reshape(-1, 7), targets.reshape(-1, 7)
        loss = torch.cat([huber_loss(p7[:, :6], t7[:, :6], 1.0),
                          huber_loss(p7[:, 6:7], t7[:, 6:7], 1.0, sin_en=en_ry_sin)], dim=1)
        with span("sync.loss_weight"):  # a blocking copy: the host waits for the device
            weight = torch.tensor(reg_loss_weight, dtype=loss.dtype, device=loss.device)
        in_loss = (loss * weight).reshape(pred.shape)
    else:
        in_loss = huber_loss(pred, targets, 1.0)
    if bbox_var is not None:
        in_loss = 0.5 * in_loss * torch.exp(-bbox_var) + 0.5 * bbox_var
        in_loss = in_loss * bbox_inside_weights
    out_loss = bbox_outside_weights * in_loss
    return batch_mean(out_loss.sum(dim=tuple(sum_axes)))


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Softmax cross-entropy of (N, C) logits at (N,) labels; with (N,)
    weights the weighted mean over max(sum of weights, 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    if weights is None:
        return batch_mean(nll)
    return weighted_batch_mean(nll, weights)


def compute_bbox_var(samples: torch.Tensor) -> torch.Tensor:
    """Unbiased per-element variance over the leading sample axis, over
    max(n - 1, 1) (a single sample has variance 0), clipped at 0."""
    n = samples.shape[0]
    mean_sq = samples.sum(dim=0) ** 2
    var = (samples**2).sum(dim=0) - mean_sq / n
    return torch.clamp(var / max(n - 1, 1), min=0.0)


def categorical_entropy(cls_prob: torch.Tensor) -> torch.Tensor:
    """Shannon entropy in bits over the last (class) axis, log2 of the
    probabilities clipped at 1e-12."""
    return -(cls_prob * torch.log2(torch.clamp(cls_prob, min=1e-12))).sum(dim=-1)


def categorical_mutual_information(cls_score: torch.Tensor) -> torch.Tensor:
    """(T, N, C) logits over T samples -> (N,) mutual information between
    the prediction and the posterior: the entropy of the mean softmax less
    the mean entropy."""
    cls_prob = torch.softmax(cls_score, dim=2)
    total_entropy = categorical_entropy(cls_prob.mean(dim=0))
    mi = (cls_prob * torch.log2(torch.clamp(cls_prob, min=1e-12))).sum(dim=2)
    return mi.mean(dim=0) + total_entropy


def logit_distort(
    cls_score: torch.Tensor, cls_var: torch.Tensor, normals: torch.Tensor
) -> torch.Tensor:
    """(N, C) logits and per-logit variances -> (T, N, C) samples
    logits + normals * sqrt(var), the variance clipped at 1e-12; `normals`
    (T, N, C) standard normals from the caller."""
    std = torch.sqrt(torch.clamp(cls_var, min=1e-12))
    return cls_score[None] + normals * std[None]


def _pick(logp: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logp (..., N, C) at the (N,) target classes -> (..., N)."""
    idx = targets.long().reshape((1,) * (logp.dim() - 2) + (-1, 1))
    return logp.gather(-1, idx.expand(logp.shape[:-1] + (1,)))[..., 0]


def bayesian_cross_entropy(
    cls_score: torch.Tensor,
    cls_var: torch.Tensor,
    targets: torch.Tensor,
    normals: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aleatoric classification loss: the NLL of the target class under the
    mean softmax of the distorted logits (logit_distort with `normals`).
    With (N,) weights (the RPN: ignored anchor lanes weigh 0) the weighted
    mean over max(sum of weights, 1).  Returns (loss, (N,) mutual
    information of the samples)."""
    samples = logit_distort(cls_score, cls_var, normals)
    avg_softmax = torch.softmax(samples, dim=2).mean(dim=0)
    nll = -_pick(torch.log(torch.clamp(avg_softmax, min=1e-12)), targets)
    loss = batch_mean(nll) if weights is None else weighted_batch_mean(nll, weights)
    return loss, categorical_mutual_information(samples)


def bayesian_cross_entropy_simple(
    cls_score: torch.Tensor, cls_var: torch.Tensor, targets: torch.Tensor, normals: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-entropy of each distorted sample, averaged; and the (N,)
    mutual information."""
    samples = logit_distort(cls_score, cls_var, normals)
    nll = -_pick(torch.log_softmax(samples, dim=2), targets)
    return batch_mean(nll), categorical_mutual_information(samples)


def bayesian_elu_cross_entropy(
    cls_score: torch.Tensor, cls_var: torch.Tensor, targets: torch.Tensor, normals: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ELU-regularized variant: the undistorted NLL u and the distorted
    one d (bayesian_cross_entropy's), loss -elu(d - u) * u + u +
    exp(mean variance) - 1, averaged; and the (N,) mutual information."""
    undist = -_pick(torch.log_softmax(cls_score, dim=-1), targets)
    samples = logit_distort(cls_score, cls_var, normals)
    avg_softmax = torch.softmax(samples, dim=2).mean(dim=0)
    dist = -_pick(torch.log(torch.clamp(avg_softmax, min=1e-12)), targets)
    diff_elu = -torch.nn.functional.elu(-(undist - dist))
    regularizer = cls_var.mean(dim=1)
    loss = diff_elu * undist + undist + torch.exp(regularizer) - 1.0
    return batch_mean(loss), categorical_mutual_information(samples)


BAYES_VARIANTS = {
    "full": bayesian_cross_entropy,
    "simple": bayesian_cross_entropy_simple,
    "elu": bayesian_elu_cross_entropy,
}
