"""Fixed-shape training targets: RPN anchor targets and second-stage RoI
targets, for a batch of frames.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/targets.py (`_rank_within`,
`AnchorTargets`, `effective_rpn_overlaps`, `anchor_target`,
`expand_anchor_targets`, `ProposalTargets`, `proposal_target`), the image
and the lidar branch.  The JAX package vmaps each function over frames; here
the frame dimension is written out, so every argument and result has a
leading B.

Randomness enters as tensors: each function takes the uniform keys that the
JAX package draws inside it (`jax.random.uniform`), so a test can feed the
port the exact JAX draws and a trainer draws them from its own
torch.Generator.  Sampling without replacement keeps the k smallest keys of
the candidate set.  `jax.lax.top_k` and `jnp.argsort` put the lower lane
first among equal keys, so the port sorts with `torch.sort(stable=True)`,
never `torch.topk`, whose order among ties is unspecified: the inactive
slots of `anchor_target` carry such tied lanes.

Kept on purpose, as in the JAX package: IGNORE_DC has no effect on the
anchor targets (parity waiver 3), and the second-stage regression targets
are differentiable in the proposal boxes, so `loss_box` sends gradient
back into the RPN deltas through the proposals (ROADMAP fault F1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.ops.box_transform import (
    bbox_transform,
    lidar_3d_bbox_transform,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.iou import bbox_overlaps
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import span

_EPS = 1.1920929e-07  # float32 machine epsilon, the reference's floor on per-GT best IoU


def gather_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-frame gather along dim 1: x (B, N, ...) at idx (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def _rank_within(candidate: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Random rank (0 = first drawn) of each lane among the candidates of
    its row; non-candidates rank after every candidate.  candidate (..., n)
    bool, keys (..., n) uniform in [0, 1) -> (..., n) int64."""
    key = torch.where(candidate, keys, torch.full_like(keys, 2.0))
    perm = torch.sort(key, dim=-1, stable=True).indices
    lanes = torch.arange(key.shape[-1], device=key.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, lanes)


class AnchorTargets(NamedTuple):
    """Compact sampled-lane targets, K = fg quota + min(RPN_BATCHSIZE, N)."""

    sel: torch.Tensor  # (B, K) int64 sampled anchor lanes
    labels: torch.Tensor  # (B, K) float32 in {-1, 0, 1}; -1 = inactive slot
    bbox_targets: torch.Tensor  # (B, K, 4)
    bbox_inside_weights: torch.Tensor  # (B, K, 4)
    bbox_outside_weights: torch.Tensor  # (B, K, 4)


def effective_rpn_overlaps(cfg) -> tuple:
    """(positive, negative) RPN overlap thresholds: LIDAR.RPN_*_OVERLAP
    override TRAIN.RPN_*_OVERLAP for lidar nets when set (> 0)."""
    pos = cfg.train.rpn_positive_overlap
    neg = cfg.train.rpn_negative_overlap
    if cfg.net_type == "lidar":
        if cfg.lidar.rpn_positive_overlap > 0:
            pos = cfg.lidar.rpn_positive_overlap
        if cfg.lidar.rpn_negative_overlap > 0:
            neg = cfg.lidar.rpn_negative_overlap
    return pos, neg


def anchor_target(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    window: torch.Tensor,
    fg_keys: torch.Tensor,
    bg_keys: torch.Tensor,
    *,
    rpn_batchsize: int = 256,
    fg_fraction: float = 0.5,
    positive_overlap: float = 0.7,
    negative_overlap: float = 0.3,
    clobber_positives: bool = False,
) -> AnchorTargets:
    """RPN labels and regression targets.

    Args:
      anchors: (N, 4) the full anchor grid.
      gt_boxes: (B, G, 5) padded [x1, y1, x2, y2, cls]; gt_mask (B, G).
      window: (B, 4) [xmin, xmax, ymin, ymax]; anchors outside are ignored.
      fg_keys, bg_keys: (B, N) uniform draws ranking the fg and bg
        candidates (the JAX package's `uniform(rng_fg)`, `uniform(rng_bg)`).
    """
    b, n = fg_keys.shape
    device = anchors.device
    win = window[:, None, :]
    inside = (
        (anchors[:, 0] >= win[..., 0])
        & (anchors[:, 1] >= win[..., 2])
        & (anchors[:, 2] < win[..., 1])
        & (anchors[:, 3] < win[..., 3])
    )  # (B, N)
    any_gt = gt_mask.any(dim=1, keepdim=True)  # (B, 1)

    overlaps = bbox_overlaps(anchors, gt_boxes[..., :4])  # (B, N, G)
    overlaps = torch.where(gt_mask[:, None, :], overlaps, -1.0)
    argmax_overlaps = torch.argmax(overlaps, dim=2)  # first maximum, as jnp.argmax
    max_overlaps = torch.amax(overlaps, dim=2)

    with span("sync.anchor_target"):  # blocking copies: the host waits for the device
        one, zero, minus = (torch.tensor(v, device=device) for v in (1.0, 0.0, -1.0))
    negative = inside & (max_overlaps < negative_overlap)
    labels = torch.full((b, n), -1.0, device=device)
    if not clobber_positives:
        labels = torch.where(negative, zero, labels)
    # each GT's best inside anchor is fg; ties share the label
    col_overlaps = torch.where(inside[..., None], overlaps, -2.0)
    gt_max = torch.amax(col_overlaps, dim=1).clamp(min=_EPS)  # (B, G)
    is_gt_best = ((col_overlaps == gt_max[:, None, :]) & gt_mask[:, None, :]).any(dim=2)
    labels = torch.where(inside & is_gt_best, one, labels)
    labels = torch.where(inside & (max_overlaps >= positive_overlap), one, labels)
    if clobber_positives:
        labels = torch.where(negative, zero, labels)
    # a frame without GT: everything inside is background
    labels = torch.where(any_gt, labels, torch.where(inside, zero, minus))

    num_fg = min(int(fg_fraction * rpn_batchsize), n)
    k_bg = min(rpn_batchsize, n)
    with span("sync.anchor_target"):
        two = torch.tensor(2.0, device=device)
    fg_vals, fg_sel = torch.sort(torch.where(labels == 1.0, fg_keys, two), dim=1, stable=True)
    fg_vals, fg_sel = fg_vals[:, :num_fg], fg_sel[:, :num_fg]
    fg_valid = fg_vals < 1.5  # real candidates (key < 1)
    num_bg = rpn_batchsize - fg_valid.sum(dim=1, keepdim=True)
    bg_vals, bg_sel = torch.sort(torch.where(labels == 0.0, bg_keys, two), dim=1, stable=True)
    bg_vals, bg_sel = bg_vals[:, :k_bg], bg_sel[:, :k_bg]
    bg_valid = (bg_vals < 1.5) & (torch.arange(k_bg, device=device) < num_bg)

    sel = torch.cat([fg_sel, bg_sel], dim=1)  # (B, K)
    sel_labels = torch.cat(
        [torch.where(fg_valid, one, minus), torch.where(bg_valid, zero, minus)], dim=1
    )
    matched_gt = gather_lanes(gt_boxes[..., :4], gather_lanes(argmax_overlaps, sel))
    bbox_targets = bbox_transform(anchors[sel], matched_gt)
    bbox_targets = torch.where(any_gt[..., None], bbox_targets, zero)

    ones4 = torch.ones(4, device=device)
    bbox_inside_weights = (sel_labels == 1.0).float()[..., None] * ones4
    active = sel_labels >= 0.0
    uniform_w = 1.0 / torch.clamp(active.sum(dim=1).float(), min=1.0)
    bbox_outside_weights = torch.where(active, uniform_w[:, None], zero)[..., None] * ones4
    return AnchorTargets(sel, sel_labels, bbox_targets, bbox_inside_weights, bbox_outside_weights)


def expand_anchor_targets(at: AnchorTargets, n: int) -> AnchorTargets:
    """Scatter the compact targets back to all N lanes (for tests and debug
    draws).  Unsampled lanes get label -1 and zero targets and weights.
    Inactive slots carry arbitrary lanes that may collide with active ones,
    so the scatters are max / add, under which inactive writes are no-ops."""
    b = at.sel.shape[0]
    device = at.sel.device
    active = at.labels >= 0.0
    labels = torch.full((b, n), -1.0, device=device).scatter_reduce(
        1, at.sel, torch.where(active, at.labels, -1.0), reduce="amax"
    )
    w = active[..., None].float()
    idx4 = at.sel[..., None].expand(-1, -1, 4)

    def spread(x):
        return torch.zeros((b, n, 4), device=device).scatter_add(1, idx4, x * w)

    lanes = torch.arange(n, device=device).expand(b, n)
    return AnchorTargets(
        lanes, labels, spread(at.bbox_targets), spread(at.bbox_inside_weights),
        spread(at.bbox_outside_weights),
    )


class ProposalTargets(NamedTuple):
    """Sampled second-stage RoIs and their targets, S = ROI_BATCH_SIZE."""

    labels: torch.Tensor  # (B, S) int64, 0 = background
    rois: torch.Tensor  # (B, S, 4) x1y1x2y2
    bbox_targets: torch.Tensor  # (B, S, E * K)
    bbox_inside_weights: torch.Tensor  # (B, S, E * K)
    bbox_outside_weights: torch.Tensor  # (B, S, E * K)
    valid: torch.Tensor  # (B, S) bool, False only where a frame has no candidate
    anchors_3d: Optional[torch.Tensor] = None  # (B, S, 7) lidar: each RoI's 3D anchor


def proposal_target(
    rois: torch.Tensor,
    roi_valid: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    gt_boxes_dc: torch.Tensor,
    dc_mask: torch.Tensor,
    fg_keys: torch.Tensor,
    bg_keys: torch.Tensor,
    normalize_means: torch.Tensor,
    normalize_stds: torch.Tensor,
    *,
    num_classes: int,
    num_bbox_elem: int = 4,
    roi_batch_size: int = 256,
    fg_fraction: float = 0.25,
    fg_thresh: float = 0.6,
    bg_thresh_hi: float = 0.5,
    bg_thresh_lo: float = 0.0,
    ignore_dc: bool = False,
    dc_thresh: float = 0.5,
    anchors_3d: Optional[torch.Tensor] = None,
    true_gt_boxes: Optional[torch.Tensor] = None,
) -> ProposalTargets:
    """Sample ROI_BATCH_SIZE RoIs a frame and build per-class targets.

    Args:
      rois: (B, R, 4) proposals x1y1x2y2.  The sampled boxes and the
        regression targets stay differentiable in them; the IoUs that
        choose the samples are not.
      roi_valid: (B, R) proposal validity.
      gt_boxes (B, G, 5), gt_mask (B, G); gt_boxes_dc (B, D, 4), dc_mask
        (B, D) don't-care areas (used with ignore_dc).
      fg_keys, bg_keys: (B, R) uniform draws ranking the fg and bg
        candidates (the JAX package's `_rank_within` draws).
      normalize_means, normalize_stds: (E,) target normalization.
      anchors_3d, true_gt_boxes: lidar only (JAX :276-281, :339-349): the
        proposals' (B, R, 7) 3D anchors and the (B, G, 8) 7-DoF GT
        [xc, yc, zc, l, w, h, ry, cls].  The overlaps stay on the BEV boxes
        (rois, gt_boxes); the targets encode the matched 7-DoF GT against
        each sampled RoI and its anchor (lidar_3d_bbox_transform).

    When a frame has only fg candidates every slot is fg, drawn with
    replacement by wrapping the ranked list; likewise only bg.
    """
    b, r = roi_valid.shape
    s = roi_batch_size
    device = rois.device
    boxes = rois.detach()

    valid = roi_valid
    if ignore_dc:
        ov_dc = torch.where(dc_mask[:, None, :], bbox_overlaps(boxes, gt_boxes_dc), -1.0)
        valid = valid & (torch.amax(ov_dc, dim=2) < dc_thresh)

    overlaps = bbox_overlaps(boxes, gt_boxes[..., :4])
    overlaps = torch.where(gt_mask[:, None, :] & valid[..., None], overlaps, -1.0)
    max_overlaps = torch.amax(overlaps, dim=2)
    gt_assignment = torch.argmax(overlaps, dim=2)

    fg_cand = valid & (max_overlaps >= fg_thresh)
    bg_cand = valid & (max_overlaps < bg_thresh_hi) & (max_overlaps >= bg_thresh_lo)
    nfg = fg_cand.sum(dim=1, keepdim=True)  # (B, 1)
    nbg = bg_cand.sum(dim=1, keepdim=True)

    fg_quota = int(round(fg_fraction * s))
    fg_take = torch.where(
        (nfg > 0) & (nbg > 0),
        torch.clamp(nfg, max=fg_quota),
        torch.where(nfg > 0, s, 0),
    )

    lanes = torch.arange(r, device=device).expand(b, r)
    fg_list = torch.zeros_like(lanes).scatter_(1, _rank_within(fg_cand, fg_keys), lanes)
    bg_list = torch.zeros_like(lanes).scatter_(1, _rank_within(bg_cand, bg_keys), lanes)

    slot = torch.arange(s, device=device)
    is_fg_slot = slot < fg_take  # (B, S)
    fg_idx = gather_lanes(fg_list, torch.where(nfg > 0, slot % nfg.clamp(min=1), 0))
    bg_idx = gather_lanes(bg_list, torch.where(nbg > 0, (slot - fg_take) % nbg.clamp(min=1), 0))
    keep = torch.where(is_fg_slot, fg_idx, bg_idx)
    slot_valid = torch.where(is_fg_slot, nfg > 0, nbg > 0)

    assigned = gather_lanes(gt_assignment, keep)
    labels = gather_lanes(gt_boxes[..., 4], assigned)
    labels = torch.where(is_fg_slot & slot_valid, labels, 0.0).long()

    out_rois = gather_lanes(rois, keep)
    out_anchors = None
    if true_gt_boxes is not None:
        out_anchors = gather_lanes(anchors_3d, keep)
        matched = gather_lanes(true_gt_boxes[..., :7], assigned)
        targets = lidar_3d_bbox_transform(out_rois, out_anchors, matched)
    else:
        targets = bbox_transform(out_rois, gather_lanes(gt_boxes[..., :4], assigned))
    targets = (targets - normalize_means) / normalize_stds

    # the E-of-E*K per-class layout; a label outside [0, K) has no slot
    e, k = num_bbox_elem, num_classes
    cls_onehot = (labels[..., None] == torch.arange(k, device=device)).float()  # (B, S, K)
    fg_slot = (is_fg_slot & slot_valid & (labels > 0)).float()
    # a select, not a product with the one-hot: a degenerate RoI's target
    # (log of a width <= 0) is NaN, and NaN * 0 would reach the loss; XLA
    # folds the JAX package's product into this select in its jitted step
    on = (cls_onehot * fg_slot[..., None]) > 0
    bbox_targets = torch.where(on[..., None], targets[..., None, :], 0.0).reshape(b, s, k * e)
    bbox_inside = (cls_onehot[..., None] * fg_slot[..., None, None]) * torch.ones(e, device=device)
    bbox_inside = bbox_inside.reshape(b, s, k * e)
    bbox_outside = (bbox_inside > 0).float()
    return ProposalTargets(labels, out_rois, bbox_targets, bbox_inside, bbox_outside, slot_valid,
                           out_anchors)
