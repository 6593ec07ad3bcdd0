"""Faster R-CNN detector, C4: image serving and training, LiDAR BEV serving.

Port of faster_rcnn_pytorch_multimodal_tpu/models/detector.py without
uncertainty: `build_anchor_grid` (image and lidar branches), `feat_stride`,
`propose_one` (with TEST.MODE 'top') and `FasterRCNN.features`,
`rpn_scores`, `_anchors` (test and train phase), `_propose_batch`,
`pool_rois`, `roi_head`, `pooled_head`, `forward_test` and `forward_train`.
The JAX package's vmaps over frames become a batch dimension written out.

For LiDAR (NET_TYPE lidar) the input is the (B, Y, X, slices + 3) BEV raster,
the stem takes that many channels, the RPN regresses the BEV AABB footprints
of the 3D anchors, and the second stage decodes 7-DoF boxes against each
proposal's 3D anchor (`lidar_3d_bbox_transform_inv`, no clipping).  LiDAR
training is not ported yet.

`forward_train` runs in two stages that tests can drive apart: the RPN stage
(features, anchor targets, RPN losses) and the second stage, which takes the
proposals as anchor lanes (`src`, `valid`) and rebuilds their boxes from the
RPN deltas, so that pinning the lanes keeps the boxes' gradient path.  The
random draws of a step come in as a `TrainDraws`.

Layouts at the public methods are the JAX package's: NHWC images and
features, per-anchor lanes (B, N, .) in (y, x, a) order.  Inside, the conv
stacks run NCHW modules on channels_last tensors, so every NHWC <-> NCHW
switch is a view.

Dtypes follow cfg.compute_dtype as the JAX package's `cast_for_compute`
does: with bfloat16 the conv and linear stack holds bf16 parameters and
activations (the caller casts the module, see `build_detector`), frozen-BN
affines are computed in float32 and applied in bf16, and the RPN and head
outputs are cast to float32 before softmax and decode.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.models.heads import (
    DetectionPredictors,
    RPNHead,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.models.resnet import (
    FrozenBatchNorm,
    ResNetC4,
    ResNetLayer4,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.anchors import (
    anchors_3d_to_bev_aabb,
    generate_3d_anchors,
    generate_anchors_pre,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.box_transform import (
    bbox_transform_inv,
    clip_boxes,
    lidar_3d_bbox_transform_inv,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.losses import cross_entropy, smooth_l1_loss
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import roi_align_batched
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.targets import (
    AnchorTargets,
    ProposalTargets,
    anchor_target,
    effective_rpn_overlaps,
    gather_lanes,
    proposal_target,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def feat_stride(cfg: Config) -> int:
    """4 with FPN + multiscale pooling, else 16."""
    if cfg.use_fpn and cfg.pooling_mode == "multiscale":
        return 4
    return 16


def build_anchor_grid(
    cfg: Config, feat_h: int, feat_w: int, frame_scale: float
) -> Tuple[np.ndarray, np.ndarray]:
    """(anchors_bev (N, 4), anchors_3d (N, 7)) float32 in (y, x, a) order.

    Image nets: the 2D anchors and a zero (N, 7) placeholder.  Lidar nets:
    the 3D grid anchors and their BEV AABB footprints, with
    LIDAR.ANCHOR_SUBSTRIDE centers tiled every stride / sub voxels and the
    lanes reordered to (H, W, sub_y, sub_x, A), as the JAX package does."""
    stride = feat_stride(cfg)
    if cfg.net_type == "lidar":
        sub = cfg.lidar.anchor_substride
        if stride % sub:
            raise ValueError("LIDAR.ANCHOR_SUBSTRIDE must divide the feature stride")
        fine_stride = stride // sub
        fh, fw = feat_h * sub, feat_w * sub
        _, a3d = generate_3d_anchors(
            fh, fw, fine_stride,
            anchor_sizes_lwh=cfg.lidar.anchors,
            anchor_scales=cfg.lidar.anchor_scales,
            anchor_rotations=cfg.lidar.anchor_angles,
            voxel_len=cfg.lidar.voxel_len,
            frame_scale=frame_scale,
        )
        bev = anchors_3d_to_bev_aabb(a3d)
        # the 3D grid tiles [0, W*stride - 1), which drops the last row and
        # column when the fine stride is 1: pad them by edge replication
        a = cfg.num_anchors_3d // (sub * sub)  # anchors per fine cell
        full = fh * fw * a
        if bev.shape[0] != full:
            grid_w = int(np.ceil((fw * fine_stride - 1) / fine_stride))
            grid_h = int(np.ceil((fh * fine_stride - 1) / fine_stride))
            pad = ((0, fh - grid_h), (0, fw - grid_w), (0, 0), (0, 0))
            bev = np.pad(bev.reshape(grid_h, grid_w, a, 4), pad, mode="edge").reshape(full, 4)
            a3d = np.pad(a3d.reshape(grid_h, grid_w, a, 7), pad, mode="edge").reshape(full, 7)
        if sub > 1:
            n = feat_h * feat_w * sub * sub * a
            bev = bev.reshape(feat_h, sub, feat_w, sub, a, 4).transpose(0, 2, 1, 3, 4, 5).reshape(n, 4)
            a3d = a3d.reshape(feat_h, sub, feat_w, sub, a, 7).transpose(0, 2, 1, 3, 4, 5).reshape(n, 7)
        return bev, a3d
    anchors, n = generate_anchors_pre(
        feat_h,
        feat_w,
        stride,
        anchor_scales=cfg.anchor_scales,
        anchor_ratios=cfg.anchor_ratios,
        frame_scale=frame_scale,
    )
    return anchors, np.zeros((n, 7), np.float32)


def propose(
    fg_scores: torch.Tensor,
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    window: torch.Tensor,
    *,
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thresh: float,
    use_nms: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """RPN proposals for a batch of frames (the JAX `propose_one`, batched).

    fg_scores (B, N), deltas (B, N, 4), anchors (N, 4), window (B, 4).
    Returns (rois (B, P, 4), scores (B, P), valid (B, P), src_idx (B, P))
    with P = post_nms_top_n (or fewer lanes if fewer exist).  Pad slots hold
    the top-scored box (NMS pads with index 0), scored 0 and flagged
    invalid; src_idx is each proposal's anchor lane.  With use_nms=False
    (TEST.MODE 'top') the top post_nms_top_n lanes are returned unsuppressed.

    Ties in score keep the lower lane first, as `jax.lax.top_k` does.
    """
    boxes = clip_boxes(bbox_transform_inv(anchors, deltas), window)
    # stable: among equal scores the lower lane first, as jax.lax.top_k
    sorted_scores, order = torch.sort(fg_scores, dim=1, descending=True, stable=True)
    n = fg_scores.shape[1]
    if not use_nms:
        k = min(post_nms_top_n, n)
        order = order[:, :k]
        valid = torch.ones(order.shape, dtype=torch.bool, device=order.device)
        return gather_lanes(boxes, order), sorted_scores[:, :k], valid, order
    k = min(pre_nms_top_n, n)
    top_scores, order = sorted_scores[:, :k], order[:, :k]
    top_boxes = gather_lanes(boxes, order)
    keep, keep_valid = nms(top_boxes, top_scores, nms_thresh, post_nms_top_n)
    scores = torch.where(keep_valid, gather_lanes(top_scores, keep), torch.zeros((), device=keep.device))
    return gather_lanes(top_boxes, keep), scores, keep_valid, gather_lanes(order, keep)


class TrainDraws(NamedTuple):
    """The random numbers of one training step, drawn by the caller.

    anchor_fg / anchor_bg (B, N): uniform keys ranking the fg and bg anchor
    candidates (N anchors a frame).  roi_fg / roi_bg (B, R): uniform keys
    ranking the fg and bg proposal candidates (R proposals a frame, with
    the GT boxes when TRAIN.USE_GT).  gt_noise (B, G, 4): standard normals
    jittering the appended GT boxes (TRAIN.USE_GT_NOISE), else None."""

    anchor_fg: torch.Tensor
    anchor_bg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor
    gt_noise: Optional[torch.Tensor] = None


class TrainAux(NamedTuple):
    """What forward_train decided on the way to its losses."""

    anchor_targets: AnchorTargets
    proposal_src: Optional[torch.Tensor]  # (B, P) anchor lane of each proposal
    proposal_valid: Optional[torch.Tensor]  # (B, P)
    proposal_targets: Optional[ProposalTargets]


def check_supported(cfg: Config, training: bool = False) -> None:
    """Raise on configurations outside the ported paths."""
    uc = cfg.uc
    flags = (
        uc.en_rpn_bbox_aleatoric, uc.en_rpn_cls_aleatoric, uc.en_rpn_bbox_epistemic,
        uc.en_rpn_cls_epistemic, uc.en_bbox_aleatoric, uc.en_cls_aleatoric,
        uc.en_bbox_epistemic, uc.en_cls_epistemic,
    )
    problems = []
    lidar = cfg.net_type == "lidar"
    if cfg.net_type not in ("image", "lidar"):
        problems.append(f"NET_TYPE {cfg.net_type!r}")
    if lidar and training:
        problems.append("NET_TYPE 'lidar' in training (serving only)")
    if lidar and cfg.use_lidar_fpn:
        problems.append("USE_LIDAR_FPN")
    if lidar and cfg.test.rotated_nms:
        problems.append("TEST.ROTATED_NMS (rotated IoU kernel)")
    if cfg.use_fpn:
        problems.append("USE_FPN (C4 only)")
    if not cfg.net_variant.startswith("res"):
        problems.append(f"NET_VARIANT {cfg.net_variant!r} (ResNet only)")
    if any(flags):
        problems.append("UC.* flags (no uncertainty yet)")
    if cfg.compute_dtype not in _DTYPES:
        problems.append(f"COMPUTE_DTYPE {cfg.compute_dtype!r}")
    if (training or lidar) and cfg.resnet.fixed_blocks < 0:
        problems.append("RESNET.FIXED_BLOCKS -1 (live BN) in training or with lidar")
    if problems:
        raise NotImplementedError("not ported: " + ", ".join(problems))


class FasterRCNN(nn.Module):
    """C4 Faster R-CNN (ResNet backbone, stride-1 layer4 tail) on images or
    LiDAR BEV rasters."""

    def __init__(self, cfg: Config, num_classes: int):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.num_classes = num_classes
        num_layers = int(cfg.net_variant.replace("res", "") or 101)
        in_channels = cfg.lidar.num_channel if cfg.net_type == "lidar" else 3
        self.backbone = ResNetC4(num_layers, in_channels=in_channels)
        self.tail = ResNetLayer4(num_layers)
        self.rpn = RPNHead(ResNetC4.out_channels, cfg.rpn_channels, cfg.num_anchors)
        self.predictors = DetectionPredictors(
            ResNetLayer4.out_channels, num_classes, cfg.num_bbox_elem
        )
        self._anchor_cache: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.compute_dtype]

    # -- feature extraction ------------------------------------------------

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, H/16, W/16, 1024) NHWC C4 features.

        Integer frames are raw pixels, normalized here on the device with
        cfg.pixel_means/stddevs; float frames are taken as pre-normalized."""
        if not images.is_floating_point():
            means = torch.tensor(self.cfg.pixel_means, dtype=torch.float32, device=images.device)
            stds = torch.tensor(self.cfg.pixel_stddevs, dtype=torch.float32, device=images.device)
            images = (images.float() - means) / stds
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)  # channels_last view
        return self.backbone(x).permute(0, 2, 3, 1)

    # -- rpn ---------------------------------------------------------------

    def rpn_scores(self, rpn_feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """NHWC features -> fg_prob (B, N), logits (B, N, 2), deltas (B, N, 4)
        in float32 and (y, x, a) lane order."""
        cls, bbox = self.rpn(rpn_feat.permute(0, 3, 1, 2))
        b, _, h, w = cls.shape
        a = self.cfg.num_anchors
        # channel layout [bg x A | fg x A]: (h, w, 2, A) -> (h, w, A, 2)
        logits = cls.permute(0, 2, 3, 1).reshape(b, h, w, 2, a).float()
        logits = logits.transpose(3, 4).reshape(b, h * w * a, 2)
        fg_prob = torch.softmax(logits, dim=-1)[..., 1]
        deltas = bbox.permute(0, 2, 3, 1).reshape(b, h * w * a, 4).float()
        return {"logits": logits, "fg_prob": fg_prob, "deltas": deltas}

    def anchor_grids(
        self, feat_h: int, feat_w: int, device: torch.device, phase: str = "test",
        scale_idx: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(anchors_bev (N, 4), anchors_3d (N, 7)) of `phase` on `device`,
        built once per feature size.  Anchors scale with the frame scale:
        the phase's first scale, or with a multi-scale TRAIN.SCALES the
        minibatch's `scale_idx` (image nets only, as in the JAX package)."""
        scales = self.cfg.phase(phase).scales
        single = scale_idx is None or len(scales) == 1 or self.cfg.net_type == "lidar"
        scale = float(scales[0 if single else int(scale_idx)])
        key = (feat_h, feat_w, scale, str(device))
        if key not in self._anchor_cache:
            grids = build_anchor_grid(self.cfg, feat_h, feat_w, scale)
            self._anchor_cache[key] = tuple(torch.from_numpy(g).to(device) for g in grids)
        return self._anchor_cache[key]

    def anchors(
        self, feat_h: int, feat_w: int, device: torch.device, phase: str = "test",
        scale_idx: Optional[int] = None,
    ) -> torch.Tensor:
        """The (N, 4) anchors the RPN regresses (2D, or the BEV footprints
        of the 3D anchors); see anchor_grids."""
        return self.anchor_grids(feat_h, feat_w, device, phase, scale_idx)[0]

    def _propose_batch(self, rpn_out, anchors, window, phase: str = "test"):
        c = self.cfg.phase(phase)
        static = self.cfg.static
        pre_n = static.nms_pre_train if phase == "train" else static.nms_pre_test
        top_mode = phase == "test" and c.mode == "top"
        return propose(
            rpn_out["fg_prob"],
            rpn_out["deltas"],
            anchors,
            window,
            pre_nms_top_n=min(pre_n, c.rpn_pre_nms_top_n),
            post_nms_top_n=c.rpn_top_n if top_mode else c.rpn_post_nms_top_n,
            nms_thresh=c.rpn_nms_thresh,
            use_nms=not top_mode,
        )

    # -- roi head ----------------------------------------------------------

    def pool_rois(self, feat: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        """RoI-align (B, S, 4) rois from NHWC features -> (B, S, P, P, C)."""
        return roi_align_batched(
            feat.contiguous(), rois, 1.0 / feat_stride(self.cfg),
            output_size=self.cfg.pooling_size,
        )

    def pooled_head(self, pooled: torch.Tensor, b: int, s: int) -> Dict[str, torch.Tensor]:
        """layer4, spatial mean and predictors over pooled RoIs -> float32
        dict of (B, S, .)."""
        p, c = pooled.shape[-2], pooled.shape[-1]
        x = pooled.reshape(b * s, p, p, c).permute(0, 3, 1, 2)  # channels_last view
        fc7 = self.tail(x).mean(dim=(2, 3))
        out = self.predictors(fc7)
        return {k: v.reshape(b, s, -1).float() for k, v in out.items()}

    def roi_head(self, feat: torch.Tensor, rois: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.pooled_head(self.pool_rois(feat, rois), rois.shape[0], rois.shape[1])

    # -- inference ----------------------------------------------------------

    def forward_test(self, images: torch.Tensor, window: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, H, W, C) frames or BEV rasters, (B, 4) windows -> rois
        (B, S, 4), roi_scores, roi_valid (B, S), for lidar anchors_3d
        (B, S, 7) (each proposal's 3D anchor), and with the full net
        cls_prob (B, S, K) and per-class decoded boxes bbox_pred (B, S, EK):
        clipped image boxes, or 7-DoF lidar boxes in voxel units."""
        feat = self.features(images)
        rpn_out = self.rpn_scores(feat)
        anchors, anchors_3d = self.anchor_grids(feat.shape[1], feat.shape[2], feat.device)
        rois, roi_scores, roi_valid, src = self._propose_batch(rpn_out, anchors, window)
        out = {"rois": rois, "roi_scores": roi_scores, "roi_valid": roi_valid}
        roi_a3d = None
        if self.cfg.net_type == "lidar":
            roi_a3d = out["anchors_3d"] = anchors_3d[src]
        if not self.cfg.enable_full_net:
            return out

        out["cls_prob"], out["bbox_pred"] = self.classify_rois(feat, rois, window, roi_a3d)
        return out

    # -- training -------------------------------------------------------------

    def train_lane_counts(self, image_hw: Tuple[int, int], max_gt: int) -> Tuple[int, int]:
        """(N anchors, R proposals) a frame for training frames of
        `image_hw`: the sizes of TrainDraws' keys.  The C4 map is
        ceil(H / 16) x ceil(W / 16); R counts the appended GT boxes when
        TRAIN.USE_GT."""
        stride = feat_stride(self.cfg)
        n = -(-image_hw[0] // stride) * -(-image_hw[1] // stride) * self.cfg.num_anchors
        c = self.cfg.train
        r = min(self.cfg.static.nms_pre_train, c.rpn_pre_nms_top_n, n, c.rpn_post_nms_top_n)
        return n, r + (max_gt if c.use_gt else 0)

    def rpn_train(self, feat, gt_boxes, gt_mask, window, draws: TrainDraws, scale_idx=None):
        """RPN stage: scores, train-phase anchors, anchor targets and the two
        RPN losses, over the sampled anchor lanes only."""
        c = self.cfg
        rpn_out = self.rpn_scores(feat)
        anchors = self.anchors(feat.shape[1], feat.shape[2], feat.device, "train", scale_idx)
        if draws.anchor_fg.shape != rpn_out["fg_prob"].shape:
            raise ValueError(
                f"forward_train: anchor keys {tuple(draws.anchor_fg.shape)} for "
                f"{tuple(rpn_out['fg_prob'].shape)} anchor lanes"
            )
        pos_ov, neg_ov = effective_rpn_overlaps(c)
        at = anchor_target(
            anchors, gt_boxes, gt_mask, window, draws.anchor_fg, draws.anchor_bg,
            rpn_batchsize=c.train.rpn_batchsize, fg_fraction=c.train.rpn_fg_fraction,
            positive_overlap=pos_ov, negative_overlap=neg_ov,
            clobber_positives=c.train.rpn_clobber_positives,
        )
        active = (at.labels >= 0).float()
        losses = {
            "rpn_cross_entropy": cross_entropy(
                gather_lanes(rpn_out["logits"], at.sel).reshape(-1, 2),
                at.labels.clamp(min=0).long().reshape(-1),
                weights=active.reshape(-1),
            ),
            "rpn_loss_box": smooth_l1_loss(
                gather_lanes(rpn_out["deltas"], at.sel), at.bbox_targets,
                at.bbox_inside_weights, at.bbox_outside_weights, sum_axes=(1, 2),
            ),
        }
        return rpn_out, anchors, at, losses

    def select_proposals(self, rpn_out, anchors, window) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train-phase proposal lanes (B, P) and their validity: top
        min(NMS_PRE_TRAIN, RPN_PRE_NMS_TOP_N) scores -> NMS ->
        RPN_POST_NMS_TOP_N.  A choice, not a function of the boxes: no grad."""
        with torch.no_grad():
            _rois, _scores, valid, src = self._propose_batch(rpn_out, anchors, window, "train")
        return src, valid

    def second_stage_train(
        self, feat, rpn_out, anchors, window, proposal_src, proposal_valid,
        gt_boxes, gt_mask, gt_boxes_dc, dc_mask, draws: TrainDraws,
    ) -> Tuple[Dict[str, torch.Tensor], ProposalTargets]:
        """Second stage on given proposal lanes: their boxes, rebuilt from
        the RPN deltas (the gradient path of the JAX package's proposals),
        plus the GT boxes with TRAIN.USE_GT; RoI sampling and targets; the
        RoI head; the classification and box losses."""
        c = self.cfg
        rois = clip_boxes(
            bbox_transform_inv(anchors[proposal_src], gather_lanes(rpn_out["deltas"], proposal_src)),
            window,
        )
        valid = proposal_valid
        if c.train.use_gt:
            gt4 = gt_boxes[..., :4]
            if c.train.use_gt_noise:
                gw = gt_boxes[..., 2] - gt_boxes[..., 0]
                gh = gt_boxes[..., 3] - gt_boxes[..., 1]
                gt4 = gt4 + draws.gt_noise * 0.03 * torch.stack([gw, gh, gw, gh], dim=-1)
            rois = torch.cat([rois, gt4], dim=1)
            valid = torch.cat([valid, gt_mask], dim=1)
        if draws.roi_fg.shape != valid.shape:
            raise ValueError(
                f"forward_train: roi keys {tuple(draws.roi_fg.shape)} for "
                f"{tuple(valid.shape)} proposals"
            )
        device = rois.device
        pt = proposal_target(
            rois, valid, gt_boxes, gt_mask, gt_boxes_dc, dc_mask, draws.roi_fg, draws.roi_bg,
            torch.tensor(c.train.image_bbox_normalize_means, device=device),
            torch.tensor(c.train.image_bbox_normalize_stds, device=device),
            num_classes=self.num_classes, num_bbox_elem=c.num_bbox_elem,
            roi_batch_size=c.train.roi_batch_size, fg_fraction=c.train.fg_fraction,
            fg_thresh=c.train.fg_thresh, bg_thresh_hi=c.train.bg_thresh_hi,
            bg_thresh_lo=c.train.bg_thresh_lo, ignore_dc=c.train.ignore_dc,
            dc_thresh=c.train.dc_thresh,
        )
        det = self.roi_head(feat, pt.rois)
        b, s = pt.labels.shape
        losses = {
            "cross_entropy": cross_entropy(det["cls_score"].reshape(b * s, -1), pt.labels.reshape(-1)),
            "loss_box": smooth_l1_loss(
                det["bbox_pred"], pt.bbox_targets, pt.bbox_inside_weights,
                pt.bbox_outside_weights, sum_axes=(2,),
            ),
        }
        return losses, pt

    def forward_train(
        self,
        images: torch.Tensor,
        gt_boxes: torch.Tensor,
        gt_mask: torch.Tensor,
        window: torch.Tensor,
        draws: TrainDraws,
        gt_boxes_dc: Optional[torch.Tensor] = None,
        dc_mask: Optional[torch.Tensor] = None,
        scale_idx: Optional[int] = None,
        proposals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[Dict[str, torch.Tensor], TrainAux]:
        """Training forward -> (float32 loss dict with total_loss, TrainAux).

        images (B, H, W, 3), gt_boxes (B, G, 5), gt_mask (B, G), window
        (B, 4); gt_boxes_dc (B, D, 4) and dc_mask (B, D) feed TRAIN.IGNORE_DC.
        `proposals` = (src, valid) pins the second stage to those anchor
        lanes instead of the NMS's own choice."""
        b = gt_boxes.shape[0]
        if gt_boxes_dc is None:
            gt_boxes_dc = torch.zeros((b, 1, 4), device=gt_boxes.device)
            dc_mask = torch.zeros((b, 1), dtype=torch.bool, device=gt_boxes.device)
        feat = self.features(images)
        rpn_out, anchors, at, losses = self.rpn_train(
            feat, gt_boxes, gt_mask, window, draws, scale_idx)
        src = valid = pt = None
        if self.cfg.enable_full_net:
            src, valid = proposals if proposals is not None else self.select_proposals(
                rpn_out, anchors, window)
            det_losses, pt = self.second_stage_train(
                feat, rpn_out, anchors, window, src, valid, gt_boxes, gt_mask,
                gt_boxes_dc, dc_mask, draws)
            losses.update(det_losses)
        else:
            zero = torch.zeros((), device=feat.device)
            losses.update(cross_entropy=zero, loss_box=zero)
        losses["total_loss"] = (
            losses["rpn_cross_entropy"] + losses["rpn_loss_box"]
            + losses["cross_entropy"] + losses["loss_box"]
        )
        return losses, TrainAux(at, src, valid, pt)

    forward = forward_train

    def classify_rois(
        self, feat: torch.Tensor, rois: torch.Tensor, window: torch.Tensor,
        anchors_3d: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Second stage on (B, S, 4) rois -> class probabilities (B, S, K)
        and per-class boxes (B, S, EK); see decode."""
        return self.decode(self.roi_head(feat, rois), rois, window, anchors_3d)

    def decode(
        self, det: Dict[str, torch.Tensor], rois: torch.Tensor, window: torch.Tensor,
        anchors_3d: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """RoI-head outputs -> class probabilities and per-class boxes from
        the un-normalized deltas: image boxes clipped to each frame's window,
        or for lidar 7-DoF boxes decoded against the rois' (B, S, 7) 3D
        anchors, unclipped."""
        c = self.cfg
        b, s = rois.shape[:2]
        k, e = self.num_classes, c.num_bbox_elem
        lidar = c.net_type == "lidar"
        tc = c.train
        means = torch.tensor(
            tc.lidar_bbox_normalize_means if lidar else tc.image_bbox_normalize_means,
            device=rois.device)
        stds = torch.tensor(
            tc.lidar_bbox_normalize_stds if lidar else tc.image_bbox_normalize_stds,
            device=rois.device)
        deltas = (det["bbox_pred"].reshape(b, s, k, e) * stds + means).reshape(b, s, k * e)
        cls_prob = torch.softmax(det["cls_score"], dim=-1)
        if lidar:
            if anchors_3d is None:
                raise ValueError("decode: lidar rois need their (B, S, 7) 3D anchors")
            return cls_prob, lidar_3d_bbox_transform_inv(rois, anchors_3d, deltas)
        return cls_prob, clip_boxes(bbox_transform_inv(rois, deltas), window)


_TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


def _trunc_normal(w: torch.Tensor, std: float, g: torch.Generator) -> None:
    std = std / _TRUNC
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def init_params(model: FasterRCNN, generator: torch.Generator) -> FasterRCNN:
    """Random init with the JAX package's initializers, from `generator`:
    ResNet convs variance-scaling(2, fan_out, truncated normal), the stem
    conv lecun-normal, RPN and class heads normal(0.01), the box head
    normal(0.001), zero biases, identity frozen BN (residual-terminator
    scales zero when cfg.resnet.fixed_blocks == -1)."""
    zero_init_residual = model.cfg.resnet.fixed_blocks == -1
    head_std = {"rpn": 0.01, "predictors.cls_score_net": 0.01, "predictors.bbox_pred_net": 0.001}
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, FrozenBatchNorm):
                terminator = name.endswith("bn3") and zero_init_residual
                m.weight.fill_(0.0 if terminator else 1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                if name.startswith(("backbone", "tail")):
                    kh, kw = m.kernel_size
                    if name == "backbone.conv1":
                        std = math.sqrt(1.0 / (m.in_channels * kh * kw))
                    else:
                        std = math.sqrt(2.0 / (m.out_channels * kh * kw))
                    _trunc_normal(m.weight, std, generator)
                else:
                    std = next(v for k, v in head_std.items() if name.startswith(k))
                    m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def init_detector(cfg: Config, num_classes: int, seed: int = 0) -> FasterRCNN:
    """A randomly initialized float32 detector on the host.  Init draws from
    torch.Generator(seed), so the weights do not depend on the device."""
    with torch.device("meta"):
        model = FasterRCNN(cfg, num_classes)
    model = model.to_empty(device="cpu")
    return init_params(model, torch.Generator().manual_seed(seed))


def build_detector(
    cfg: Config, num_classes: int, device: torch.device | str, seed: int = 0
) -> FasterRCNN:
    """A randomly initialized detector on `device`, in cfg.compute_dtype,
    channels_last, in eval mode."""
    return to_device(init_detector(cfg, num_classes, seed), device)


def to_device(model: FasterRCNN, device: torch.device | str) -> FasterRCNN:
    """Move and cast a detector for inference: cfg.compute_dtype weights,
    channels_last convolutions, eval mode."""
    return model.to(
        device=device, dtype=model.compute_dtype, memory_format=torch.channels_last
    ).eval()
