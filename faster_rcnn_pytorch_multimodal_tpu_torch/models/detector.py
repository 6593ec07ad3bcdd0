"""Faster R-CNN detector: C4 (ResNet, VGG16 or MobileNetV1) and FPN
(ResNet), on images or LiDAR BEV rasters, serving and training, with
aleatoric and epistemic uncertainty on every path.

Port of faster_rcnn_pytorch_multimodal_tpu/models/detector.py:
`build_anchor_grid` (image and lidar branches), `feat_stride`,
`propose_one` (with TEST.MODE 'top') and `FasterRCNN.features`,
`rpn_scores`, `_anchors` (test and train phase), `_propose_batch`,
`pool_rois`, `roi_head`, `pooled_head`, `_rpn_uncertainties`,
`forward_test` and `forward_train`.  The JAX package's vmaps over frames
become a batch dimension written out.

Uncertainty (the UC.* flags).  Under epistemic uncertainty (det or RPN
stage) every Bottleneck drops at 0.5 (models.resnet.CheapDropout) and the
det head narrows to fc7 / 4 through its stacks; the aleatoric heads predict
log-variances, the RPN's by 1x1 convs on the RPN map.  Training runs the
dropout layers live (det-stage epistemic) and takes the Bayesian
cross-entropy (UC.BAYES_VARIANT) and the attenuated box losses.  Serving
keeps `features` deterministic and draws T = UC.E_NUM_SAMPLE Monte-Carlo
samples: of the tail and predictors over RoIs pooled once, and with RPN
epistemic of the backbone and RPN head; the samples are stacked along the
batch axis, MC_CHUNK at a time.  The class probabilities and deltas are the
samples' means, and the 8-key `uncertainties` and the `rpn_uncertainties`
dicts come out beside the detections.  All random numbers come from the
caller's UCDraws (a generator, or given masks and normals).

With USE_FPN (and POOLING_MODE multiscale) the backbone is ResNetPyramid and
an FPN, `features` returns the pyramid (p2, p3, p4, p5) as a tuple, the RPN
runs on p2 at stride 4, RoIs are pooled by multiscale RoI align and the tail
is the three-layer FCTail; everything else is the C4 code, uncertainty and
BEV rasters included (USE_LIDAR_FPN is accepted and read by nothing, as in
the JAX package).

NET_VARIANT vgg16 and mobile (JAX detector.py:331-369) put VGG16Head /
VGG16Tail (fc6, fc7 over each RoI flattened in (y, x, c) order) or
MobileNetV1Head / MobileNetV1Tail (then the spatial mean) in place of the
ResNet C4 backbone and tail; the fc7 width the epistemic stacks narrow from
is 4096 and 1024 (2048 for ResNet), whatever the depth multiplier.  Neither
takes FPN.

For LiDAR (NET_TYPE lidar) the input is the (B, Y, X, slices + 3) BEV raster,
the stem takes that many channels, the RPN regresses the BEV AABB footprints
of the 3D anchors, and the second stage decodes 7-DoF boxes against each
proposal's 3D anchor (`lidar_3d_bbox_transform_inv`, no clipping).  LiDAR
training (JAX :636-649, :680-754, :829-839) takes (B, G, 8) 7-DoF GT boxes:
both target layers compare BEV boxes (the GT's axis-aligned envelope), the
second-stage targets encode the 7-DoF GT against each RoI and its 3D anchor
(the true GT box is the anchor of an appended GT RoI), and the box loss
takes the sine of the heading residual with per-element weights.

`forward_train` runs in two stages that tests can drive apart: the RPN stage
(features, anchor targets, RPN losses) and the second stage, which takes the
proposals as anchor lanes (`src`, `valid`) and rebuilds their boxes from the
RPN deltas, so that pinning the lanes keeps the boxes' gradient path.  The
random draws of a step come in as a `TrainDraws`.

Layouts at the public methods are the JAX package's: NHWC images and
features, per-anchor lanes (B, N, .) in (y, x, a) order.  Inside, the conv
stacks run NCHW modules on channels_last tensors, so every NHWC <-> NCHW
switch is a view.

On a model axis (MESH.MODEL > 1, parallel/) the tail holds a rank's shard
of its channels and the predictors the rows of their input
(parallel.tensor_parallel); with MESH.SPATIAL the backbone runs on the
rank's rows of the frames (parallel.spatial).  The RPN, the anchors, the
proposals (K1), RoI align (K2, K2-FPN) and the targets run on the whole
maps, replicated over the model group with the same draws.

Dtypes follow cfg.compute_dtype as the JAX package's `cast_for_compute`
does: with bfloat16 the conv and linear stack holds bf16 parameters and
activations (the caller casts the module, see `build_detector`), frozen-BN
affines are computed in float32 and applied in bf16, and the RPN and head
outputs are cast to float32 before softmax and decode.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config
from faster_rcnn_pytorch_multimodal_tpu_torch.models.fpn import FPN
from faster_rcnn_pytorch_multimodal_tpu_torch.models.heads import (
    DetectionPredictors,
    FCTail,
    RPNHead,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.models.mobilenet import (
    MobileNetV1Head,
    MobileNetV1Tail,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.models.resnet import (
    STAGE_BLOCKS,
    BasicBlock,
    Bottleneck,
    CheapDropout,
    FrozenBatchNorm,
    LiveBatchNorm,
    ResNetC4,
    ResNetLayer4,
    ResNetPyramid,
    UCDraws,
    live_dropout,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.models.vgg16 import VGG16Head, VGG16Tail
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.anchors import (
    anchors_3d_to_bev_aabb,
    generate_3d_anchors,
    generate_anchors_pre,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.box_transform import (
    bbox_transform_inv,
    clip_boxes,
    lidar_3d_bbox_transform_inv,
    lidar_3d_uncertainty_transform_inv,
    uncertainty_transform_inv,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.iou import bbox_3d_to_bev_aabb
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.losses import (
    BAYES_VARIANTS,
    batch_mean,
    bayesian_cross_entropy,
    categorical_entropy,
    categorical_mutual_information,
    compute_bbox_var,
    cross_entropy,
    smooth_l1_loss,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.nms import nms
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (
    multiscale_roi_align_batched,
    roi_align_batched,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.targets import (
    AnchorTargets,
    ProposalTargets,
    anchor_target,
    effective_rpn_overlaps,
    gather_lanes,
    proposal_target,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh, spatial
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FPN_STRIDES = (4, 8, 16, 32)  # p2..p5
FPN_PLANES = 256
FC7_CHANNELS = 2048
# the nets beside ResNet, and the fc7 width their epistemic stacks narrow
# from (det_channels = fc7 / 4; 2048 for ResNet): the JAX package's
# fc7_channels, 1024 for MobileNet at any depth multiplier
FC7_WIDTH = {"vgg16": 4096, "mobile": 1024}
RESNET_DROP_RATE = 0.5  # the Bottlenecks' dropout under epistemic uncertainty
# Monte-Carlo samples stacked along the batch axis in one pass of the tail
# (or of the backbone, RPN epistemic).  A fixed chunk, not UC.E_MC_CHUNK(_TEST),
# which were sized for a TPU's 16 GB: ten res101 tail samples of 8 frames x
# 300 RoIs hold ~2.4 GB of bf16 pooled RoIs and ~4.8 GB per 2048-channel
# activation, well under an 80 GB card.
MC_CHUNK = 10
# NHWC features: the C4 map, or the FPN pyramid (p2, p3, p4, p5)
Features = Union[torch.Tensor, Tuple[torch.Tensor, ...]]
# (height, MESH.MODEL) pairs whose frames ran whole under MESH.SPATIAL, said once
_WHOLE_SAID: set = set()


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
    jittering the appended GT boxes (TRAIN.USE_GT_NOISE), else None.
    uc: with uncertainty, the step's dropout masks (the live layers under
    det-stage epistemic) and the normals of the Bayesian cross-entropies
    ('rpn_ce' (A, B * RPN_BATCHSIZE, 2), 'ce' (A, B * ROI_BATCH_SIZE, K),
    A = UC.A_NUM_CE_SAMPLE), given or drawn from its generator.  In a
    data-parallel step every key is a row block of the global batch's
    (training.solver.draw_train_keys; UCDraws' shard)."""

    anchor_fg: torch.Tensor
    anchor_bg: torch.Tensor
    roi_fg: torch.Tensor
    roi_bg: torch.Tensor
    gt_noise: Optional[torch.Tensor] = None
    uc: Optional[UCDraws] = None


class TrainAux(NamedTuple):
    """What forward_train decided on the way to its losses."""

    anchor_targets: AnchorTargets
    proposal_src: Optional[torch.Tensor]  # (B, P) anchor lane of each proposal
    proposal_valid: Optional[torch.Tensor]  # (B, P)
    proposal_targets: Optional[ProposalTargets]


def check_supported(cfg: Config, training: bool = False) -> None:
    """Raise on configurations outside the ported paths."""
    problems = []
    if cfg.net_type not in ("image", "lidar"):
        problems.append(f"NET_TYPE {cfg.net_type!r}")
    if cfg.use_fpn and cfg.pooling_mode != "multiscale":
        # the JAX package lays stride-16 anchors over the stride-4 p2 and
        # pools p2 at 1/16 (models/detector.py:197-201,508-510,573-580)
        problems.append(
            f"USE_FPN with POOLING_MODE {cfg.pooling_mode!r} (fault F2: anchors and "
            "pooling at stride 16 over the stride-4 p2; use POOLING_MODE multiscale)")
    variant = cfg.net_variant
    if variant in FC7_WIDTH:
        if cfg.use_fpn:
            problems.append(f"USE_FPN with NET_VARIANT {variant!r} (FPN is ResNet-only, "
                            "as the JAX package asserts)")
    elif not (variant.startswith("res") and _resnet_depth(variant) in STAGE_BLOCKS):
        problems.append(f"NET_VARIANT {variant!r}")
    if cfg.uc.bayes_variant not in BAYES_VARIANTS:
        problems.append(f"UC.BAYES_VARIANT {cfg.uc.bayes_variant!r}")
    if cfg.compute_dtype not in _DTYPES:
        problems.append(f"COMPUTE_DTYPE {cfg.compute_dtype!r}")
    if problems:
        raise NotImplementedError("not ported: " + ", ".join(problems))


def _resnet_depth(variant: str) -> int:
    digits = variant.replace("res", "")
    return int(digits) if digits.isdigit() else (101 if not digits else -1)


def uses_uncertainty(cfg: Config) -> bool:
    """Whether any of the eight UC.EN_* flags is set."""
    uc = cfg.uc
    return any((
        uc.en_rpn_bbox_aleatoric, uc.en_rpn_cls_aleatoric, uc.rpn_epistemic,
        uc.en_bbox_aleatoric, uc.en_cls_aleatoric, uc.any_epistemic,
    ))


class FasterRCNN(nn.Module):
    """Faster R-CNN on images or LiDAR BEV rasters: C4 with a ResNet
    (stride-1 layer4 tail), VGG16 or MobileNetV1 backbone, or FPN (ResNet
    pyramid backbone, FCTail)."""

    def __init__(self, cfg: Config, num_classes: int):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.num_classes = num_classes
        variant = cfg.net_variant
        in_channels = cfg.lidar.num_channel if cfg.net_type == "lidar" else 3
        # from scratch (FIXED_BLOCKS -1): live BN and zero-init residual
        # terminators, as the JAX package switches them (detector.py:372-406)
        live = cfg.resnet.fixed_blocks == -1
        uc = cfg.uc
        # the backbone and tail dropout feed both stages' MC sampling
        dropout_en = uc.any_epistemic or uc.rpn_epistemic
        bn = dict(live_bn=live, zero_init_residual=live,
                  drop_rate=RESNET_DROP_RATE if dropout_en else 0.0)
        if variant == "vgg16":
            self.backbone = VGG16Head(in_channels)
            self.tail = VGG16Tail(self.backbone.out_channels * cfg.pooling_size ** 2)
        elif variant == "mobile":
            self.backbone = MobileNetV1Head(cfg.mobilenet.depth_multiplier, in_channels)
            self.tail = MobileNetV1Tail(cfg.mobilenet.depth_multiplier)
        elif cfg.use_fpn:
            self.backbone = ResNetPyramid(_resnet_depth(variant), in_channels=in_channels, **bn)
            self.fpn = FPN(self.backbone.out_channels, FPN_PLANES)
            self.tail = FCTail(FPN_PLANES * cfg.pooling_size ** 2, FC7_CHANNELS)
        else:
            self.backbone = ResNetC4(_resnet_depth(variant), in_channels=in_channels, **bn)
            self.tail = ResNetLayer4(_resnet_depth(variant), **bn)
        if cfg.use_fpn:
            rpn_in, fc7 = FPN_PLANES, FC7_CHANNELS
        else:
            rpn_in, fc7 = self.backbone.out_channels, self.tail.out_channels
        # a tail over flat (y, x, c) RoIs (FCTail, fc6) or a conv tail
        self.flat_tail = cfg.use_fpn or variant == "vgg16"
        det_width = FC7_WIDTH.get(variant, FC7_CHANNELS)
        self.rpn = RPNHead(rpn_in, cfg.rpn_channels, cfg.num_anchors)
        a = cfg.num_anchors
        # per-anchor log-variances of the deltas and of the two logits, on the RPN map
        self.rpn_bbox_al_var_net = nn.Conv2d(rpn_in, a * 4, 1) if uc.en_rpn_bbox_aleatoric else None
        self.rpn_cls_al_var_net = nn.Conv2d(rpn_in, a * 2, 1) if uc.en_rpn_cls_aleatoric else None
        self.predictors = DetectionPredictors(
            fc7, num_classes, cfg.num_bbox_elem,
            det_channels=det_width // 4 if dropout_en else det_width,
            en_cls_aleatoric=uc.en_cls_aleatoric, en_bbox_aleatoric=uc.en_bbox_aleatoric,
            en_cls_epistemic=uc.en_cls_epistemic, en_bbox_epistemic=uc.en_bbox_epistemic,
            lidar_bn=cfg.net_type == "lidar" and uc.any_epistemic,
        )
        for name, m in self.named_modules():
            if isinstance(m, CheapDropout):
                m.path = name
        self._anchor_cache: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.rows_split = False  # whether the last `features` ran on row slabs

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.compute_dtype]

    # -- feature extraction ------------------------------------------------

    def features(self, images: torch.Tensor) -> Features:
        """(B, H, W, 3) images -> NHWC features: the (B, H/16, W/16, C) C4
        map (C = backbone.out_channels: 1024, 256 for res18/34, 512 for
        VGG16 and MobileNet at depth multiplier 1), or with
        FPN the tuple (p2, p3, p4, p5) of (B, H/s, W/s, 256) maps at strides
        4, 8, 16, 32.

        With live BN (FIXED_BLOCKS -1) the model's mode decides: train mode
        normalizes with the batch's statistics (the C4 tail's with those of
        every pooled RoI of the batch) and moves the running statistics,
        eval mode uses them.

        Integer frames are raw pixels, normalized here on the device with
        cfg.pixel_means/stddevs; float frames are taken as pre-normalized.

        On a model axis with MESH.SPATIAL (a rank of a data_parallel block)
        each rank of the model group runs the backbone on its rows of the
        normalized frames and the backbone's maps are gathered whole
        (parallel.spatial), where H divides by the axis, as JAX's
        shard_batch splits H only then; else the frames stay whole (said
        once).  `rows_split` records which it was, for the optimizer.  The
        FPN, the RPN and everything after run on the whole maps."""
        if not images.is_floating_point():
            with span("sync.pixel_norm"):  # blocking copies: the host waits for the device
                means = torch.tensor(self.cfg.pixel_means, dtype=torch.float32,
                                     device=images.device)
                stds = torch.tensor(self.cfg.pixel_stddevs, dtype=torch.float32,
                                    device=images.device)
            images = (images.float() - means) / stds
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)  # channels_last view
        dp = mesh.active()
        self.rows_split = False
        if dp is not None and dp.spatial:
            h, m = x.shape[2], dp.model
            if h % m == 0:
                self.rows_split = True
                with spatial.row_split(dp, h, x.shape[3]) as split:
                    lo, hi = split.rows(h)
                    out = self.backbone(x[:, :, lo:hi])
                    out = (tuple(split.gather(o) for o in out) if isinstance(out, tuple)
                           else split.gather(out))
            else:
                if (h, m) not in _WHOLE_SAID:
                    _WHOLE_SAID.add((h, m))
                    print(f"MESH.SPATIAL: {h} rows do not divide by MESH.MODEL {m}: the "
                          "backbone runs on the whole frames", flush=True)
                out = self.backbone(x)
        else:
            out = self.backbone(x)
        if self.cfg.use_fpn:
            return tuple(p.permute(0, 2, 3, 1) for p in self.fpn(*out))
        return out.permute(0, 2, 3, 1)

    @staticmethod
    def rpn_map(feats: Features) -> torch.Tensor:
        """The map the RPN runs on: the C4 map, or p2 of a pyramid."""
        return feats[0] if isinstance(feats, tuple) else feats

    # -- rpn ---------------------------------------------------------------

    def rpn_scores(self, feats: Features) -> Dict[str, torch.Tensor]:
        """NHWC features (or a pyramid: its p2) -> fg_prob (B, N), logits
        (B, N, 2), deltas (B, N, 4) in float32 and (y, x, a) lane order;
        with RPN aleatoric uncertainty also bbox_al_var (B, N, 4) and
        cls_al_var (B, N, 2), the log-variances of the deltas and logits."""
        x = self.rpn_map(feats).permute(0, 3, 1, 2)
        cls, bbox = self.rpn(x)
        b, _, h, w = cls.shape
        a = self.cfg.num_anchors

        def two_class(t):  # channel layout [bg x A | fg x A]: (h, w, 2, A) -> (h, w, A, 2)
            t = t.permute(0, 2, 3, 1).reshape(b, h, w, 2, a).float()
            return t.transpose(3, 4).reshape(b, h * w * a, 2)

        logits = two_class(cls)
        fg_prob = torch.softmax(logits, dim=-1)[..., 1]
        deltas = bbox.permute(0, 2, 3, 1).reshape(b, h * w * a, 4).float()
        out = {"logits": logits, "fg_prob": fg_prob, "deltas": deltas}
        if self.rpn_bbox_al_var_net is not None:
            var = self.rpn_bbox_al_var_net(x)
            out["bbox_al_var"] = var.permute(0, 2, 3, 1).reshape(b, h * w * a, 4).float()
        if self.rpn_cls_al_var_net is not None:
            out["cls_al_var"] = two_class(self.rpn_cls_al_var_net(x))
        return out

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
        with span("det.proposals"):  # `propose` looked up at each call: benchmarks rebind it
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

    def pool_rois(self, feat: Features, rois: torch.Tensor) -> torch.Tensor:
        """RoI-align (B, S, 4) rois from NHWC features -> (B, S, P, P, C);
        from a pyramid, each RoI from its LevelMapper level."""
        if self.cfg.use_fpn:
            return multiscale_roi_align_batched(
                tuple(f.contiguous() for f in feat), rois, FPN_STRIDES,
                output_size=self.cfg.pooling_size,
            )
        return roi_align_batched(
            feat.contiguous(), rois, 1.0 / feat_stride(self.cfg),
            output_size=self.cfg.pooling_size,
        )

    def pooled_head(self, pooled: torch.Tensor, b: int, s: int) -> Dict[str, torch.Tensor]:
        """Tail and predictors over pooled RoIs -> float32 dict of (B, S, .):
        a conv tail (C4 layer4, MobileNet's layers 12-13) and the spatial
        mean, or a flat tail (the FPN's FCTail, VGG16's fc6/fc7) over each
        RoI flattened in (y, x, c) order.  In a sharded tail (a model axis:
        parallel.tensor_parallel) the pooled RoIs, whole on every rank, enter
        it through copy_to_model, fc7 comes out as the rank's channels and
        the predictors sum their partial products over the model group."""
        p, c = pooled.shape[-2], pooled.shape[-1]
        if self.flat_tail:
            fc7 = self.tail(pooled.reshape(b * s, p * p * c))
        else:
            x = pooled.reshape(b * s, p, p, c).permute(0, 3, 1, 2)  # channels_last view
            fc7 = self.tail(x).mean(dim=(2, 3))
        out = self.predictors(fc7)
        return {k: v.reshape(b, s, -1).float() for k, v in out.items()}

    def roi_head(self, feat: Features, rois: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.pooled_head(self.pool_rois(feat, rois), rois.shape[0], rois.shape[1])

    # -- inference ----------------------------------------------------------

    def _mc_samples(self, draws: UCDraws, modules, x: torch.Tensor, fn):
        """fn over T = UC.E_NUM_SAMPLE Monte-Carlo samples of `x` (B, ...),
        the dropout layers of `modules` live: MC_CHUNK samples at a time
        stacked along the batch axis, sample-major (draws.samples says
        which).  fn(stacked (n * B, ...)) -> dict of (n * B, ...); returns
        the dict of (T, B, ...)."""
        t, b = self.cfg.uc.e_num_sample, x.shape[0]
        outs = []
        with live_dropout(draws, *modules):
            for t0 in range(0, t, MC_CHUNK):
                n = min(MC_CHUNK, t - t0)
                draws.samples = range(t0, t0 + n)
                stacked = x.unsqueeze(0).expand((n,) + x.shape).reshape((n * b,) + x.shape[1:])
                outs.append({k: v.reshape((n, b) + v.shape[1:]) for k, v in fn(stacked).items()})
        draws.samples = range(1)
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def rpn_uncertainties(
        self, rpn_out: Dict[str, torch.Tensor], rpn_samples: Optional[Dict[str, torch.Tensor]],
        rois: torch.Tensor, src: torch.Tensor, draws: UCDraws,
    ) -> Dict[str, torch.Tensor]:
        """The RPN stage's uncertainties at the proposals (B, P), gathered at
        each proposal's anchor lane `src`: with cls aleatoric a_entropy,
        a_mutual_info over UC.A_NUM_CE_SAMPLE logit draws (normals 'rpn_ce',
        (A, B, P, 2)) and a_cls_var; with bbox aleatoric a_bbox_var (the
        image inverse transform, also on lidar, as the JAX package does);
        from the T RPN samples e_entropy, e_mutual_info, e_cls_var and
        e_bbox_var (in delta space)."""
        uc = self.cfg.uc
        un: Dict[str, torch.Tensor] = {}
        b, p = src.shape
        if uc.en_rpn_cls_aleatoric:
            logits = gather_lanes(rpn_out["logits"], src)
            cls_var = torch.exp(gather_lanes(rpn_out["cls_al_var"], src))
            noise = draws.normal("rpn_ce", (uc.a_num_ce_sample,) + tuple(logits.shape), logits.device)
            samples = logits[None] + noise * torch.sqrt(cls_var)[None]
            un["a_entropy"] = categorical_entropy(torch.softmax(samples, dim=-1).mean(dim=0))
            un["a_mutual_info"] = categorical_mutual_information(
                samples.reshape(uc.a_num_ce_sample, b * p, 2)).reshape(b, p)
            un["a_cls_var"] = cls_var
        if uc.en_rpn_bbox_aleatoric:
            a_var = torch.exp(gather_lanes(rpn_out["bbox_al_var"], src))
            un["a_bbox_var"] = uncertainty_transform_inv(rois, torch.sqrt(a_var))
        if rpn_samples is not None:
            t = rpn_samples["fg_prob"].shape[0]

            def sel_t(x):  # (T, B, N, .) -> (T, B, P, .)
                return torch.stack([gather_lanes(xi, src) for xi in x])

            if uc.en_rpn_cls_epistemic:
                logits_t = sel_t(rpn_samples["logits"])
                sm = torch.softmax(logits_t, dim=-1)
                un["e_entropy"] = categorical_entropy(sm.mean(dim=0))
                un["e_mutual_info"] = categorical_mutual_information(
                    logits_t.reshape(t, b * p, 2)).reshape(b, p)
                un["e_cls_var"] = compute_bbox_var(sm)
            if uc.en_rpn_bbox_epistemic:
                un["e_bbox_var"] = compute_bbox_var(sel_t(rpn_samples["deltas"]))
        return un

    def det_uncertainties(
        self, det: Dict[str, torch.Tensor], rois: torch.Tensor,
        anchors_3d: Optional[torch.Tensor], draws: UCDraws,
    ) -> Dict[str, torch.Tensor]:
        """The detection stage's 8-key uncertainties from the head's T
        samples `det` (dict of (T, B, S, .); T = 1 without epistemic): with
        cls aleatoric a_entropy, a_mutual_info over UC.A_NUM_CE_SAMPLE draws
        of sample 0's logits (normals 'ce', (A, B, S, K)) and a_cls_var; with
        bbox aleatoric a_bbox_var through the inverse transform; with cls
        epistemic e_entropy, e_mutual_info and e_cls_var over the T
        softmaxes; with bbox epistemic e_bbox_var over the T deltas,
        inverse-transformed under UC.EN_BBOX_EPISTEMIC_INV_TRANSFORM."""
        uc = self.cfg.uc
        lidar = self.cfg.net_type == "lidar"
        cls_scores, bbox_preds = det["cls_score"], det["bbox_pred"]
        t, b, s, k = cls_scores.shape

        def inv(std):
            if lidar:
                return lidar_3d_uncertainty_transform_inv(rois, anchors_3d, std)
            return uncertainty_transform_inv(rois, std)

        un: Dict[str, torch.Tensor] = {}
        if uc.en_cls_aleatoric:
            cls_var = torch.exp(det["cls_al_var"][0])
            noise = draws.normal("ce", (uc.a_num_ce_sample, b, s, k), cls_scores.device)
            samples = cls_scores[0][None] + noise * torch.sqrt(cls_var)[None]
            un["a_entropy"] = categorical_entropy(torch.softmax(samples, dim=-1).mean(dim=0))
            un["a_mutual_info"] = categorical_mutual_information(
                samples.reshape(uc.a_num_ce_sample, b * s, k)).reshape(b, s)
            un["a_cls_var"] = cls_var
        if uc.en_bbox_aleatoric:
            un["a_bbox_var"] = inv(torch.sqrt(torch.exp(det["bbox_al_var"][0])))
        if uc.en_cls_epistemic:
            sm = torch.softmax(cls_scores, dim=-1)
            un["e_entropy"] = categorical_entropy(sm.mean(dim=0))
            un["e_mutual_info"] = categorical_mutual_information(
                cls_scores.reshape(t, b * s, k)).reshape(b, s)
            un["e_cls_var"] = compute_bbox_var(sm)
        if uc.en_bbox_epistemic:
            e_var = compute_bbox_var(bbox_preds)
            un["e_bbox_var"] = inv(torch.sqrt(e_var)) if uc.en_bbox_epistemic_inv_transform else e_var
        return un

    def forward_test(
        self, images: torch.Tensor, window: torch.Tensor, draws: Optional[UCDraws] = None,
    ) -> Dict[str, torch.Tensor]:
        """(B, H, W, C) frames or BEV rasters, (B, 4) windows -> rois
        (B, S, 4), roi_scores, roi_valid (B, S), for lidar anchors_3d
        (B, S, 7) (each proposal's 3D anchor), and with the full net
        cls_prob (B, S, K) and per-class decoded boxes bbox_pred (B, S, EK):
        clipped image boxes, or 7-DoF lidar boxes in voxel units.

        With uncertainty also `rpn_uncertainties` (a dict of (B, S, .)) and,
        with the full net, `uncertainties` (det_uncertainties); under
        epistemic uncertainty cls_prob and the deltas are the means over
        the MC samples.  `draws` gives the masks and normals; without it a
        generator seeded 0 on the frames' device does (the JAX package's
        fixed key when no dropout rng is given)."""
        c, uc = self.cfg, self.cfg.uc
        with_uc = uses_uncertainty(c)
        if with_uc and draws is None:
            draws = UCDraws(torch.Generator(device=images.device).manual_seed(0))
        with span("det.backbone"):
            feat = self.features(images)
        rpn_samples = None
        with span("det.rpn"):
            if uc.rpn_epistemic:
                # T samples of the backbone and RPN head with live dropout; the
                # proposals come from the mean scores and deltas
                rpn_samples = self._mc_samples(
                    draws, (self.backbone,), images, lambda x: self.rpn_scores(self.features(x)))
                rpn_out = {"fg_prob": rpn_samples["fg_prob"].mean(dim=0),
                           "deltas": rpn_samples["deltas"].mean(dim=0)}
                for k in ("logits", "bbox_al_var", "cls_al_var"):
                    if k in rpn_samples:
                        rpn_out[k] = rpn_samples[k][0]
            else:
                rpn_out = self.rpn_scores(feat)
        m = self.rpn_map(feat)
        anchors, anchors_3d = self.anchor_grids(m.shape[1], m.shape[2], m.device)
        rois, roi_scores, roi_valid, src = self._propose_batch(rpn_out, anchors, window)
        out = {"rois": rois, "roi_scores": roi_scores, "roi_valid": roi_valid}
        roi_a3d = None
        if c.net_type == "lidar":
            roi_a3d = out["anchors_3d"] = anchors_3d[src]
        if with_uc:
            out["rpn_uncertainties"] = self.rpn_uncertainties(rpn_out, rpn_samples, rois, src, draws)
        if not c.enable_full_net:
            return out
        with span("det.roi_head"):
            if not with_uc:
                out["cls_prob"], out["bbox_pred"] = self.classify_rois(feat, rois, window, roi_a3d)
                return out

            if uc.any_epistemic:
                # RoIs pooled once (K2 launches once a batch); only the tail and
                # the predictors run for each sample
                s = rois.shape[1]
                det = self._mc_samples(draws, (self.tail, self.predictors),
                                       self.pool_rois(feat, rois),
                                       lambda x: self.pooled_head(x, x.shape[0], s))
            else:
                det = {k: v[None] for k, v in self.roi_head(feat, rois).items()}
            out["cls_prob"] = torch.softmax(det["cls_score"], dim=-1).mean(dim=0)
            out["bbox_pred"] = self.decode_boxes(det["bbox_pred"].mean(dim=0), rois, window,
                                                 roi_a3d)
            out["uncertainties"] = self.det_uncertainties(det, rois, roi_a3d, draws)
            return out

    # -- training -------------------------------------------------------------

    def feature_hw(self, image_hw: Tuple[int, int]) -> Tuple[int, int]:
        """The RPN map's size for frames (or BEV rasters) of `image_hw`:
        ceil(H / s) x ceil(W / s) at the feature stride s (16 for C4, 4 for
        p2 of FPN), or floor(H / 16) x floor(W / 16) for VGG16, whose four
        2x2 max pools floor."""
        stride = feat_stride(self.cfg)
        if self.cfg.net_variant == "vgg16":
            return image_hw[0] // stride, image_hw[1] // stride
        return -(-image_hw[0] // stride), -(-image_hw[1] // stride)

    def train_lane_counts(self, image_hw: Tuple[int, int], max_gt: int) -> Tuple[int, int]:
        """(N anchors, R proposals) a frame for training frames of
        `image_hw`: the sizes of TrainDraws' keys.  N is num_anchors lanes
        (for lidar num_anchors_3d, ANCHOR_SUBSTRIDE's sub-cells included) at
        each cell of the RPN map (feature_hw); R counts the appended GT
        boxes when TRAIN.USE_GT."""
        fh, fw = self.feature_hw(image_hw)
        n = fh * fw * self.cfg.num_anchors
        c = self.cfg.train
        r = min(self.cfg.static.nms_pre_train, c.rpn_pre_nms_top_n, n, c.rpn_post_nms_top_n)
        return n, r + (max_gt if c.use_gt else 0)

    def gt_bev(self, gt_boxes: torch.Tensor) -> torch.Tensor:
        """The (B, G, 5) boxes [x1, y1, x2, y2, cls] the target layers compare
        with: image GT as it is; for lidar the BEV envelope of the (B, G, 8)
        7-DoF GT [xc, yc, zc, l, w, h, ry, cls] and its class."""
        if self.cfg.net_type != "lidar":
            return gt_boxes
        return torch.cat([bbox_3d_to_bev_aabb(gt_boxes[..., :7]), gt_boxes[..., 7:8]], dim=-1)

    def rpn_train(self, feat, gt_boxes, gt_mask, window, draws: TrainDraws, scale_idx=None):
        """RPN stage: scores, the train-phase anchor grids (BEV, 3D), anchor
        targets and the two RPN losses, over the sampled anchor lanes only."""
        c = self.cfg
        rpn_out = self.rpn_scores(feat)
        m = self.rpn_map(feat)
        grids = self.anchor_grids(m.shape[1], m.shape[2], m.device, "train", scale_idx)
        anchors = grids[0]
        if draws.anchor_fg.shape != rpn_out["fg_prob"].shape:
            raise ValueError(
                f"forward_train: anchor keys {tuple(draws.anchor_fg.shape)} for "
                f"{tuple(rpn_out['fg_prob'].shape)} anchor lanes"
            )
        pos_ov, neg_ov = effective_rpn_overlaps(c)
        at = anchor_target(
            anchors, self.gt_bev(gt_boxes), gt_mask, window, draws.anchor_fg, draws.anchor_bg,
            rpn_batchsize=c.train.rpn_batchsize, fg_fraction=c.train.rpn_fg_fraction,
            positive_overlap=pos_ov, negative_overlap=neg_ov,
            clobber_positives=c.train.rpn_clobber_positives,
        )
        active = (at.labels >= 0).float().reshape(-1)
        logits = gather_lanes(rpn_out["logits"], at.sel).reshape(-1, 2)
        labels = at.labels.clamp(min=0).long().reshape(-1)
        uc = c.uc
        if uc.en_rpn_cls_aleatoric:
            # the Bayesian CE over the sampled lanes, the ignored ones at weight 0
            var = torch.exp(gather_lanes(rpn_out["cls_al_var"], at.sel).reshape(-1, 2))
            normals = self._uc_draws(draws).normal(
                "rpn_ce", (uc.a_num_ce_sample,) + tuple(logits.shape), logits.device)
            rpn_ce, _mi = bayesian_cross_entropy(logits, var, labels, normals, weights=active)
        else:
            rpn_ce = cross_entropy(logits, labels, weights=active)
        losses = {
            "rpn_cross_entropy": rpn_ce,
            "rpn_loss_box": smooth_l1_loss(
                gather_lanes(rpn_out["deltas"], at.sel), at.bbox_targets,
                at.bbox_inside_weights, at.bbox_outside_weights,
                bbox_var=(gather_lanes(rpn_out["bbox_al_var"], at.sel)
                          if uc.en_rpn_bbox_aleatoric else None),
                sum_axes=(1, 2),
            ),
        }
        return rpn_out, grids, at, losses

    @staticmethod
    def _uc_draws(draws: TrainDraws) -> UCDraws:
        if draws.uc is None:
            raise ValueError("forward_train: uncertainty needs TrainDraws.uc (its dropout masks "
                             "and normals, or a generator)")
        return draws.uc

    def select_proposals(self, rpn_out, anchors, window) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train-phase proposal lanes (B, P) and their validity: top
        min(NMS_PRE_TRAIN, RPN_PRE_NMS_TOP_N) scores -> NMS ->
        RPN_POST_NMS_TOP_N.  A choice, not a function of the boxes: no grad."""
        with torch.no_grad():
            _rois, _scores, valid, src = self._propose_batch(rpn_out, anchors, window, "train")
        return src, valid

    def sample_rois(
        self, rpn_out, grids, window, proposal_src, proposal_valid,
        gt_boxes, gt_mask, gt_boxes_dc, dc_mask, draws: TrainDraws,
    ) -> ProposalTargets:
        """The second stage's RoIs and targets on given proposal lanes:
        their boxes, rebuilt from the RPN deltas (the gradient path of the
        JAX package's proposals), plus the GT boxes with TRAIN.USE_GT; RoI
        sampling and targets.  grids: the train-phase (BEV, 3D) anchor
        grids; for lidar each proposal's 3D anchor is its lane's, an
        appended GT box's its true 7-DoF box."""
        c = self.cfg
        lidar = c.net_type == "lidar"
        anchors, anchors_3d = grids
        gt_bev = self.gt_bev(gt_boxes)
        rois = clip_boxes(
            bbox_transform_inv(anchors[proposal_src], gather_lanes(rpn_out["deltas"], proposal_src)),
            window,
        )
        valid = proposal_valid
        roi_a3d = anchors_3d[proposal_src] if lidar else None
        if c.train.use_gt:
            gt4 = gt_bev[..., :4]
            if c.train.use_gt_noise:
                gw = gt_bev[..., 2] - gt_bev[..., 0]
                gh = gt_bev[..., 3] - gt_bev[..., 1]
                gt4 = gt4 + draws.gt_noise * 0.03 * torch.stack([gw, gh, gw, gh], dim=-1)
            rois = torch.cat([rois, gt4], dim=1)
            valid = torch.cat([valid, gt_mask], dim=1)
            if lidar:
                roi_a3d = torch.cat([roi_a3d, gt_boxes[..., :7]], dim=1)
        if draws.roi_fg.shape != valid.shape:
            raise ValueError(
                f"forward_train: roi keys {tuple(draws.roi_fg.shape)} for "
                f"{tuple(valid.shape)} proposals"
            )
        device = rois.device
        tc = c.train
        with span("sync.roi_norm"):  # blocking copies: the host waits for the device
            means = torch.tensor(
                tc.lidar_bbox_normalize_means if lidar else tc.image_bbox_normalize_means,
                device=device)
            stds = torch.tensor(
                tc.lidar_bbox_normalize_stds if lidar else tc.image_bbox_normalize_stds,
                device=device)
        return proposal_target(
            rois, valid, gt_bev, gt_mask, gt_boxes_dc, dc_mask, draws.roi_fg, draws.roi_bg,
            means, stds,
            num_classes=self.num_classes, num_bbox_elem=c.num_bbox_elem,
            roi_batch_size=tc.roi_batch_size, fg_fraction=tc.fg_fraction,
            fg_thresh=tc.fg_thresh, bg_thresh_hi=tc.bg_thresh_hi,
            bg_thresh_lo=tc.bg_thresh_lo, ignore_dc=tc.ignore_dc,
            dc_thresh=tc.dc_thresh, anchors_3d=roi_a3d,
            true_gt_boxes=gt_boxes if lidar else None,
        )

    def second_stage_train(
        self, feat, rpn_out, grids, window, proposal_src, proposal_valid,
        gt_boxes, gt_mask, gt_boxes_dc, dc_mask, draws: TrainDraws,
    ) -> Tuple[Dict[str, torch.Tensor], ProposalTargets]:
        """Second stage on given proposal lanes: sample_rois, the RoI head,
        the classification and box losses."""
        c = self.cfg
        lidar = c.net_type == "lidar"
        with span("det.roi_targets"):
            pt = self.sample_rois(rpn_out, grids, window, proposal_src, proposal_valid, gt_boxes,
                                  gt_mask, gt_boxes_dc, dc_mask, draws)
        with span("det.roi_head"):
            det = self.roi_head(feat, pt.rois)
            b, s = pt.labels.shape
            uc = c.uc
            cls_score, labels = det["cls_score"].reshape(b * s, -1), pt.labels.reshape(-1)
            losses = {}
            if uc.en_cls_aleatoric:
                var = torch.exp(det["cls_al_var"].reshape(b * s, -1))
                normals = self._uc_draws(draws).normal(
                    "ce", (uc.a_num_ce_sample,) + tuple(cls_score.shape), cls_score.device)
                ce, a_mi = BAYES_VARIANTS[uc.bayes_variant](cls_score, var, labels, normals)
                losses["cross_entropy"], losses["a_mutual_info"] = ce, batch_mean(a_mi)
            else:
                losses["cross_entropy"] = cross_entropy(cls_score, labels)
            losses["loss_box"] = smooth_l1_loss(
                det["bbox_pred"], pt.bbox_targets, pt.bbox_inside_weights, pt.bbox_outside_weights,
                bbox_var=det.get("bbox_al_var") if uc.en_bbox_aleatoric else None,
                lidar_det=lidar, en_ry_sin=c.lidar.en_ry_sin,
                reg_loss_weight=c.lidar.reg_loss_weight, sum_axes=(2,),
            )
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

        images (B, H, W, 3) or BEV rasters, gt_boxes (B, G, 5) or for lidar
        (B, G, 8) 7-DoF, gt_mask (B, G), window (B, 4); gt_boxes_dc
        (B, D, 4) and dc_mask (B, D) feed TRAIN.IGNORE_DC.
        `proposals` = (src, valid) pins the second stage to those anchor
        lanes instead of the NMS's own choice.

        Under det-stage epistemic uncertainty every dropout layer is live,
        with draws.uc's masks; with cls aleatoric uncertainty the losses
        also hold a_mutual_info (not in total_loss)."""
        b = gt_boxes.shape[0]
        if gt_boxes_dc is None:
            gt_boxes_dc = torch.zeros((b, 1, 4), device=gt_boxes.device)
            dc_mask = torch.zeros((b, 1), dtype=torch.bool, device=gt_boxes.device)
        live = (live_dropout(self._uc_draws(draws), self) if self.cfg.uc.any_epistemic
                else contextlib.nullcontext())
        with live:
            with span("det.backbone"):
                feat = self.features(images)
            with span("det.rpn"):
                rpn_out, grids, at, losses = self.rpn_train(
                    feat, gt_boxes, gt_mask, window, draws, scale_idx)
            src = valid = pt = None
            if self.cfg.enable_full_net:
                src, valid = proposals if proposals is not None else self.select_proposals(
                    rpn_out, grids[0], window)
                det_losses, pt = self.second_stage_train(
                    feat, rpn_out, grids, window, src, valid, gt_boxes, gt_mask,
                    gt_boxes_dc, dc_mask, draws)
                losses.update(det_losses)
            else:
                zero = torch.zeros((), device=images.device)
                losses.update(cross_entropy=zero, loss_box=zero)
        losses["total_loss"] = (
            losses["rpn_cross_entropy"] + losses["rpn_loss_box"]
            + losses["cross_entropy"] + losses["loss_box"]
        )
        return losses, TrainAux(at, src, valid, pt)

    def forward(self, *args, method="forward_train", **kwargs):
        """`method` (forward_train or forward_test, or a function of the
        model) on the arguments: the entry torch.func.functional_call
        reaches (training.solver)."""
        if callable(method):
            return method(self, *args, **kwargs)
        return getattr(self, method)(*args, **kwargs)

    def classify_rois(
        self, feat: Features, rois: torch.Tensor, window: torch.Tensor,
        anchors_3d: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Second stage on (B, S, 4) rois -> class probabilities (B, S, K)
        and per-class boxes (B, S, EK); see decode."""
        return self.decode(self.roi_head(feat, rois), rois, window, anchors_3d)

    def decode(
        self, det: Dict[str, torch.Tensor], rois: torch.Tensor, window: torch.Tensor,
        anchors_3d: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """RoI-head outputs -> class probabilities and per-class boxes
        (decode_boxes)."""
        return (torch.softmax(det["cls_score"], dim=-1),
                self.decode_boxes(det["bbox_pred"], rois, window, anchors_3d))

    def decode_boxes(
        self, bbox_pred: torch.Tensor, rois: torch.Tensor, window: torch.Tensor,
        anchors_3d: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, S, EK) normalized deltas -> per-class boxes from the
        un-normalized deltas: image boxes clipped to each frame's window, or
        for lidar 7-DoF boxes decoded against the rois' (B, S, 7) 3D
        anchors, unclipped."""
        c = self.cfg
        b, s = rois.shape[:2]
        k, e = self.num_classes, c.num_bbox_elem
        lidar = c.net_type == "lidar"
        tc = c.train
        with span("sync.box_norm"):  # blocking copies: the host waits for the device
            means = torch.tensor(
                tc.lidar_bbox_normalize_means if lidar else tc.image_bbox_normalize_means,
                device=rois.device)
            stds = torch.tensor(
                tc.lidar_bbox_normalize_stds if lidar else tc.image_bbox_normalize_stds,
                device=rois.device)
        deltas = (bbox_pred.reshape(b, s, k, e) * stds + means).reshape(b, s, k * e)
        if lidar:
            if anchors_3d is None:
                raise ValueError("decode: lidar rois need their (B, S, 7) 3D anchors")
            return lidar_3d_bbox_transform_inv(rois, anchors_3d, deltas)
        return clip_boxes(bbox_transform_inv(rois, deltas), window)


_TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


def _trunc_normal(w: torch.Tensor, std: float, g: torch.Generator) -> None:
    std = std / _TRUNC
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def init_params(model: FasterRCNN, generator: torch.Generator) -> FasterRCNN:
    """Random init with the JAX package's initializers, from `generator`:
    ResNet convs variance-scaling(2, fan_out, truncated normal), the stem
    conv, the FPN convs and every conv and dense layer of VGG16 and
    MobileNet (backbone and tail) lecun-normal (flax's default: fan-in
    over the groups), RPN, class heads,
    the epistemic stacks and the FPN tail's t_fc layers normal(0.01), the
    box head, its variance head and the RPN's variance convs normal(0.001),
    zero biases, identity BN (frozen or live), and the residual terminators'
    scales (bn3 of a Bottleneck, bn2 of a BasicBlock) zero where the block
    asks for it, at cfg.resnet.fixed_blocks == -1."""
    head_std = {"rpn_bbox_al_var_net": 0.001, "rpn_cls_al_var_net": 0.001, "rpn": 0.01,
                "predictors.cls_score_net": 0.01, "predictors.bbox_pred_net": 0.001,
                "predictors.cls_al_var_net": 0.01, "predictors.bbox_al_var_net": 0.001,
                "predictors.cls_stack": 0.01, "predictors.bbox_stack": 0.01, "tail.t_fc": 0.01}
    lecun_net = model.cfg.net_variant in FC7_WIDTH
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, FrozenBatchNorm):  # LiveBatchNorm, AffineBatchNorm too
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                if lecun_net and name.startswith(("backbone", "tail")):
                    fan_in = (m.in_features if isinstance(m, nn.Linear)
                              else m.in_channels // m.groups * math.prod(m.kernel_size))
                    _trunc_normal(m.weight, math.sqrt(1.0 / fan_in), generator)
                elif isinstance(m, nn.Conv2d) and name.startswith(("backbone", "tail", "fpn")):
                    kh, kw = m.kernel_size
                    if name == "backbone.conv1" or name.startswith("fpn"):
                        std = math.sqrt(1.0 / (m.in_channels * kh * kw))
                    else:
                        std = math.sqrt(2.0 / (m.out_channels * kh * kw))
                    _trunc_normal(m.weight, std, generator)
                else:
                    std = next(v for k, v in head_std.items() if name.startswith(k))
                    m.weight.normal_(0.0, std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        for m in model.modules():
            if isinstance(m, (Bottleneck, BasicBlock)) and m.zero_init_residual:
                m.terminator.weight.zero_()
    return model


def stem_key(model: FasterRCNN) -> str:
    """The state-dict key of the backbone's first conv weight, the stem
    that takes the frames or BEV rasters (backbone.conv1, early_conv0 or
    conv0)."""
    name = next(n for n, m in model.backbone.named_modules() if isinstance(m, nn.Conv2d))
    return f"backbone.{name}.weight"


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


def live_bn_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics of the model's LiveBatchNorm modules, by
    state-dict key: float32 buffers that no compute-dtype cast may round
    (the JAX package's `batch_stats` collection, which cast_for_compute
    leaves alone)."""
    return {
        f"{name}.{k}": getattr(m, k)
        for name, m in model.named_modules() if isinstance(m, LiveBatchNorm)
        for k in ("running_mean", "running_var")
    }


def to_device(model: FasterRCNN, device: torch.device | str) -> FasterRCNN:
    """Move and cast a detector for inference: cfg.compute_dtype weights,
    channels_last convolutions, eval mode (a live-BN model then normalizes
    with its running statistics, which stay float32)."""
    return model.to(
        device=device, dtype=model.compute_dtype, memory_format=torch.channels_last
    ).eval()
