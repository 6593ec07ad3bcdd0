"""Frozen, hierarchical configuration tree (the port's own copy).

A copy of faster_rcnn_pytorch_multimodal_tpu/config.py:1-551: every
dataclass and field, `default_config`, `cfg_from_list`, `cfg_from_file` and
their key handling (:445-550), so that the port accepts exactly the JAX
package's override keys (dotted UPPERCASE, e.g. ``TRAIN.LEARNING_RATE``) and
yields field-for-field equal configs.  The port reads only some of the
fields; the others are kept so that configs and override lists carry over.

``Config.static`` (fixed shape budget) and ``Config.mesh`` come from the JAX
package; the port keeps fixed shapes where parity needs them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DebugConfig:
    """ref: lib/model/config.py:19-31"""

    en: bool = False
    draw_minibatch: bool = False
    draw_anchors: bool = False
    draw_anchor_t: bool = False
    draw_proposal_t: bool = False
    test_frame_print: bool = False
    freeze_db: bool = False
    freeze_db_inds: int = 3
    print_scene_result: bool = False
    en_test_msg: bool = True


@dataclass(frozen=True)
class UCConfig:
    """Uncertainty estimation switches (ref: lib/model/config.py:34-47)."""

    en_rpn_bbox_aleatoric: bool = False
    en_rpn_cls_aleatoric: bool = False
    en_rpn_bbox_epistemic: bool = False
    en_rpn_cls_epistemic: bool = False
    en_bbox_aleatoric: bool = False
    en_cls_aleatoric: bool = False
    en_bbox_epistemic: bool = False
    en_bbox_epistemic_inv_transform: bool = False
    en_cls_epistemic: bool = False
    a_num_ce_sample: int = 200
    a_num_bbox_sample: int = 200
    e_num_sample: int = 10
    # MC samples evaluated per scan step (JAX package); the test-time
    # override, 0 = use e_mc_chunk
    e_mc_chunk: int = 5
    e_mc_chunk_test: int = 1
    sort_type: str = ""
    # Bayesian CE formulation for aleatoric classification: 'full' (avg
    # softmax over distorted logits, ref loss_utils.py:149-169), 'simple'
    # (CE averaged over samples, :171-184), 'elu' (ELU-regularized
    # difference, :187-209)
    bayes_variant: str = "full"

    @property
    def any_epistemic(self) -> bool:
        return self.en_bbox_epistemic or self.en_cls_epistemic

    @property
    def rpn_epistemic(self) -> bool:
        return self.en_rpn_bbox_epistemic or self.en_rpn_cls_epistemic

    @property
    def any_aleatoric(self) -> bool:
        return self.en_bbox_aleatoric or self.en_cls_aleatoric


@dataclass(frozen=True)
class TrainConfig:
    """ref: lib/model/config.py:63-223"""

    learning_rate: float = 0.001
    momentum: float = 0.5
    weight_decay: float = 0.0001
    gamma: float = 0.1
    stepsize: Tuple[int, ...] = (70000, 140000, 210000)
    # In the reference this is the pseudo-batch (gradient accumulation) size
    # (ref: lib/model/train_val.py:379-382).  Here it is the REAL hardware
    # batch: that many frames are processed per jitted train step.
    batch_size: int = 16
    val_batch_size: int = 32
    augment_en: bool = True
    val_augment_en: bool = False
    display: int = 512
    double_bias: bool = False
    truncated: bool = False
    bias_decay: bool = False
    use_gt: bool = False
    # Framework extension (default off = reference parity, ref
    # proposal_target_layer.py:35-41 appends EXACT GT boxes): jitter the
    # GT corners by ~3% of the box size when appending them to the RoI
    # pool, so the classifier never trains on pixel-perfect boxes.  Wins
    # on the synthetic benchmark; see COMPONENTS.md deviations.
    use_gt_noise: bool = False
    snapshot_kept: int = 30
    summary_interval: int = 15
    # log backbone activation statistics (mean/std/absmax of the head
    # conv) with each val cycle — the reference's _act_summaries
    # histogram hook (ref vgg16.py:51) as TB scalars
    en_act_summaries: bool = False
    scales: Tuple[float, ...] = (1.0,)
    frames_per_batch: int = 1
    roi_batch_size: int = 256
    fg_fraction: float = 0.25
    fg_thresh: float = 0.6
    dc_thresh: float = 0.5
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.0
    use_flipped: bool = True
    bbox_reg: bool = True
    snapshot_iters: int = 5000
    snapshot_prefix: str = "res101_faster_rcnn"
    bbox_normalize_targets: bool = True
    bbox_inside_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    bbox_normalize_targets_precomputed: bool = True
    proposal_method: str = "gt"
    has_rpn: bool = True
    rpn_positive_overlap: float = 0.7
    rpn_negative_overlap: float = 0.3
    rpn_clobber_positives: bool = False
    rpn_fg_fraction: float = 0.5
    rpn_batchsize: int = 256
    rpn_nms_thresh: float = 0.7
    rpn_pre_nms_top_n: int = 12000
    rpn_post_nms_top_n: int = 2000
    rpn_bbox_inside_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    rpn_positive_weight: float = -1.0
    use_all_gt: bool = False
    ignore_dc: bool = False
    iter: int = 1
    draw_val_detections: bool = True
    tod_filter_list: Tuple[str, ...] = ("Day", "Night", "Dawn/Dusk")
    cadc_filter_list: Tuple[str, ...] = (
        "none",
        "light",
        "medium",
        "heavy",
        "extreme",
    )
    draw_roidb_gen: bool = False
    lidar_bbox_normalize_means: Tuple[float, ...] = (0.0,) * 7
    lidar_bbox_normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.1, 0.2, 0.2, 0.2, 1.0)
    image_bbox_normalize_means: Tuple[float, ...] = (0.0,) * 4
    image_bbox_normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)


@dataclass(frozen=True)
class TestConfig:
    """ref: lib/model/config.py:227-274, 451-453"""

    scales: Tuple[float, ...] = (1.0,)
    nms_thresh: float = 0.6
    bbox_reg: bool = True
    has_rpn: bool = True
    proposal_method: str = "gt"
    rpn_nms_thresh: float = 0.7
    rpn_pre_nms_top_n: int = 6000
    rpn_post_nms_top_n: int = 300
    mode: str = "nms"
    rpn_top_n: int = 5000
    ignore_dc: bool = False
    iter: int = 1
    en_aux_features: bool = False
    augment_en: bool = False
    tod_filter_list: Tuple[str, ...] = ("Day", "Night", "Dawn/Dusk")
    cadc_filter_list: Tuple[str, ...] = (
        "none",
        "light",
        "medium",
        "heavy",
        "extreme",
    )
    rain_sim_en: bool = False
    dropout_en: bool = False
    rain_rate: float = 1.0
    thresh: float = 0.5
    max_dets: int = 100
    # framework extension (OFF = reference parity): suppress final lidar
    # detections with true rotated-footprint IoU instead of the reference's
    # rotation-ignoring AABB NMS (ref lib/utils/filter_predictions.py:55-67)
    rotated_nms: bool = False


@dataclass(frozen=True)
class ResnetConfig:
    """ref: lib/model/config.py:279-289"""

    max_pool: bool = False
    fixed_blocks: int = 1
    # stage-granular rematerialization in the JAX package and the stages
    # it recomputes; the port does not read them
    remat: bool = True
    remat_stages: Tuple[int, ...] = (1, 2)


@dataclass(frozen=True)
class MobilenetConfig:
    """ref: lib/model/config.py:295-308"""

    regu_depth: bool = False
    fixed_layers: int = 5
    weight_decay: float = 0.00004
    depth_multiplier: float = 1.0


@dataclass(frozen=True)
class LidarConfig:
    """ref: lib/model/config.py:396-427"""

    x_range: Tuple[float, float] = (0.0, 70.0)
    y_range: Tuple[float, float] = (-40.0, 40.0)
    z_range: Tuple[float, float] = (-3.0, 3.0)
    voxel_len: float = 0.1
    voxel_height: float = 0.5
    num_slices: int = 12
    num_meta_channel: int = 3
    max_pts_per_voxel: int = 32
    max_num_voxel: int = 25000
    shuffle_pc: bool = False
    en_aug_flips: bool = True
    en_aug_gauss_distort: bool = True
    en_aug_dropout: bool = True
    en_aug_rotate: bool = False
    en_aug_swap_x_y: bool = True
    eval_type: str = "3d"
    # (l, w, h) per anchor class (Waymo vehicle default)
    anchors: Tuple[Tuple[float, ...], ...] = ((4.73, 2.08, 1.77),)
    anchor_scales: Tuple[float, ...] = (1.0,)
    anchor_angles: Tuple[float, ...] = (0.0, math.pi / 2)
    num_bbox_elem: int = 7
    reg_loss_weight: Tuple[float, ...] = (1.0,) * 7
    en_ry_sin: bool = True
    # Anchor densification (framework extension, absent upstream): tile
    # anchor centers every feat_stride/substride voxels while features
    # stay at feat_stride — the RPN head just predicts substride^2 x A
    # anchors per cell.  At the reference geometry (stride 16, scale 0.5
    # -> 0.2 m voxels) anchor centers sit 3.2 m apart and the best
    # anchor-GT IoU for a car is ~0.28, below even the 0.3 negative
    # threshold; the reference never hits this because its lidar training
    # always preloads a full trained checkpoint (trainval_net.py:334-337).
    # substride 4 (0.8 m spacing) gives best IoU ~0.6 and real fg anchor
    # sets, enabling from-scratch BEV training (tools/diag_bev_overfit.py).
    # Default 1 = exact reference anchor geometry.
    anchor_substride: int = 1
    # Lidar-specific RPN overlap thresholds (<= 0: use the global
    # TRAIN.RPN_*_OVERLAP).  Rotated BEV boxes overlap axis-aligned
    # anchors less than image boxes do; AVOD uses 0.45/0.3 for cars.
    rpn_positive_overlap: float = -1.0
    rpn_negative_overlap: float = -1.0

    @property
    def num_channel(self) -> int:
        return self.num_slices + self.num_meta_channel


@dataclass(frozen=True)
class ImageConfig:
    num_bbox_elem: int = 4


@dataclass(frozen=True)
class DatasetLimits:
    """Per-dataset constants (ref: lib/model/config.py:431-449)."""

    waymo_lidar_max_range: float = 200.0
    kitti_max_frame: int = 10000
    kitti_img_size: Tuple[int, int] = (375, 1242)
    kitti_lidar_max_range: float = 120.0
    cadc_max_frame: int = 10000
    cadc_img_size: Tuple[int, int] = (624, 1280)
    cadc_lidar_max_range: float = 200.0


@dataclass(frozen=True)
class StaticShapes:
    """TPU-only: compile-time shape budget (no reference counterpart).

    XLA traces the train/test step once; every ragged quantity in the
    reference (variable GT count, variable proposal count, dynamic NMS
    output) becomes a fixed-size, mask-carrying tensor here.
    """

    max_gt: int = 64  # padded GT boxes per frame
    max_gt_dc: int = 16  # padded don't-care boxes per frame
    # proposal path: scores are top-k'd to `nms_pre` before the fixed-shape
    # NMS (the reference sorts all ~H*W*A anchors then NMSes 12000;
    # capping at a power of two keeps the IoU matrix MXU-friendly)
    nms_pre_train: int = 4096
    nms_pre_test: int = 2048
    # second stage RoI count == cfg.train.roi_batch_size at train time and
    # cfg.test.rpn_post_nms_top_n at test time
    max_points: int = 180000  # padded LiDAR points per frame
    image_size: Tuple[int, int] = (640, 960)  # H, W after resize+pad
    bev_size: Tuple[int, int] = (800, 704)  # H, W of the BEV raster (scale 1)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for pjit (no reference counterpart — the reference is
    single-GPU, SURVEY.md §2.17).

    `data` x `model` devices: the batch shards over `data`; with model > 1
    the detection-head channels shard over `model` (tensor parallelism,
    parallel/mesh.py param_shardings) and, with `spatial`, the image height
    additionally shards over `model` for the backbone convs (GSPMD halo
    exchange).  Pipeline/expert axes are waived: a 100-layer CNN detector
    has neither the >HBM parameter footprint pp exists for nor MoE blocks.
    """

    # data-parallel axis size; <=0 means "all visible devices / model"
    data: int = -1
    axis_name: str = "data"
    # model (tensor-parallel) axis size; 1 disables the axis entirely
    model: int = 1
    model_axis_name: str = "model"
    # shard the input H dim over the model axis too (spatial partitioning)
    spatial: bool = False


# ---------------------------------------------------------------------------
# Root config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Config:
    debug: DebugConfig = field(default_factory=DebugConfig)
    uc: UCConfig = field(default_factory=UCConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    resnet: ResnetConfig = field(default_factory=ResnetConfig)
    mobilenet: MobilenetConfig = field(default_factory=MobilenetConfig)
    lidar: LidarConfig = field(default_factory=LidarConfig)
    image: ImageConfig = field(default_factory=ImageConfig)
    limits: DatasetLimits = field(default_factory=DatasetLimits)
    static: StaticShapes = field(default_factory=StaticShapes)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # top-level scalars (ref: lib/model/config.py:49-57, 311-394)
    preload: bool = False
    preload_full: bool = False
    use_fpn: bool = False
    use_lidar_fpn: bool = False
    enable_full_net: bool = True
    net_type: str = "lidar"  # 'image' | 'lidar'
    # backbone selector (ref tools/trainval_net.py --net flag: res18/34/50/
    # 101/152, vgg16, mobile)
    net_variant: str = "res101"
    # TPU-only: activation/parameter compute dtype for the conv stack
    # ('float32' | 'bfloat16').  Params are stored fp32; with bfloat16 the
    # forward runs in bf16 (MXU-native) and losses are computed in fp32.
    compute_dtype: str = "bfloat16"
    scale_loc: int = 6
    cache_dir: str = ""
    db_name: str = ""
    pixel_means: Tuple[float, float, float] = (96.866, 98.76, 93.85)  # BGR
    pixel_stddevs: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    pixel_arrange: Tuple[int, int, int] = (0, 1, 2)
    pixel_arrange_bgr: Tuple[int, int, int] = (2, 1, 0)
    grad_max_clip: float = 20.0
    rng_seed: int = 3
    exp_dir: str = "res101"
    pooling_mode: str = "align"  # 'align' | 'multiscale'
    pooling_size: int = 7
    anchor_scales: Tuple[float, ...] = (2.0, 4.0, 8.0, 16.0, 32.0)
    anchor_ratios: Tuple[float, ...] = (0.5, 0.75, 1.0, 1.25, 2.0)
    rpn_channels: int = 512
    enable_custom_tail: bool = False
    num_scenes: int = 210
    max_img_per_scene: int = 1000
    data_dir: str = "data"
    root_dir: str = "."

    # ------------------------------------------------------------------
    # Derived helpers
    # ------------------------------------------------------------------
    @property
    def num_anchors_2d(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_ratios)

    @property
    def num_anchors_3d(self) -> int:
        return (
            len(self.lidar.anchors)
            * len(self.lidar.anchor_scales)
            * len(self.lidar.anchor_angles)
            * self.lidar.anchor_substride ** 2
        )

    @property
    def num_anchors(self) -> int:
        return self.num_anchors_3d if self.net_type == "lidar" else self.num_anchors_2d

    @property
    def num_bbox_elem(self) -> int:
        return (
            self.lidar.num_bbox_elem
            if self.net_type == "lidar"
            else self.image.num_bbox_elem
        )

    def phase(self, key: str) -> Any:
        """cfg['TRAIN'] / cfg['TEST'] style access (ref proposal_layer.py:27)."""
        key = key.lower()
        if key == "train":
            return self.train
        if key == "test":
            return self.test
        raise KeyError(key)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config() -> Config:
    return Config()


# ---------------------------------------------------------------------------
# Overrides: dotted-path (reference-compatible) + YAML
# ---------------------------------------------------------------------------

# Map reference UPPERCASE path components onto dataclass attribute names.
_SPECIAL_PATHS = {
    ("TRAIN", "LIDAR", "BBOX_NORMALIZE_MEANS"): ("train", "lidar_bbox_normalize_means"),
    ("TRAIN", "LIDAR", "BBOX_NORMALIZE_STDS"): ("train", "lidar_bbox_normalize_stds"),
    ("TRAIN", "IMAGE", "BBOX_NORMALIZE_MEANS"): ("train", "image_bbox_normalize_means"),
    ("TRAIN", "IMAGE", "BBOX_NORMALIZE_STDS"): ("train", "image_bbox_normalize_stds"),
    ("LIDAR", "NUM_CHANNEL"): None,  # derived, not settable
}


def _coerce(value: Any, old: Any) -> Any:
    """Coerce an override to the existing field's type (mirrors the type
    checking of ref config.py:560-577, but tuple-ifies lists)."""
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(old, tuple):
        if isinstance(value, (list, tuple)):
            return tuple(
                tuple(v) if isinstance(v, (list, tuple)) else v for v in value
            )
        raise TypeError(f"expected sequence, got {value!r}")
    if isinstance(old, int) and not isinstance(value, bool):
        return int(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, str):
        return str(value)
    return value


def _set_path(cfg: Any, parts: Tuple[str, ...], value: Any) -> Any:
    attr = parts[0]
    if not hasattr(cfg, attr):
        raise KeyError(
            f"{type(cfg).__name__} has no config key {attr!r} "
            f"(valid: {[f.name for f in dataclasses.fields(cfg)]})"
        )
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{attr: _coerce(value, getattr(cfg, attr))})
    sub = _set_path(getattr(cfg, attr), parts[1:], value)
    return dataclasses.replace(cfg, **{attr: sub})


def _normalize_key(key: str) -> Tuple[str, ...]:
    parts = tuple(key.split("."))
    upper = tuple(p.upper() for p in parts)
    if upper in _SPECIAL_PATHS:
        mapped = _SPECIAL_PATHS[upper]
        if mapped is None:
            raise KeyError(f"{key} is derived and cannot be set")
        return mapped
    return tuple(p.lower() for p in parts)


def cfg_from_list(cfg: Config, cfg_list: Tuple[Any, ...]) -> Config:
    """Apply ``--set K V K V ...`` overrides (ref: lib/model/config.py:589-609).

    Values may be python-literal strings ('0.02', '[1,2]', 'True') or objects.
    """
    from ast import literal_eval

    if len(cfg_list) % 2 != 0:
        raise ValueError("cfg_from_list expects key/value pairs")
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        if isinstance(v, str):
            try:
                v = literal_eval(v)
            except (ValueError, SyntaxError):
                pass  # keep as string
        cfg = _set_path(cfg, _normalize_key(str(k)), v)
    return cfg


def _flatten(d: Any, prefix: str = "") -> list:
    out = []
    for k, v in d.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(_flatten(v, path))
        else:
            out.extend([path, v])
    return out


def cfg_from_file(cfg: Config, filename: str) -> Config:
    """Merge a YAML file (reference-style UPPERCASE keys allowed)
    (ref: lib/model/config.py:580-586)."""
    import yaml

    with open(filename, "r") as f:
        y = yaml.safe_load(f)
    if not y:
        return cfg
    return cfg_from_list(cfg, tuple(_flatten(y)))
