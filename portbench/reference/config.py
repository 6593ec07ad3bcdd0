"""The reference's own reading of a configuration file's override list.

The defaults are a frozen copy of the values that the port's `config.py`
(itself a copy of the JAX package's) gives the keys the reference detector
reads; an override list is applied to them with the same literal syntax
(`TRAIN.SCALES "(0.5,)"`).  A key the reference does not know is refused,
so a configuration can never reach a path the reference does not compute.
"""

from __future__ import annotations

import ast
import math
from typing import Dict, Sequence

DEFAULTS: Dict[str, object] = {
    "NET_TYPE": "lidar", "NET_VARIANT": "res101", "COMPUTE_DTYPE": "bfloat16",
    "PIXEL_MEANS": (96.866, 98.76, 93.85), "PIXEL_STDDEVS": (1.0, 1.0, 1.0),
    "ANCHOR_SCALES": (2.0, 4.0, 8.0, 16.0, 32.0), "ANCHOR_RATIOS": (0.5, 0.75, 1.0, 1.25, 2.0),
    "RPN_CHANNELS": 512, "POOLING_SIZE": 7, "POOLING_MODE": "align", "USE_FPN": False,
    "GRAD_MAX_CLIP": 20.0, "RESNET.FIXED_BLOCKS": 1, "ENABLE_FULL_NET": True,
    "TRAIN.SCALES": (1.0,), "TRAIN.BATCH_SIZE": 16, "TRAIN.LEARNING_RATE": 0.001,
    "TRAIN.MOMENTUM": 0.5, "TRAIN.WEIGHT_DECAY": 0.0001, "TRAIN.DOUBLE_BIAS": False,
    "TRAIN.BIAS_DECAY": False, "TRAIN.GAMMA": 0.1, "TRAIN.STEPSIZE": (70000, 140000, 210000),
    "TRAIN.USE_GT": False, "TRAIN.USE_GT_NOISE": False, "TRAIN.IGNORE_DC": False,
    "TRAIN.ROI_BATCH_SIZE": 256, "TRAIN.FG_FRACTION": 0.25, "TRAIN.FG_THRESH": 0.6,
    "TRAIN.BG_THRESH_HI": 0.5, "TRAIN.BG_THRESH_LO": 0.0,
    "TRAIN.RPN_POSITIVE_OVERLAP": 0.7, "TRAIN.RPN_NEGATIVE_OVERLAP": 0.3,
    "TRAIN.RPN_CLOBBER_POSITIVES": False, "TRAIN.RPN_FG_FRACTION": 0.5,
    "TRAIN.RPN_BATCHSIZE": 256, "TRAIN.RPN_NMS_THRESH": 0.7, "TRAIN.RPN_PRE_NMS_TOP_N": 12000,
    "TRAIN.RPN_POST_NMS_TOP_N": 2000,
    "TRAIN.LIDAR.BBOX_NORMALIZE_MEANS": (0.0,) * 7,
    "TRAIN.LIDAR.BBOX_NORMALIZE_STDS": (0.1, 0.1, 0.1, 0.2, 0.2, 0.2, 1.0),
    "TRAIN.IMAGE.BBOX_NORMALIZE_MEANS": (0.0,) * 4,
    "TRAIN.IMAGE.BBOX_NORMALIZE_STDS": (0.1, 0.1, 0.2, 0.2),
    "TEST.SCALES": (1.0,), "TEST.NMS_THRESH": 0.6, "TEST.RPN_NMS_THRESH": 0.7,
    "TEST.RPN_PRE_NMS_TOP_N": 6000, "TEST.RPN_POST_NMS_TOP_N": 300, "TEST.MODE": "nms",
    "TEST.THRESH": 0.5, "TEST.MAX_DETS": 100, "TEST.ROTATED_NMS": False,
    "STATIC.MAX_GT": 64, "STATIC.NMS_PRE_TRAIN": 4096, "STATIC.NMS_PRE_TEST": 2048,
    "STATIC.MAX_POINTS": 180000,
    "LIDAR.X_RANGE": (0.0, 70.0), "LIDAR.Y_RANGE": (-40.0, 40.0), "LIDAR.Z_RANGE": (-3.0, 3.0),
    "LIDAR.VOXEL_LEN": 0.1, "LIDAR.VOXEL_HEIGHT": 0.5, "LIDAR.NUM_SLICES": 12,
    "LIDAR.NUM_META_CHANNEL": 3, "LIDAR.MAX_PTS_PER_VOXEL": 32,
    "LIDAR.ANCHORS": ((4.73, 2.08, 1.77),), "LIDAR.ANCHOR_SCALES": (1.0,),
    "LIDAR.ANCHOR_ANGLES": (0.0, math.pi / 2), "LIDAR.REG_LOSS_WEIGHT": (1.0,) * 7,
    "LIDAR.EN_RY_SIN": True, "LIDAR.ANCHOR_SUBSTRIDE": 1,
    "LIDAR.RPN_POSITIVE_OVERLAP": -1.0, "LIDAR.RPN_NEGATIVE_OVERLAP": -1.0,
}

# values other than these take the program down a path the reference does not have
FIXED = {"USE_FPN": False, "POOLING_MODE": "align", "ENABLE_FULL_NET": True,
         "TRAIN.USE_GT": False, "TRAIN.IGNORE_DC": False, "TEST.MODE": "nms",
         "LIDAR.ANCHOR_SUBSTRIDE": 1, "LIDAR.ANCHOR_SCALES": (1.0,)}


def _literal(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _coerce(value, old):
    """The override in the default's type, as the port's cfg_from_list coerces it."""
    if isinstance(old, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(old, tuple):
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"expected a sequence, got {value!r}")
        return tuple(tuple(v) if isinstance(v, (list, tuple)) else v for v in value)
    if isinstance(old, int):
        return int(value)
    if isinstance(old, float):
        return float(value)
    return str(value)


def reference_config(overrides: Sequence[str]) -> Dict[str, object]:
    """The defaults with `overrides` (key, value, key, value, ...) applied."""
    if len(overrides) % 2:
        raise ValueError("overrides: an odd number of entries")
    cfg = dict(DEFAULTS)
    for key, text in zip(overrides[::2], overrides[1::2]):
        if key not in cfg:
            raise KeyError(f"the reference detector does not read {key}")
        cfg[key] = _coerce(_literal(text), DEFAULTS[key])
    for key, value in FIXED.items():
        if cfg[key] != value:
            raise NotImplementedError(f"the reference detector has no {key} {cfg[key]!r}")
    if cfg["NET_VARIANT"] not in DEPTHS:
        raise NotImplementedError(f"the reference detector has no {cfg['NET_VARIANT']}")
    return cfg


# ResNet stages: blocks per stage, and whether the block is the two-conv BasicBlock
DEPTHS = {"res18": ((2, 2, 2, 2), True), "res34": ((3, 4, 6, 3), True),
          "res50": ((3, 4, 6, 3), False), "res101": ((3, 4, 23, 3), False),
          "res152": ((3, 8, 36, 3), False)}
