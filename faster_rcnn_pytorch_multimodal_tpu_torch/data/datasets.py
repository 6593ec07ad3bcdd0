"""Dataset registry (the port's copy of faster_rcnn_pytorch_multimodal_tpu/data/datasets.py).

`register(name)` and `get_db(db_name, cfg, mode)` as in JAX (:13-30): the
name's part before the first '_' picks the builder, an unknown one raises
KeyError with the list of valid choices.  The port registers kitti, waymo
and cadc; nuscenes, voc/pascal and coco are registered as not ported yet
and raise NotImplementedError (ROADMAP A4).
"""

from __future__ import annotations

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config

_REGISTRY = {}
NOT_PORTED = ("nuscenes", "voc", "pascal", "coco")


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_db(db_name: str, cfg: Config, mode: str):
    _autoload()
    key = db_name.split("_")[0]
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown dataset {db_name!r}; available: "
            f"{sorted(_REGISTRY) + ['synthetic']}"
        )
    return _REGISTRY[key](db_name, cfg, mode)


def _not_ported(db_name: str, cfg: Config, mode: str):
    raise NotImplementedError(
        f"--db {db_name}: the nuScenes, Pascal VOC and COCO databases are not ported yet "
        "(ROADMAP A4); the port reads kitti, waymo, cadc and synthetic")


for _name in NOT_PORTED:
    register(_name)(_not_ported)


def _autoload() -> None:
    """Import the builders, which register themselves (at the first
    get_db: the builders import this module)."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.data import cadc, kitti, waymo  # noqa: F401
