"""Dataset registry (the port's copy of faster_rcnn_pytorch_multimodal_tpu/data/datasets.py).

`register(name)` and `get_db(db_name, cfg, mode)` as in JAX (:13-30): the
name's part before the first '_' picks the builder, an unknown one raises
KeyError with the list of valid choices.  The database modules register
themselves: kitti, waymo, cadc, nuscenes, voc and coco, as in JAX.
"""

from __future__ import annotations

from faster_rcnn_pytorch_multimodal_tpu_torch.config import Config

_REGISTRY = {}


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


def _autoload() -> None:
    """Import the builders, which register themselves (at the first
    get_db: the builders import this module)."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.data import (  # noqa: F401
        cadc,
        coco,
        kitti,
        nuscenes,
        pascal_voc,
        waymo,
    )
