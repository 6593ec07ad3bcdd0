"""Command-line surface of the port's CLIs (tools/*_torch.py).

Copies of the JAX package's CLI pieces, so that the port's tools take the
same flags and build the same configs:
  * `test_parser`: the flags of tools/test_net.py:19-46, plus --device;
  * `train_parser`: the flags of tools/trainval_net.py:22-54, plus --device;
  * `args_to_train_ns`: tools/test_net.py:345-360;
  * `build_config` and `build_dataset`: tools/trainval_net.py:56-120 (the
    synthetic dataset, or a real database through data.datasets.get_db).
"""

from __future__ import annotations

import argparse
import types

from faster_rcnn_pytorch_multimodal_tpu_torch.config import (
    cfg_from_file,
    cfg_from_list,
    default_config,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.data.datasets import get_db
from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset


def _device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; the CUDA kernels run only on 'cuda'")


def test_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Test a Faster R-CNN network (PyTorch port)")
    parser.add_argument("--cfg", dest="cfg_file", default=None, type=str)
    parser.add_argument("--weights_file", default=None, type=str,
                        help="state dict in the port's layout (.pt or .npz)")
    parser.add_argument("--db", dest="db_name", default="synthetic", type=str)
    parser.add_argument("--net", default="res101", type=str)
    parser.add_argument("--net_type", default=None, type=str)
    parser.add_argument("--en_full_net", default=1, type=int)
    parser.add_argument("--en_fpn", default=0, type=int)
    parser.add_argument("--en_epistemic", default=0, type=int)
    parser.add_argument("--en_aleatoric", default=0, type=int)
    parser.add_argument("--uc_sort_type", default=None, type=str)
    parser.add_argument("--iter", dest="iter", default=None, type=int)
    parser.add_argument("--scale", default=None, type=float)
    parser.add_argument("--fixed_blocks", default=None, type=int)
    parser.add_argument("--data_dir", default=None, type=str)
    parser.add_argument("--cache_dir", default=None, type=str)
    parser.add_argument("--out_dir", default="output", type=str)
    parser.add_argument("--thresh", default=0.5, type=float)
    parser.add_argument("--batch_size", default=4, type=int)
    parser.add_argument("--max_frames", default=-1, type=int)
    parser.add_argument("--eval_det", default=1, type=int)
    parser.add_argument("--draw_det", default=0, type=int,
                        help="draw first N frames' detections (uc-colored)")
    _device_flag(parser)
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    return parser


def train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a Faster R-CNN network (PyTorch port)")
    parser.add_argument("--cfg", dest="cfg_file", default=None, type=str,
                        help="optional config YAML")
    parser.add_argument("--weights_file", default=None, type=str,
                        help="initialize with pretrained model weights")
    parser.add_argument("--data_dir", default=None, type=str)
    parser.add_argument("--cache_dir", default=None, type=str)
    parser.add_argument("--db", dest="db_name", default="synthetic", type=str,
                        help="dataset to train on (waymo, kitti, cadc, synthetic)")
    parser.add_argument("--dbval", dest="dbval_name", default=None, type=str)
    parser.add_argument("--iters", dest="max_iters", default=70000, type=int)
    parser.add_argument("--batch_size", dest="train_batch_size", default=None,
                        type=int, help="REAL hardware batch size per step")
    parser.add_argument("--batch_size_val", dest="val_batch_size", default=None, type=int)
    parser.add_argument("--tag", default=None, type=str)
    parser.add_argument("--net", default="res101", type=str,
                        help="vgg16, res18/34/50/101/152, mobile")
    parser.add_argument("--net_type", default=None, type=str, help="lidar or image")
    parser.add_argument("--en_full_net", default=1, type=int)
    parser.add_argument("--en_fpn", default=0, type=int)
    parser.add_argument("--en_epistemic", default=0, type=int)
    parser.add_argument("--en_aleatoric", default=0, type=int)
    parser.add_argument("--uc_sort_type", default=None, type=str)
    parser.add_argument("--iter", dest="iter", default=None, type=int)
    parser.add_argument("--preload", default=None, type=int,
                        help="0: none, 1: backbone, 2: full minus 2nd-stage heads")
    parser.add_argument("--fixed_blocks", default=None, type=int)
    parser.add_argument("--scale", default=None, type=float)
    parser.add_argument("--out_dir", default="output", type=str)
    _device_flag(parser)
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    return parser


def args_to_train_ns(args) -> types.SimpleNamespace:
    """Test flags -> the namespace build_config expects."""
    g = lambda name, default=None: getattr(args, name, default)  # noqa: E731
    return types.SimpleNamespace(
        cfg_file=g("cfg_file"), net_type=g("net_type"), net=g("net", "res101"),
        en_full_net=g("en_full_net", 1), en_fpn=g("en_fpn", 0),
        en_aleatoric=g("en_aleatoric", 0), en_epistemic=g("en_epistemic", 0),
        uc_sort_type=g("uc_sort_type"), preload=None,
        fixed_blocks=g("fixed_blocks"), scale=g("scale"),
        train_batch_size=None, val_batch_size=None, iter=g("iter"),
        data_dir=g("data_dir"), cache_dir=g("cache_dir"),
        db_name=g("db_name", "synthetic"), set_cfgs=g("set_cfgs"),
    )


def build_config(args):
    """The config of a CLI run: defaults, --cfg, the flags, then --set."""
    cfg = default_config()
    if args.cfg_file:
        cfg = cfg_from_file(cfg, args.cfg_file)
    overrides = []
    if args.net_type:
        overrides += ["NET_TYPE", "lidar" if args.net_type == "lidar" else "image"]
    overrides += ["NET_VARIANT", args.net]
    overrides += ["ENABLE_FULL_NET", bool(args.en_full_net)]
    overrides += ["USE_FPN", bool(args.en_fpn)]
    if args.en_fpn:
        overrides += ["POOLING_MODE", "multiscale"]
    if args.en_aleatoric:
        overrides += ["UC.EN_BBOX_ALEATORIC", True, "UC.EN_CLS_ALEATORIC", True]
    if args.en_epistemic:
        overrides += ["UC.EN_BBOX_EPISTEMIC", True, "UC.EN_CLS_EPISTEMIC", True]
    if args.uc_sort_type:
        overrides += ["UC.SORT_TYPE", args.uc_sort_type]
    if args.preload is not None:
        overrides += ["PRELOAD", args.preload >= 1, "PRELOAD_FULL", args.preload >= 2]
    if args.fixed_blocks is not None:
        overrides += ["RESNET.FIXED_BLOCKS", args.fixed_blocks]
    if args.scale is not None:
        overrides += ["TRAIN.SCALES", (args.scale,), "TEST.SCALES", (args.scale,)]
    if args.train_batch_size is not None:
        overrides += ["TRAIN.BATCH_SIZE", args.train_batch_size]
    if args.val_batch_size is not None:
        overrides += ["TRAIN.VAL_BATCH_SIZE", args.val_batch_size]
    if args.iter is not None:
        overrides += ["TRAIN.ITER", args.iter]
    if args.data_dir:
        overrides += ["DATA_DIR", args.data_dir]
    if args.cache_dir:
        overrides += ["CACHE_DIR", args.cache_dir]
    overrides += ["DB_NAME", args.db_name.split("_")[0]]
    cfg = cfg_from_list(cfg, tuple(overrides))
    if args.set_cfgs:
        cfg = cfg_from_list(cfg, tuple(args.set_cfgs))
    return cfg


def build_dataset(cfg, db_name: str, mode: str):
    """The synthetic dataset of a split (disjoint frames per split, as the
    JAX CLI seeds them), or the real database `db_name` (kitti, waymo,
    cadc) under DATA_DIR; nuscenes, voc and coco raise NotImplementedError,
    an unknown name KeyError."""
    if db_name.startswith("synthetic"):
        seed = {"train": 0, "val": 101, "test": 202}.get(mode, 0)
        return SyntheticDataset(cfg, num_frames=64, num_classes=2, mode=mode, seed=seed)
    return get_db(db_name, cfg, mode)
