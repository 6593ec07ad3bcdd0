#!/usr/bin/env python
"""Train the PyTorch port of the detector (image C4 path) on one device.

The flags are the subset of tools/trainval_net.py's that the port supports,
plus --device.  The loop is faster_rcnn_pytorch_multimodal_tpu_torch.
training.solver.train: BatchLoader -> H2D -> random draws -> forward_train
-> backward -> the JAX package's SGD chain, each step timed with CUDA events
on a card.  Weights are randomly initialized from the config's RNG_SEED;
snapshots, resume and the val cycle are not ported yet.

    python tools/trainval_net_torch.py --db synthetic --net res101 --net_type image --iters 20 --batch_size 8
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train the PyTorch port of Faster R-CNN")
    parser.add_argument("--db", dest="db_name", default="synthetic", type=str,
                        help="dataset (the port trains on synthetic only so far)")
    parser.add_argument("--net", default="res101", type=str, help="res50, res101 or res152")
    parser.add_argument("--net_type", default="image", type=str, help="image (lidar is not ported)")
    parser.add_argument("--iters", default=20, type=int)
    parser.add_argument("--batch_size", default=None, type=int, help="REAL batch size per step")
    parser.add_argument("--fixed_blocks", default=None, type=int)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; the CUDA kernels run only on 'cuda'")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def build_config(args):
    """The JAX CLI's config mutation, fed the flags the port supports."""
    import trainval_net  # same dir, jax-free at import

    argv = ["--db", args.db_name, "--net", args.net, "--net_type", args.net_type]
    if args.batch_size is not None:
        argv += ["--batch_size", str(args.batch_size)]
    if args.fixed_blocks is not None:
        argv += ["--fixed_blocks", str(args.fixed_blocks)]
    if args.set_cfgs:
        argv += ["--set", *args.set_cfgs]
    return trainval_net.build_config(trainval_net.parse_args(argv))


def main(argv=None):
    args = parse_args(argv)
    if args.net_type != "image" or not args.db_name.startswith("synthetic"):
        raise NotImplementedError("trainval_net_torch: only --net_type image on --db synthetic")
    from trainval_net import build_dataset

    import torch

    from faster_rcnn_pytorch_multimodal_tpu.data import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import create_train_state, train

    cfg = build_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("trainval_net_torch: --device cuda but no CUDA device is visible")
    db = build_dataset(cfg, args.db_name, "train")
    loader = BatchLoader(db, cfg, batch_size=cfg.train.batch_size, augment=cfg.train.augment_en,
                         seed=cfg.rng_seed)
    model, optimizer = create_train_state(cfg, len(db.classes), device, seed=cfg.rng_seed)
    if device.type == "cuda":
        _, seconds, _ = _build.build()
        print(f"kernels: {_build.library_path()} (built in {seconds:.1f} s)")
    generator = torch.Generator(device=device).manual_seed(cfg.rng_seed)
    print(f"training {cfg.net_variant} {cfg.compute_dtype} on {db.name} ({len(db)} frames, "
          f"batch {cfg.train.batch_size}) for {args.iters} steps on {device}")

    def log(i, losses, ms):
        parts = ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
        print(f"iter {i + 1}: {parts}; {ms:.1f} ms")

    res = train(model, optimizer, loader, args.iters, generator, on_step=log)
    ms = np.asarray(res["ms"])
    steady = ms[1:] if len(ms) > 1 else ms
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}; {steady.mean():.2f} ms/step after the first "
          f"({ms[0]:.2f} ms), {cfg.train.batch_size / (steady.mean() / 1e3):.2f} frames/s")
    return res


if __name__ == "__main__":
    main()
