#!/usr/bin/env python
"""Train the PyTorch port of the detector (image C4 path) on one device.

The flags are tools/trainval_net.py's, plus --device (the port's cli module);
--iters defaults to 20.  The loop is faster_rcnn_pytorch_multimodal_tpu_torch.
training.solver.train: BatchLoader -> H2D -> random draws -> forward_train
-> backward -> the JAX package's SGD chain, each step timed with CUDA events
on a card.  Weights are randomly initialized from the config's RNG_SEED;
pretrained weights, snapshots, resume, the val cycle and LiDAR training are
not ported yet and raise.

    python tools/trainval_net_torch.py --db synthetic --net res101 --net_type image --iters 20 --batch_size 8
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    from faster_rcnn_pytorch_multimodal_tpu_torch.cli import train_parser

    parser = train_parser()
    parser.set_defaults(max_iters=20, net_type="image")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.weights_file or args.dbval_name or args.preload:
        raise NotImplementedError(
            "trainval_net_torch: --weights_file, --dbval and --preload are not ported")
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.cli import build_config, build_dataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import create_train_state, train

    cfg = build_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("trainval_net_torch: --device cuda but no CUDA device is visible")
    db = build_dataset(cfg, args.db_name, "train")
    loader = BatchLoader(db, cfg, batch_size=cfg.train.batch_size, device=device,
                         augment=cfg.train.augment_en, seed=cfg.rng_seed)
    model, optimizer = create_train_state(cfg, len(db.classes), device, seed=cfg.rng_seed)
    if device.type == "cuda":
        _, seconds, _ = _build.build()
        print(f"kernels: {_build.library_path()} (built in {seconds:.1f} s)")
    generator = torch.Generator(device=device).manual_seed(cfg.rng_seed)
    print(f"training {cfg.net_variant} {cfg.compute_dtype} on {db.name} ({len(db)} frames, "
          f"batch {cfg.train.batch_size}) for {args.max_iters} steps on {device}")

    def log(i, losses, ms):
        parts = ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
        print(f"iter {i + 1}: {parts}; {ms:.1f} ms")

    res = train(model, optimizer, loader, args.max_iters, generator, on_step=log)
    ms = np.asarray(res["ms"])
    steady = ms[1:] if len(ms) > 1 else ms
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}; {steady.mean():.2f} ms/step after the first "
          f"({ms[0]:.2f} ms), {cfg.train.batch_size / (steady.mean() / 1e3):.2f} frames/s")
    return res


if __name__ == "__main__":
    main()
