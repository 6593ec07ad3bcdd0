#!/usr/bin/env python
"""Train the PyTorch port of the detector (C4 on images or LiDAR BEV
rasters, or with --en_fpn 1 the FPN image detector) on one device.

The flags are tools/trainval_net.py's, plus --device (the port's cli module);
--iters defaults to 20 and --net_type to image.  As tools/trainval_net.py:121-167
does, the run goes through the Solver
(faster_rcnn_pytorch_multimodal_tpu_torch.training.solver.Solver): the train
loader's background prefetch (for lidar: points up, `voxelize_bev` on the
device), the steps, snapshots in OUT_DIR/NET_TYPE/DB/checkpoints every
TRAIN.SNAPSHOT_ITERS steps and at the end, logs in .../tb (scalars.jsonl),
and with --dbval the val cycle every TRAIN.DISPLAY steps (.../tb_val).  A run
started again in the same output directory resumes from its newest
snapshot; SIGINT or SIGTERM snapshots after the step in flight and stops.
Weights are randomly initialized from the config's RNG_SEED, or with
--weights_file and --preload 1 or 2 the file's backbone and tail (1) or
everything but the predictors (2) are loaded: a state dict in the port's
layout (.pt, .npz) or a Solver snapshot.

    python tools/trainval_net_torch.py --db synthetic --net res101 --net_type image --iters 20 --batch_size 8
    python tools/trainval_net_torch.py --db synthetic --dbval synthetic --net res18 --fixed_blocks -1 --iters 40 --set TRAIN.SNAPSHOT_ITERS 20 TRAIN.DISPLAY 10
    python tools/trainval_net_torch.py --db synthetic --net res101 --net_type image --en_fpn 1 --iters 20 --batch_size 8
    python tools/trainval_net_torch.py --db synthetic --net res101 --net_type lidar --scale 0.5 --iters 20 --batch_size 8
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
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.cli import build_config, build_dataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import Solver, create_train_state

    cfg = build_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("trainval_net_torch: --device cuda but no CUDA device is visible")
    db = build_dataset(cfg, args.db_name, "train")
    loader = BatchLoader(db, cfg, batch_size=cfg.train.batch_size, device=device,
                         augment=cfg.train.augment_en, seed=cfg.rng_seed)
    val_loader = None
    if args.dbval_name:
        val_db = build_dataset(cfg, args.dbval_name, "val")
        val_loader = BatchLoader(val_db, cfg, batch_size=cfg.train.batch_size, device=device,
                                 augment=cfg.train.val_augment_en, seed=cfg.rng_seed + 1)
    model, _ = create_train_state(cfg, len(db.classes), device, seed=cfg.rng_seed)
    if device.type == "cuda":
        _, seconds, _ = _build.build()
        print(f"kernels: {_build.library_path()} (built in {seconds:.1f} s)")
    out_dir = os.path.join(args.out_dir, cfg.net_type, db.name)
    solver = Solver(cfg, model, loader, val_loader=val_loader, output_dir=out_dir,
                    pretrained_path=args.weights_file if cfg.preload else None)
    print(f"training {cfg.net_variant} {cfg.net_type} {cfg.compute_dtype} on {db.name} "
          f"({len(db)} frames, {len(db.classes)} classes, batch {cfg.train.batch_size}) for "
          f"{args.max_iters} steps on {device} -> {out_dir}")
    res = solver.train(max_iters=args.max_iters)
    ms = np.asarray(res["ms"])
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if len(ms):
        steady = ms[1:] if len(ms) > 1 else ms
        print(f"device: {name}; {steady.mean():.2f} ms/step on the device after the first "
              f"({ms[0]:.2f} ms); {res['frames_per_sec']:.2f} frames/s wall")
    print(f"done at iteration {res['step']}: {res['frames_per_sec']:.2f} frames/s, "
          f"final loss {res['losses'].get('total_loss')}")
    return res


if __name__ == "__main__":
    main()
