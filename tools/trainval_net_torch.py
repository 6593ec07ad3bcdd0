#!/usr/bin/env python
"""Train the PyTorch port of the detector (C4 on images or LiDAR BEV
rasters, or with --en_fpn 1 the FPN image detector) on one device or, data
parallel, one rank a device.

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

Data parallelism (the JAX CLI's mesh over every device): MESH.DATA -1, the
default, trains over every visible GPU, the largest divisor of the batch
of them, one spawned rank each (nccl); on one card that is one process.
`--set MESH.DATA 2` on one visible GPU runs two ranks on it (gloo, printed
as such), and `--device cpu --set MESH.DATA 2` two CPU ranks.  Under
torchrun every process is one rank:

    torchrun --nproc_per_node 2 tools/trainval_net_torch.py --db synthetic --net res101 --batch_size 8

Rank 0 alone logs and snapshots; every rank resumes from rank 0's newest
snapshot; a SIGINT or SIGTERM to the launcher (or to any rank) stops
every rank after the same step.

Tensor and spatial parallelism (the JAX mesh's `model` axis): `--set
MESH.MODEL m` runs n x m ranks, n the data axis as above over the GPUs / m,
each model group of m ranks holding a shard of the RoI tail's channels
(`tp`); `MESH.SPATIAL True` also splits the backbone's rows over the group
(`tp+sp`; where the frame's height divides by m, else the frame stays
whole, said once).  On one GPU the n x m ranks share it over gloo (printed
as such); `--device cpu` runs them as CPU ranks:

    python tools/trainval_net_torch.py --db synthetic --net res18 --iters 4 --batch_size 2 --set MESH.DATA 2 MESH.MODEL 2 MESH.SPATIAL True
    python tools/trainval_net_torch.py --device cpu --db synthetic --net res18 --iters 2 --batch_size 2 --set MESH.DATA 1 MESH.MODEL 2 MESH.SPATIAL True STATIC.NMS_PRE_TRAIN 256 TRAIN.RPN_POST_NMS_TOP_N 64 TRAIN.ROI_BATCH_SIZE 32

Snapshots hold the whole model and optimizer, so a run resumes at another
mesh shape (2 x 2 from one process, or the reverse).
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
    """Train one process, or every rank of a data-parallel run: under
    torchrun (RANK and WORLD_SIZE set) this process is one rank; else the
    ranks data_world_size plans for MESH.DATA (every visible GPU by
    default) are spawned here after the kernels are built, or with one rank
    this process trains alone."""
    args = parse_args(argv)
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.cli import build_config
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel.multihost import spawn_ranks

    cfg = build_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("trainval_net_torch: --device cuda but no CUDA device is visible")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return train_rank(None, None, None, args)
    gpus = torch.cuda.device_count() if device.type == "cuda" else 1
    world = mesh.data_world_size(cfg, cfg.train.batch_size, gpus)
    if world == 1:
        return train_rank(0, 1, None, args)
    if device.type == "cuda":
        _, seconds, _ = _build.build()
        print(f"kernels: {_build.library_path()} (built in {seconds:.1f} s)")
    n, m = mesh.mesh_shape(cfg, cfg.train.batch_size, gpus)
    axes = f" ({n} data x {m} model)" if m > 1 else ""
    print(f"spawning {world} ranks{axes} for a global batch of {cfg.train.batch_size} on {gpus} "
          f"{device.type} device(s)")
    return spawn_ranks(train_rank, world, args)[0]


def train_rank(rank, world, init_method, args):
    """One rank's run (rank None: torchrun's environment): its rows of each
    batch, the Solver's steps, rank 0's logs and snapshots.  Returns the
    Solver's result."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.cli import build_config, build_dataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import Solver, create_train_state

    cfg = build_config(args)
    batch = cfg.train.batch_size
    dp = mesh.init_data_parallel(cfg, batch, rank=rank, world=world, init_method=init_method,
                                 device=args.device)
    device = torch.device(args.device) if dp is None else dp.device
    is_main = dp is None or dp.is_main
    try:
        db = build_dataset(cfg, args.db_name, "train")
        loader = BatchLoader(db, cfg, batch_size=batch, device=device,
                             augment=cfg.train.augment_en, seed=cfg.rng_seed, dp=dp)
        val_loader = None
        if args.dbval_name:
            val_db = build_dataset(cfg, args.dbval_name, "val")
            val_loader = BatchLoader(val_db, cfg, batch_size=batch, device=device,
                                     augment=cfg.train.val_augment_en, seed=cfg.rng_seed + 1,
                                     dp=dp)
        model, _ = create_train_state(cfg, len(db.classes), device, seed=cfg.rng_seed)
        if device.type == "cuda":
            # rank 0 builds (a spawning launcher built already), the others wait
            # for it: one nvcc run, not one a rank
            if is_main:
                _, seconds, _ = _build.build()
                print(f"kernels: {_build.library_path()} (built in {seconds:.1f} s)")
            mesh.barrier(dp)
        out_dir = os.path.join(args.out_dir, cfg.net_type, db.name)
        solver = Solver(cfg, model, loader, val_loader=val_loader, output_dir=out_dir,
                        pretrained_path=args.weights_file if cfg.preload else None, dp=dp)
        on = device if dp is None else (
            f"{dp.world} ranks = {dp.data_world} data x {dp.model} model ({dp.backend}), "
            f"rank 0 on {device}")
        if is_main:
            print(f"training {cfg.net_variant} {cfg.net_type} {cfg.compute_dtype} on {db.name} "
                  f"({len(db)} frames, {len(db.classes)} classes, batch {batch}) for "
                  f"{args.max_iters} steps on {on} -> {out_dir}")
        res = solver.train(max_iters=args.max_iters)
    finally:
        mesh.shutdown(dp)
    ms = np.asarray(res["ms"])
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if is_main and len(ms):
        steady = ms[1:] if len(ms) > 1 else ms
        reduce = (f"; gradient all-reduce {np.mean(res['reduce_ms']):.2f} ms/step"
                  if res["reduce_ms"] else "")
        print(f"device: {name}; {steady.mean():.2f} ms/step on the device after the first "
              f"({ms[0]:.2f} ms){reduce}; {res['frames_per_sec']:.2f} frames/s wall")
    if is_main:
        print(f"done at iteration {res['step']}: {res['frames_per_sec']:.2f} frames/s, "
              f"final loss {res['losses'].get('total_loss')}")
    return res


if __name__ == "__main__":
    main()
