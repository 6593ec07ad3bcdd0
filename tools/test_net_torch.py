#!/usr/bin/env python
"""Evaluate the PyTorch port of the detector (C4 on images or LiDAR BEV, or
with --en_fpn 1 the FPN image detector) on one device.

The flags are tools/test_net.py's, plus --device (the port's cli module).
The frame loop is faster_rcnn_pytorch_multimodal_tpu_torch.inference.evaluate:
BatchLoader (for lidar: points up, `voxelize_bev` on the device) ->
forward_test -> batched per-class NMS -> per-class lists, timed with CUDA
events on a card.  On --db synthetic the AP is the self-contained one (2d @
0.5 for images, LIDAR.EVAL_TYPE for lidar, in network space) and the
per-class lists go to detections_torch.pkl.  On a real database (--db kitti,
waymo, cadc) the boxes go back to meters or raw pixels, to detections.pkl
and to the per-class det files (uncertainty columns and per-scene averages
with UC on), and --eval_det runs the database's own difficulty-aware
evaluation (KITTI easy/moderate/hard, Waymo L1/L2;
inference.evaluate_roidb, after tools/test_net.py:176-273).  --data_dir
holds the database's tree (README "Datasets"); image databases need cv2.

--weights_file takes a state dict in the port's layout (a `.pt` written by
torch.save, an `.npz` of arrays keyed like the port's state_dict, or a
snapshot of tools/trainval_net_torch.py, OUT_DIR/NET_TYPE/DB/checkpoints/iter_<n>,
whose model entry is read); without one the detector is randomly
initialized from the config's RNG_SEED.  Orbax checkpoints of the JAX
package are not read here.

    python tools/test_net_torch.py --db synthetic --net res101 --net_type image --max_frames 16
    python tools/test_net_torch.py --db synthetic --net res101 --net_type lidar --scale 0.5 --max_frames 16
    python tools/test_net_torch.py --db synthetic --net res101 --net_type lidar --scale 0.5 --max_frames 16 --set TEST.ROTATED_NMS True TEST.NMS_THRESH 0.3
    python tools/test_net_torch.py --db synthetic --net res101 --net_type image --en_fpn 1 --max_frames 16
    python tools/test_net_torch.py --db waymo --data_dir data --net res101 --net_type lidar --scale 0.5 --weights_file output/lidar/waymo_lidar_train/checkpoints/iter_20
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    from faster_rcnn_pytorch_multimodal_tpu_torch.cli import test_parser

    return test_parser().parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.cli import (
        args_to_train_ns,
        build_config,
        build_dataset,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import evaluate, evaluate_roidb
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import read_weights

    cfg = build_config(args_to_train_ns(args))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("test_net_torch: --device cuda but no CUDA device is visible")
    db = build_dataset(cfg, args.db_name, "val")
    num_classes = len(db.classes)
    model = build_detector(cfg, num_classes, device, seed=cfg.rng_seed)
    if args.weights_file:
        model.load_state_dict(read_weights(args.weights_file), strict=True)
        print(f"loaded weights from {args.weights_file}")
    if device.type == "cuda":
        _, seconds, _ = _build.build()
        print(f"kernels: {_build.library_path()} (built in {seconds:.1f} s)")
    loader = BatchLoader(db, cfg, batch_size=args.batch_size, device=device, augment=False,
                         shuffle=False, seed=cfg.rng_seed)
    n_frames = len(db) if args.max_frames <= 0 else min(len(db), args.max_frames)

    res = evaluate(model, loader, db, n_frames, args.thresh)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ms = np.asarray(res["detect_ms"]) + np.asarray(res["filter_ms"])
    if res["raster_ms"]:
        ms = ms + np.asarray(res["raster_ms"])
        print(f"voxelize ms/batch: {np.round(res['raster_ms'], 3).tolist()}")
    print(f"device: {name}; batches of {args.batch_size}: "
          f"{ms.mean():.2f} ms/batch mean (first {ms[0]:.2f} ms), "
          f"{n_frames / (ms.sum() / 1e3):.2f} frames/s")
    if not res["finite"]:
        print("warning: non-finite detector outputs")

    out_dir = os.path.join(args.out_dir, "eval", db.name)
    if hasattr(db, "roidb"):  # a real database: its own files and evaluation
        return evaluate_roidb(db, cfg, res["all_boxes"], res["all_uc"], n_frames, out_dir,
                              bool(args.eval_det))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "detections_torch.pkl"), "wb") as f:
        pickle.dump(res["all_boxes"], f)

    if args.eval_det:
        for j, r in res["ap"].items():
            print(f"class {db.classes[j]}: AP={r['ap']:.4f} "
                  f"(tp={r['tp']} fp={r['fp']} npos={r['npos']})")
        print(f"mAP ({res['eval_type']} @ {res['iou_thresh']}): {res['mAP']:.4f}")
    return res["mAP"]


if __name__ == "__main__":
    main()
