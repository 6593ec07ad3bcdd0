#!/usr/bin/env python
"""One frame through the PyTorch port of the detector, its detections drawn
to a PNG: the port's copy of tools/demo.py (the same flags, plus --device).

The frame is a dataset frame (--frame) or a raw image (--image, read with
cv2 and normalized on the host, as tools/demo.py does); the weights are a
state dict in the port's layout (.pt, .npz) or a Solver snapshot
(--weights_file), else the random initialization of seed 0.  The
detections over --thresh are printed by class and drawn coloured by
UC.SORT_TYPE (--class_colors 1: one tab10 colour a class).  As in
tools/demo.py only image nets are drawn: the dataset's LiDAR frames hold
points, not the raster the network reads, and tools/demo.py reads a
frame's `data`.

    python tools/demo_torch.py --net res101 --weights_file output/image/synthetic_image_train/checkpoints/iter_20 --out demo_out.png
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Faster R-CNN demo (PyTorch port)")
    p.add_argument("--weights_file", default=None, type=str)
    p.add_argument("--db", dest="db_name", default="synthetic", type=str)
    p.add_argument("--net", default="res101", type=str)
    p.add_argument("--net_type", default="image", type=str)
    p.add_argument("--frame", default=0, type=int, help="dataset frame index")
    p.add_argument("--image", default=None, type=str, help="or a raw image path")
    p.add_argument("--thresh", default=0.5, type=float)
    p.add_argument("--out", default="demo_out.png", type=str)
    p.add_argument("--en_aleatoric", default=0, type=int)
    p.add_argument("--en_epistemic", default=0, type=int)
    p.add_argument("--en_fpn", default=0, type=int)
    p.add_argument("--en_full_net", default=1, type=int)
    p.add_argument("--uc_sort_type", default=None, type=str)
    p.add_argument("--class_colors", default=0, type=int,
                   help="1 = fixed tab10 color per class (demo_all_bboxes mode)")
    p.add_argument("--scale", default=None, type=float)
    p.add_argument("--data_dir", default=None, type=str)
    p.add_argument("--cache_dir", default=None, type=str)
    p.add_argument("--cfg", dest="cfg_file", default=None, type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; the CUDA kernels run only on 'cuda'")
    p.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.cli import (
        args_to_train_ns,
        build_config,
        build_dataset,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.inference import detect_batch, filter_batch
    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import UCDraws, build_detector
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import to_per_class_lists
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import read_weights
    from faster_rcnn_pytorch_multimodal_tpu_torch.utils import visualization as viz

    ns = args_to_train_ns(args)
    ns.fixed_blocks = None
    ns.iter = None
    cfg = build_config(ns)
    if cfg.net_type == "lidar":
        raise NotImplementedError(
            "demo_torch: LiDAR frames hold points, not the BEV raster the network reads "
            "(tools/demo.py reads frame['data'] too); use tools/test_net_torch.py --draw_det")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("demo_torch: --device cuda but no CUDA device is visible")
    db = build_dataset(cfg, args.db_name, "val")
    num_classes = len(db.classes)
    model = build_detector(cfg, num_classes, device, seed=0)
    if args.weights_file:
        model.load_state_dict(read_weights(args.weights_file), strict=True)
        print(f"loaded weights from {args.weights_file}")

    if args.image:
        import cv2

        raw = cv2.imread(args.image).astype(np.float32)
        img = (raw - np.asarray(cfg.pixel_means)) / np.asarray(cfg.pixel_stddevs)
        frame = {"data": img.astype(np.float32),
                 "window": np.array([0, img.shape[1], 0, img.shape[0]], np.float32)}
    else:
        frame = db.frame(args.frame, augment=False)

    draws = UCDraws(torch.Generator(device=device).manual_seed(1))
    out = detect_batch(model, {"data": frame["data"][None], "window": frame["window"][None]},
                       draws)
    filt = {k: v[0].cpu().numpy() for k, v in filter_batch(model, out, args.thresh).items()}
    uc = {k: v[0].cpu().numpy() for k, v in out.get("uncertainties", {}).items()}
    boxes_j, _ = to_per_class_lists(filt, uc, num_classes, cfg.num_bbox_elem)

    total = sum(len(boxes_j[j]) for j in range(1, num_classes))
    print(f"{total} detections over threshold {args.thresh}")
    for j in range(1, num_classes):
        for row in boxes_j[j]:
            print(f"  {db.classes[j]}: score={row[-1]:.3f} box={row[:-1].round(1)}")

    raw = np.asarray(frame["data"])
    if np.issubdtype(raw.dtype, np.integer):
        disp = raw.astype(np.float32)  # dataset frames are raw uint8
    else:
        disp = raw * np.asarray(cfg.pixel_stddevs) + np.asarray(cfg.pixel_means)
    canvas = disp[:, :, ::-1]  # BGR -> RGB
    for j in range(1, num_classes):
        if len(boxes_j[j]):
            canvas = viz.draw_detections_image(
                canvas, boxes_j[j], class_name=db.classes[j], sort_key=cfg.uc.sort_type,
                color=viz.TAB10[(j - 1) % len(viz.TAB10)] if args.class_colors else None)
    viz.save_image(canvas, args.out)
    print(f"wrote {args.out}")
    return boxes_j


if __name__ == "__main__":
    main()
