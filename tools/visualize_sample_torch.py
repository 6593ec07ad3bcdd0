#!/usr/bin/env python
"""Draw one dataset frame with its ground truth: the port of
tools/visualize_sample.py (ref tools/visualize_sample.py).

A LiDAR frame's points are rasterized by the port's voxelize_bev on the
card (K3; `--device cpu`: its plain twin) for display.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--db", dest="db_name", default="synthetic", type=str)
    p.add_argument("--net_type", default="image", type=str)
    p.add_argument("--frame", default=0, type=int)
    p.add_argument("--augment", default=0, type=int)
    p.add_argument("--out", default="sample.png", type=str)
    p.add_argument("--data_dir", default=None, type=str)
    p.add_argument("--cache_dir", default=None, type=str)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where a LiDAR frame is rasterized (the card unless the CPU is asked for)")
    p.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    from faster_rcnn_pytorch_multimodal_tpu_torch.cli import (
        args_to_train_ns,
        build_config,
        build_dataset,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.utils import visualization as viz

    cfg = build_config(args_to_train_ns(args))
    db = build_dataset(cfg, args.db_name, "train")
    frame = db.frame(args.frame, augment=bool(args.augment))
    if cfg.net_type == "lidar":
        if "data" in frame:
            bev = np.asarray(frame["data"])
        else:
            import torch

            from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import (
                raster_kwargs,
                voxelize_bev,
            )

            pts = torch.from_numpy(frame["points"])[None].to(args.device)
            bev = voxelize_bev(pts, torch.ones(pts.shape[:2], dtype=torch.bool, device=pts.device),
                               **raster_kwargs(cfg, float(cfg.train.scales[0])))[0].cpu().numpy()
        canvas = viz.draw_detections_bev(bev, np.zeros((0, 8)), gt7=frame["gt_boxes"])
    else:
        d = np.asarray(frame["data"])
        disp = (
            d.astype(np.float32)
            if d.dtype == np.uint8
            else d * np.asarray(cfg.pixel_stddevs) + np.asarray(cfg.pixel_means)
        )
        canvas = viz.draw_bounding_boxes(disp[:, :, ::-1], frame["gt_boxes"], db.classes)
    viz.save_image(canvas, args.out)
    print(f"wrote {args.out} ({len(frame['gt_boxes'])} GT boxes)")
    return canvas


if __name__ == "__main__":
    main()
