#!/usr/bin/env python
"""Re-evaluate cached detections: the port's copy of tools/reval.py.  It
reads the per-class, per-frame boxes that tools/test_net_torch.py pickles
(OUT_DIR/eval/DB/detections_torch.pkl) and recomputes AP per class and the
mAP against the dataset's ground truth, without the network.

    python tools/reval_torch.py output/eval/synthetic_image_val/detections_torch.pkl --net_type image
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Re-evaluate cached detections (PyTorch port)")
    p.add_argument("detections", type=str, help="path to detections_torch.pkl")
    p.add_argument("--db", dest="db_name", default="synthetic", type=str)
    p.add_argument("--net_type", default="image", type=str)
    p.add_argument("--eval_type", default=None, type=str,
                   help="2d | bev | bev_aa | 3d (default from config)")
    p.add_argument("--iou", default=None, type=float)
    p.add_argument("--data_dir", default=None, type=str)
    p.add_argument("--cache_dir", default=None, type=str)
    p.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from faster_rcnn_pytorch_multimodal_tpu_torch.cli import (
        args_to_train_ns,
        build_config,
        build_dataset,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import evaluate_class

    cfg = build_config(args_to_train_ns(args))
    db = build_dataset(cfg, args.db_name, "val")
    with open(args.detections, "rb") as f:
        all_boxes = pickle.load(f)

    num_classes = len(db.classes)
    bbox_elem = cfg.num_bbox_elem
    eval_type = args.eval_type or (cfg.lidar.eval_type if cfg.net_type == "lidar" else "2d")
    iou_t = args.iou if args.iou is not None else (0.7 if cfg.net_type == "lidar" else 0.5)

    gt_frames, detections = {}, {j: [] for j in range(1, num_classes)}
    n_frames = min(len(db), len(all_boxes[1]))
    for i in range(n_frames):
        fid = f"frame_{i:06d}"
        gt = db.frame(i, augment=False)["gt_boxes"]
        gt_frames[fid] = {"boxes": gt[:, :bbox_elem], "cls": gt[:, -1].astype(int)}
        for j in range(1, num_classes):
            for row in np.atleast_2d(all_boxes[j][i]) if len(all_boxes[j][i]) else []:
                detections[j].append({"frame_id": fid, "bbox": row[:bbox_elem],
                                      "confidence": row[-1]})

    ap = {}
    for j in range(1, num_classes):
        gtc = {fid: {"boxes": g["boxes"][g["cls"] == j]} for fid, g in gt_frames.items()}
        ap[j] = evaluate_class(detections[j], gtc, iou_thresh=iou_t, eval_type=eval_type)
        print(f"class {db.classes[j]}: AP={ap[j]['ap']:.4f} "
              f"(tp={ap[j]['tp']} fp={ap[j]['fp']} npos={ap[j]['npos']})")
    m_ap = float(np.mean([r["ap"] for r in ap.values()]))
    print(f"mAP ({eval_type} @ {iou_t}): {m_ap:.4f}")
    return {"ap": ap, "mAP": m_ap}


if __name__ == "__main__":
    main()
