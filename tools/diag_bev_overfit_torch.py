#!/usr/bin/env python
"""Diagnose from-scratch BEV convergence on ONE frozen synthetic frame: the
port of tools/diag_bev_overfit.py.

Overfit a single synthetic lidar frame (the DEBUG.FREEZE_DB scenario) and
report, stage by stage, where recall dies:

  A. anchor grid vs GT: per-GT best IoU + counts over the RPN pos/neg
     thresholds (anchor-shape vs synthetic-box-shape sanity),
  B. anchor_target: fg/bg sample counts actually fed to the RPN loss,
  C. training loop: losses + RPN proposal recall@0.5 every eval_every
     iters (proposals from the current weights on the SAME frame), the
     final detections' AP@0.5 and each GT's best 3D IoU.

Stages A and B print what JAX's tool prints, line for line.  Runs on the
card unless `--device cpu`.

Usage: python tools/diag_bev_overfit_torch.py --iters 600 --eval_every 100
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def build_cfg(net: str, substride: int = 1, pos: float = -1.0, neg: float = -1.0,
              freeze_ind: int = -1):
    from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list, default_config

    return cfg_from_list(
        default_config(),
        (
            "NET_TYPE", "lidar",
            "NET_VARIANT", net,
            "TRAIN.SCALES", "(0.5,)",
            "TEST.SCALES", "(0.5,)",  # eval on the SAME frozen frame
            "TRAIN.RPN_POST_NMS_TOP_N", "512",
            "STATIC.NMS_PRE_TRAIN", "1024",
            "STATIC.MAX_GT", "16",
            "STATIC.MAX_POINTS", "16384",
            "RESNET.FIXED_BLOCKS", "-1",  # from scratch: BN must train
            "DEBUG.FREEZE_DB", "True",
            "LIDAR.ANCHOR_SUBSTRIDE", str(substride),
            "LIDAR.RPN_POSITIVE_OVERLAP", str(pos),
            "LIDAR.RPN_NEGATIVE_OVERLAP", str(neg),
        )
        + (("DEBUG.FREEZE_DB_INDS", str(freeze_ind)) if freeze_ind >= 0 else ()),
    )


def frozen_batch(cfg, device):
    """The frozen frame's batch of one (the loader's raster on `device`)."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.loader import BatchLoader
    from faster_rcnn_pytorch_multimodal_tpu_torch.data.synthetic import SyntheticDataset
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import batch_to_device

    ds = SyntheticDataset(cfg, num_frames=8, num_classes=2, seed=0)
    loader = BatchLoader(ds, cfg, batch_size=1, device=device, seed=0, augment=False)
    return batch_to_device(loader.next(), device)


def _thresholds(cfg):
    pos = cfg.lidar.rpn_positive_overlap
    if pos <= 0:
        pos = cfg.train.rpn_positive_overlap
    neg = cfg.lidar.rpn_negative_overlap
    if neg <= 0:
        neg = cfg.train.rpn_negative_overlap
    return pos, neg


def coverage(cfg, batch) -> Dict[str, object]:
    """Stage A: the anchor grid over the raster's feature map and each GT's
    best IoU with it and its counts over the thresholds; prints JAX's lines."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import (
        build_anchor_grid,
        feat_stride,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.iou import (
        bbox_3d_to_bev_aabb,
        bbox_overlaps,
    )

    raster = batch["data"]
    gt7 = batch["gt_boxes"][0]
    gt_mask = batch["gt_mask"][0].cpu().numpy().astype(bool)
    gt_bev = bbox_3d_to_bev_aabb(gt7[:, :7]).cpu().numpy()[gt_mask]
    n_gt = int(gt_mask.sum())
    print(f"\n=== frame 0: {n_gt} GT boxes (voxel-grid BEV AABBs) ===")
    for i, b in enumerate(gt_bev):
        print(
            f"  gt[{i}] x1y1x2y2=({b[0]:.1f},{b[1]:.1f},{b[2]:.1f},{b[3]:.1f})"
            f" wh=({b[2] - b[0]:.1f},{b[3] - b[1]:.1f})"
        )
    stride = feat_stride(cfg)
    fh, fw = raster.shape[1] // stride, raster.shape[2] // stride
    anchors_bev, _ = build_anchor_grid(cfg, fh, fw, float(cfg.train.scales[0]))
    print(f"\n=== A. anchors: {anchors_bev.shape[0]} lanes (feat {fh}x{fw}, stride {stride}) ===")
    for i, a in enumerate(anchors_bev[: cfg.num_anchors_3d]):
        print(f"  anchor[{i}] wh=({a[2] - a[0]:.1f},{a[3] - a[1]:.1f})")
    iou = bbox_overlaps(torch.from_numpy(anchors_bev), torch.from_numpy(gt_bev)).numpy()
    pos, neg = _thresholds(cfg)
    counts = []
    for i in range(n_gt):
        col = iou[:, i]
        counts.append((float(col.max()), int((col >= pos).sum()), int((col >= 0.5).sum()),
                       int((col >= neg).sum())))
        print(
            f"  gt[{i}] best IoU {col.max():.3f} | >= {pos}: {(col >= pos).sum()}"
            f" | >= 0.5: {(col >= 0.5).sum()} | >= {neg}: {(col >= neg).sum()}"
        )
    return {"anchors": anchors_bev, "gt_bev": gt_bev, "gt_mask": gt_mask, "counts": counts}


def sample_counts(cfg, batch, anchors_bev: np.ndarray) -> Dict[str, int]:
    """Stage B: anchor_target on frame 0 (keys from a generator seeded 0;
    the counts do not depend on them) on the batch's device; prints JAX's
    line."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.iou import bbox_3d_to_bev_aabb
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.targets import anchor_target

    device = batch["gt_boxes"].device
    gt = batch["gt_boxes"][:1]
    gt_bev = torch.cat([bbox_3d_to_bev_aabb(gt[..., :7]), gt[..., 7:8]], dim=-1)
    anchors = torch.from_numpy(anchors_bev).to(device)
    g = torch.Generator(device=device).manual_seed(0)
    keys = [torch.rand((1, anchors.shape[0]), generator=g, device=device) for _ in range(2)]
    pos, neg = _thresholds(cfg)
    at = anchor_target(
        anchors, gt_bev, batch["gt_mask"][:1], batch["window"][:1], *keys,
        rpn_batchsize=cfg.train.rpn_batchsize, fg_fraction=cfg.train.rpn_fg_fraction,
        positive_overlap=pos, negative_overlap=neg,
        clobber_positives=cfg.train.rpn_clobber_positives,
    )
    labels = at.labels[0].cpu().numpy()
    out = {"fg": int((labels == 1).sum()), "bg": int((labels == 0).sum()), "K": labels.shape[0]}
    print(f"\n=== B. anchor_target: fg={out['fg']} bg={out['bg']} of K={out['K']} slots ===")
    return out


def recall(model, cfg, batch, stage_a) -> tuple:
    """Proposal recall@0.5 of the GT, each GT's best proposal IoU, the final
    class-1 detections' AP@0.5 (BEV AABB IoU) and each GT's best 3D IoU."""
    import torch

    from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import ap as ap_fn
    from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import iou as eval_iou
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import filter_detections
    from faster_rcnn_pytorch_multimodal_tpu_torch.ops.iou import (
        bbox_3d_to_bev_aabb,
        bbox_overlaps,
    )
    from faster_rcnn_pytorch_multimodal_tpu_torch.training.solver import detect

    gt_bev, gt_mask = stage_a["gt_bev"], stage_a["gt_mask"]
    n_gt = len(gt_bev)
    out = detect(model, batch["data"], batch["window"])
    rois = out["rois"][0].float().cpu()
    best = bbox_overlaps(rois, torch.from_numpy(gt_bev)).numpy().max(axis=0)
    filt = filter_detections(
        out["cls_prob"][:1], out["bbox_pred"][:1], out["roi_valid"][:1], num_classes=2,
        bbox_elem=7, max_dets=cfg.test.max_dets, thresh=0.0, nms_thresh=cfg.test.nms_thresh,
        is_lidar=True, rotated_nms=cfg.test.rotated_nms)
    keep = filt["valid"][0, 1].cpu().numpy().astype(bool)
    boxes7 = filt["boxes"][0, 1].float().cpu().numpy()[keep]
    scores = filt["scores"][0, 1].float().cpu().numpy()[keep]
    dets_bev = (bbox_3d_to_bev_aabb(torch.from_numpy(boxes7)).numpy() if len(boxes7)
                else np.zeros((0, 4)))
    ap = 0.0
    if len(dets_bev):
        order = np.argsort(-scores)
        taken = np.zeros(n_gt, bool)
        tp = np.zeros(len(order))
        ious = bbox_overlaps(torch.from_numpy(dets_bev).float(), torch.from_numpy(gt_bev)).numpy()
        for r, d in enumerate(order):
            j = int(ious[d].argmax())
            if ious[d, j] >= 0.5 and not taken[j]:
                taken[j] = True
                tp[r] = 1.0
        fp = 1.0 - tp
        rec = np.cumsum(tp) / max(n_gt, 1)
        prec = np.cumsum(tp) / np.maximum(np.cumsum(tp) + np.cumsum(fp), 1e-9)
        ap = float(ap_fn(rec, prec))
    gt7 = batch["gt_boxes"][0, :, :7].cpu().numpy()[gt_mask]
    best3d = np.zeros(n_gt)
    for b7 in boxes7:
        best3d = np.maximum(best3d, eval_iou(gt7, b7, "3d"))
    return float((best >= 0.5).mean()), best, ap, best3d


def overfit(cfg, batch, stage_a, iters: int, eval_every: int, device) -> list:
    """Stage C: `iters` steps on the frozen batch (the step's draws from
    step_generator(0, step)), each eval_every-th (and the first) logged."""
    from faster_rcnn_pytorch_multimodal_tpu_torch.training import solver as S

    model, optimizer = S.create_train_state(cfg, 2, device, seed=0)
    step = S.make_train_step(model, optimizer)
    print(f"\n=== C. overfit {iters} iters (lr={cfg.train.learning_rate}) ===")
    log = []
    for it in range(1, iters + 1):
        draws = S.draw_train_keys(model, batch, S.step_generator(0, it - 1, device))
        losses, _ = step(batch, draws)
        if it % eval_every == 0 or it == 1:
            r, best, ap, best3d = recall(model, cfg, batch, stage_a)
            ls = {k: float(v) for k, v in losses.items()}
            log.append({"iter": it, "losses": ls, "recall": r, "ap": ap})
            print(
                f"  iter {it:4d} total={ls['total_loss']:.4f}"
                f" rpn_ce={ls['rpn_cross_entropy']:.4f}"
                f" rpn_box={ls['rpn_loss_box']:.4f}"
                f" ce={ls['cross_entropy']:.4f} box={ls['loss_box']:.4f}"
                f" | RPN recall@0.5 {r:.2f}"
                f" mAP@0.5 {ap:.3f}"
                f" (per-gt best IoU {np.round(best, 2)}"
                f" 3d {np.round(best3d, 2)})"
            )
    return log


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--eval_every", type=int, default=100)
    ap.add_argument("--net", default="res18")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--substride", type=int, default=1)
    ap.add_argument("--pos", type=float, default=-1.0)
    ap.add_argument("--neg", type=float, default=-1.0)
    ap.add_argument("--freeze_ind", type=int, default=-1,
                    help="DEBUG.FREEZE_DB_INDS (suite bev_overfit uses 0)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (the card unless the CPU is asked for)")
    args = ap.parse_args(argv)

    import torch

    cfg = build_cfg(args.net, args.substride, args.pos, args.neg, args.freeze_ind)
    if args.lr is not None:
        from faster_rcnn_pytorch_multimodal_tpu_torch.config import cfg_from_list

        cfg = cfg_from_list(cfg, ("TRAIN.LEARNING_RATE", str(args.lr)))
    device = torch.device(args.device)
    batch = frozen_batch(cfg, device)
    print(f"raster {tuple(batch['data'].shape)} window {batch['window'][0].cpu().numpy()}")
    stage_a = coverage(cfg, batch)
    stage_b = sample_counts(cfg, batch, stage_a["anchors"])
    log = overfit(cfg, batch, stage_a, args.iters, args.eval_every, device)
    print("\ndone")
    return {"coverage": stage_a["counts"], "samples": stage_b, "log": log}


if __name__ == "__main__":
    main()
