"""The serving loop as library functions: frames -> detections -> AP.

Port of the frame loop of tools/test_net.py:48-290: a batch from the port's
BatchLoader goes through `detect_batch` (the detector's forward_test),
`filter_batch` (per-class threshold + NMS, one batched launch),
`to_per_class_lists` per frame, and `evaluate_class` per class.  A LiDAR
batch arrives with its BEV raster already on the device (the loader runs
`voxelize_bev` there).  Used by tools/test_net_torch.py and chip_smoke.py.

Stages are timed with `DeviceTimer`: CUDA events on a card (host clock on
the CPU), so the numbers are device time, not enqueue time.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import evaluate_class
from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import FasterRCNN
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import (
    filter_detections,
    to_per_class_lists,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import DeviceTimer


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on_device(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def detect_batch(model: FasterRCNN, batch: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """One loader batch through forward_test: `data` uint8 NHWC frames
    (numpy) or a BEV raster (a tensor, already on the model's device), and
    `window`."""
    device = model_device(model)
    images = _on_device(batch["data"], device)
    window = _on_device(np.asarray(batch["window"], np.float32), device)
    with torch.inference_mode():
        return model.forward_test(images, window)


def filter_batch(model: FasterRCNN, out: Dict[str, torch.Tensor], thresh: float) -> Dict[str, torch.Tensor]:
    """Final per-class detections of a batch: dict of (B, K, max_dets, .)."""
    cfg = model.cfg
    with torch.inference_mode():
        return filter_detections(
            out["cls_prob"],
            out["bbox_pred"],
            out["roi_valid"],
            num_classes=model.num_classes,
            bbox_elem=cfg.num_bbox_elem,
            max_dets=cfg.test.max_dets,
            thresh=thresh,
            nms_thresh=cfg.test.nms_thresh,
            is_lidar=cfg.net_type == "lidar",
            rotated_nms=cfg.test.rotated_nms,
        )


def frame_id(db, i: int) -> str:
    """The roidb's frame_id when the dataset has one, else frame_<i>."""
    roidb = getattr(db, "roidb", None)
    if roidb is not None and i < len(roidb):
        return str(roidb[i].get("frame_id", f"frame_{i:06d}"))
    return f"frame_{i:06d}"


def eval_settings(cfg) -> tuple:
    """(eval_type, IoU threshold) of the self-contained eval, as
    tools/test_net.py:277-278 chooses them: 2d @ 0.5 for images; for lidar
    LIDAR.EVAL_TYPE, at 0.5 for '3d' and 0.7 otherwise."""
    if cfg.net_type != "lidar":
        return "2d", 0.5
    eval_type = cfg.lidar.eval_type
    return eval_type, 0.5 if eval_type == "3d" else 0.7


def evaluate(model: FasterRCNN, loader, db, n_frames: int, thresh: float) -> Dict:
    """Run n_frames through the serving path and score them against the
    dataset's ground truth (the self-contained eval of tools/test_net.py
    for datasets without a roidb: GT and detections stay in network space,
    image pixels or LiDAR voxel-grid units).

    The loader must yield frames in dataset order from frame 0
    (shuffle=False).  Returns per-frame per-class boxes, AP per class, mAP
    with its eval type and IoU threshold, per-batch device milliseconds of
    the voxelizer (lidar), detection and filtering, whether every float
    output was finite, and the fewest valid proposals of any frame."""
    num_classes, bbox_elem = model.num_classes, model.cfg.num_bbox_elem
    eval_type, iou_thresh = eval_settings(model.cfg)
    timer = DeviceTimer(model_device(model))
    all_boxes: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
    detections = {j: [] for j in range(1, num_classes)}
    gt_frames = {}
    raster_ms, detect_ms, filter_ms = [], [], []
    finite, min_proposals = True, None
    frame_idx = 0
    while frame_idx < n_frames:
        batch = loader.next()
        if getattr(loader, "last_raster_ms", None) is not None:
            raster_ms.append(loader.last_raster_ms)
        timer.start()
        out = detect_batch(model, batch)
        detect_ms.append(timer.stop())
        timer.start()
        filt = filter_batch(model, out, thresh)
        filter_ms.append(timer.stop())
        finite &= all(bool(torch.isfinite(v).all()) for v in out.values() if v.is_floating_point())
        n_prop = int(out["roi_valid"].sum(1).min())
        min_proposals = n_prop if min_proposals is None else min(min_proposals, n_prop)
        filt = {k: v.cpu().numpy() for k, v in filt.items()}
        for i in range(batch["window"].shape[0]):
            if frame_idx >= n_frames:
                break
            boxes_j, _ = to_per_class_lists(
                {k: v[i] for k, v in filt.items()}, {}, num_classes, bbox_elem
            )
            fid = frame_id(db, frame_idx)
            for j in range(1, num_classes):
                all_boxes[j].append(boxes_j[j])
                for row in boxes_j[j]:
                    detections[j].append(
                        {"frame_id": fid, "bbox": row[:bbox_elem], "confidence": row[-1]}
                    )
            gt = db.frame(frame_idx, augment=False)["gt_boxes"]
            gt_frames[fid] = {"boxes": gt[:, :bbox_elem], "cls": gt[:, -1].astype(int)}
            frame_idx += 1

    ap = {}
    for j in range(1, num_classes):
        gtc = {fid: {"boxes": g["boxes"][g["cls"] == j]} for fid, g in gt_frames.items()}
        ap[j] = evaluate_class(detections[j], gtc, iou_thresh=iou_thresh, eval_type=eval_type)
    return {
        "all_boxes": all_boxes,
        "ap": ap,
        "mAP": float(np.mean([r["ap"] for r in ap.values()])) if ap else 0.0,
        "eval_type": eval_type,
        "iou_thresh": iou_thresh,
        "raster_ms": raster_ms,
        "detect_ms": detect_ms,
        "filter_ms": filter_ms,
        "frames": n_frames,
        "finite": finite,
        "min_proposals": min_proposals,
    }
