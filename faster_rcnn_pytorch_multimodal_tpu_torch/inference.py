"""The serving loop as library functions: frames -> detections -> AP.

Port of the frame loop of tools/test_net.py:48-290: a batch from the port's
BatchLoader goes through `detect_batch` (the detector's forward_test),
`filter_batch` (per-class threshold + NMS, one batched launch),
`to_per_class_lists` per frame, and `evaluate_class` per class.  A LiDAR
batch arrives with its BEV raster already on the device (the loader runs
`voxelize_bev` there).  Used by tools/test_net_torch.py and chip_smoke.py.

With uncertainty (the UC.* flags) forward_test also returns the
`uncertainties` and `rpn_uncertainties` dicts; `evaluate` draws each batch's
masks and normals from one generator and keeps every detection's
uncertainty rows by class, as the JAX package's test loop does.

`evaluate_roidb` writes a real database's result files and runs its own
difficulty-aware evaluation (tools/test_net.py:176-273).

Stages are timed with `DeviceTimer`: CUDA events on a card (host clock on
the CPU), so the numbers are device time, not enqueue time.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation import eval_utils as eu
from faster_rcnn_pytorch_multimodal_tpu_torch.evaluation.eval_utils import evaluate_class
from faster_rcnn_pytorch_multimodal_tpu_torch.models.detector import FasterRCNN, UCDraws
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.filter import (
    filter_detections,
    to_per_class_lists,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.utils.timer import DeviceTimer, span


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module) -> Iterator[torch.nn.Module]:
    """Within the block the model is in eval mode (live BN normalizes with
    its running statistics); then it is back in the mode it was in."""
    was_training = model.training
    with span("serve.eval_mode"):  # each switch walks every module
        model.eval()
    try:
        yield model
    finally:
        with span("serve.eval_mode"):
            model.train(was_training)


def _on_device(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def detect_batch(
    model: FasterRCNN, batch: Dict[str, object], draws: Optional[UCDraws] = None,
) -> Dict[str, torch.Tensor]:
    """One loader batch through forward_test, in eval mode: `data` uint8
    NHWC frames (numpy) or a BEV raster (a tensor, already on the model's
    device), and `window`; `draws` gives the uncertainty's masks and
    normals (see FasterRCNN.forward_test)."""
    with span("serve.detect"):
        device = model_device(model)
        with span("serve.h2d"):
            images = _on_device(batch["data"], device)
            window = _on_device(np.asarray(batch["window"], np.float32), device)
        with eval_mode(model), torch.inference_mode():
            return model.forward_test(images, window, draws)


def all_finite(out: Dict) -> bool:
    """Whether every floating tensor of a forward_test output, those of its
    uncertainty dicts too, is finite."""
    return all(all_finite(v) if isinstance(v, dict) else
               (not v.is_floating_point() or bool(torch.isfinite(v).all())) for v in out.values())


def filter_batch(model: FasterRCNN, out: Dict[str, torch.Tensor], thresh: float) -> Dict[str, torch.Tensor]:
    """Final per-class detections of a batch: dict of (B, K, max_dets, .)."""
    cfg = model.cfg
    with span("serve.filter"), torch.inference_mode():
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
    output was finite, and the fewest valid proposals of any frame.  With
    uncertainty also `all_uc`: per class, per frame, the kept detections'
    uncertainty rows (ops.filter.to_per_class_lists), each batch's masks and
    normals drawn from one generator seeded 0 on the model's device."""
    num_classes, bbox_elem = model.num_classes, model.cfg.num_bbox_elem
    eval_type, iou_thresh = eval_settings(model.cfg)
    device = model_device(model)
    timer = DeviceTimer(device)
    generator = torch.Generator(device=device).manual_seed(0)
    all_boxes: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
    all_uc: List[List[dict]] = [[] for _ in range(num_classes)]
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
        out = detect_batch(model, batch, UCDraws(generator))
        detect_ms.append(timer.stop())
        timer.start()
        filt = filter_batch(model, out, thresh)
        filter_ms.append(timer.stop())
        finite &= all_finite(out)
        n_prop = int(out["roi_valid"].sum(1).min())
        min_proposals = n_prop if min_proposals is None else min(min_proposals, n_prop)
        filt = {k: v.cpu().numpy() for k, v in filt.items()}
        uc = {k: v.cpu().numpy() for k, v in out.get("uncertainties", {}).items()}
        for i in range(batch["window"].shape[0]):
            if frame_idx >= n_frames:
                break
            boxes_j, uc_j = to_per_class_lists(
                {k: v[i] for k, v in filt.items()}, {k: v[i] for k, v in uc.items()},
                num_classes, bbox_elem,
            )
            fid = frame_id(db, frame_idx)
            for j in range(1, num_classes):
                all_boxes[j].append(boxes_j[j])
                all_uc[j].append(uc_j[j])
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
        "all_uc": all_uc,
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


def evaluate_roidb(db, cfg, all_boxes: List[List[np.ndarray]], all_uc: List[List[dict]],
                   n_frames: int, out_dir: str, eval_det: bool) -> Optional[Dict]:
    """The result files and difficulty-aware evaluation of a real database,
    as tools/test_net.py:176-273 makes them from `evaluate`'s per-class
    lists (network space):
      * the boxes back to meters (LiDAR, `db.boxes_voxel_grid_to_pc` at
        TEST.SCALES[0]) or to raw pixels (images, / scale);
      * detections.pkl, then the per-class det files through
        `write_lidar_results` / `write_image_results`, with the uncertainty
        columns when the detector has uncertainty;
      * with uncertainty, the det files read back and averaged per scene
        (`<class>_scene_uncertainty_results.txt`);
      * with eval_det, `db.evaluate_detections` on every GT box of the
        first n_frames roidb entries with its difficulty.
    Returns what evaluate_detections returns (None without eval_det)."""
    num_classes, bbox_elem = len(db.classes), cfg.num_bbox_elem
    is_lidar = cfg.net_type == "lidar"
    scale = float(cfg.test.scales[0])
    boxes = [[[] for _ in range(n_frames)] for _ in range(num_classes)]
    for j in range(1, num_classes):
        for i in range(n_frames):
            rows = (np.atleast_2d(np.array(all_boxes[j][i], np.float32))
                    if len(all_boxes[j][i]) else np.zeros((0, bbox_elem + 1), np.float32))
            if len(rows):
                if is_lidar:
                    rows[:, :7] = db.boxes_voxel_grid_to_pc(rows[:, :7], scale)
                else:
                    rows[:, :4] /= scale
            boxes[j][i] = rows

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "detections.pkl"), "wb") as f:
        pickle.dump(boxes, f)

    frame_ids = [frame_id(db, i) for i in range(n_frames)]
    have_uc = any(len(all_uc[j][i]) for j in range(1, num_classes) for i in range(n_frames))
    uc_arg = all_uc if have_uc else None
    if is_lidar:
        db.write_lidar_results(boxes, frame_ids, out_dir, uncertainties=uc_arg)
    else:
        db.write_image_results(boxes, frame_ids, out_dir, uncertainties=uc_arg)

    if have_uc:
        scene_of_frame = {frame_ids[i]: int(db.roidb[i].get("scene_idx", 0))
                          for i in range(n_frames)}
        for j in range(1, num_classes):
            det_path = os.path.join(out_dir, f"det_{db.mode}_{db.classes[j]}.txt")
            if not os.path.exists(det_path):
                continue
            with open(det_path) as f:
                splitlines = [line.strip().split(" ") for line in f if line.strip()]
            if not splitlines:
                continue
            uc_avg, uc_per_det = eu.extract_uncertainties(bbox_elem, splitlines,
                                                          num_classes=num_classes)
            det_cnt: Dict[int, int] = {}
            for i, toks in enumerate(splitlines):
                scene = scene_of_frame.get(toks[0], 0)
                eu.accumulate_scene_uncertainty(uc_avg, uc_per_det, i, scene)
                det_cnt[scene] = det_cnt.get(scene, 0) + 1
            lines = [eu.write_scene_uncertainty(uc_avg, det_cnt[s], s) for s in sorted(det_cnt)]
            lines = [line for line in lines if line]
            if lines:
                if cfg.debug.print_scene_result:
                    for line in lines:
                        print(line)
                p = eu.save_detection_results(
                    lines, out_dir, f"{db.classes[j]}_scene_uncertainty_results.txt")
                print(f"wrote scene uncertainty aggregates to {p}")

    if not eval_det:
        return None
    det_by_class = {j: [] for j in range(1, num_classes)}
    for j in range(1, num_classes):
        for i in range(n_frames):
            for row in boxes[j][i]:
                det_by_class[j].append({"frame_id": frame_ids[i],
                                        "bbox": row[:bbox_elem].copy(), "confidence": row[-1]})
    gt_by_class = {}
    for j in range(1, num_classes):
        gt_by_class[j] = {}
        for i in range(n_frames):
            e = db.roidb[i]
            sel = e["gt_classes"] == j
            gt_by_class[j][frame_ids[i]] = {
                "boxes": e["boxes"][sel],
                "difficulty": e.get("difficulty", np.zeros(sel.sum()))[sel]
                if len(e.get("difficulty", [])) == len(sel)
                else np.zeros(int(sel.sum())),
            }
    return db.evaluate_detections(det_by_class, gt_by_class, out_dir)
