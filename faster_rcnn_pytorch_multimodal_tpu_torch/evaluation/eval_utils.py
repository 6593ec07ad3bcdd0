"""Host-side evaluation geometry and AP (the port's copy).

A copy of faster_rcnn_pytorch_multimodal_tpu/evaluation/eval_utils.py:
the polygon helpers, `iou` with `_iou_2d`, `_aabb`, `_iou_bev`, `_iou_3d`
(:29-168), `ap` (:170-186) and `evaluate_class` (:357-430), numpy only.

  iou(BBGT, bb, eval_type) with eval_type in {'2d', 'bev', 'bev_aa', '3d'}
  ap(rec, prec)

Rotated-BEV intersection uses Sutherland-Hodgman convex clipping.
Conventions: 2D boxes are [x1, y1, x2, y2] with the +1 area term; 7-DoF
boxes are [xc, yc, zc, l, w, h, ry] with z the box center.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# polygon helpers
# ---------------------------------------------------------------------------


def box_to_corners_bev(box7: np.ndarray) -> np.ndarray:
    """(7,) [xc,yc,zc,l,w,h,ry] -> (4, 2) BEV corners (ccw)."""
    xc, yc, _, l, w, _, ry = box7[:7]
    c, s = np.cos(ry), np.sin(ry)
    dx = np.array([l, l, -l, -l]) / 2.0
    dy = np.array([w, -w, -w, w]) / 2.0
    return np.stack([dx * c - dy * s + xc, dx * s + dy * c + yc], axis=1)


def polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: clip `subject` polygon by convex `clip` polygon."""
    # ensure the clip polygon is counter-clockwise
    if polygon_signed_area(clip) < 0:
        clip = clip[::-1]
    output = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        edge = b - a
        input_list, output = output, []
        if not input_list:
            break
        for j in range(len(input_list)):
            p, q = input_list[j], input_list[(j + 1) % len(input_list)]
            p_in = _cross2(edge, p - a) >= 0
            q_in = _cross2(edge, q - a) >= 0
            if p_in:
                output.append(p)
                if not q_in:
                    output.append(_intersect(p, q, a, b))
            elif q_in:
                output.append(_intersect(p, q, a, b))
    return np.asarray(output) if output else np.zeros((0, 2))


def _cross2(u, v) -> float:
    return u[0] * v[1] - u[1] * v[0]


def _intersect(p, q, a, b):
    d1, d2 = q - p, b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-12:
        return q
    t = ((a[0] - p[0]) * d2[1] - (a[1] - p[1]) * d2[0]) / denom
    return p + t * d1


def polygon_signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def rotated_bev_intersection(a7: np.ndarray, b7: np.ndarray) -> float:
    pa = box_to_corners_bev(a7)
    pb = box_to_corners_bev(b7)
    return polygon_area(clip_polygon(pa, pb))


# ---------------------------------------------------------------------------
# IoU dispatch (the eval_utils.iou surface)
# ---------------------------------------------------------------------------


def iou(bbgt: np.ndarray, bb: np.ndarray, eval_type: str = "2d") -> np.ndarray:
    """Overlaps of many GT boxes vs ONE detection (ref waymo_eval.py:166-171).

    bbgt: (N, 4) for '2d', (N, 7) otherwise.  bb: (4,) or (7,).
    """
    bbgt = np.atleast_2d(np.asarray(bbgt, np.float64))
    bb = np.asarray(bb, np.float64).ravel()
    if bbgt.size == 0:
        return np.zeros((0,))
    if eval_type == "2d":
        return _iou_2d(bbgt, bb)
    if eval_type == "bev_aa":
        return _iou_2d(_aabb(bbgt), _aabb(bb[None])[0])
    if eval_type == "bev":
        return np.array([_iou_bev(g, bb) for g in bbgt])
    if eval_type == "3d":
        return np.array([_iou_3d(g, bb) for g in bbgt])
    raise ValueError(f"unknown eval_type {eval_type!r}")


def _iou_2d(bbgt: np.ndarray, bb: np.ndarray) -> np.ndarray:
    ixmin = np.maximum(bbgt[:, 0], bb[0])
    iymin = np.maximum(bbgt[:, 1], bb[1])
    ixmax = np.minimum(bbgt[:, 2], bb[2])
    iymax = np.minimum(bbgt[:, 3], bb[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inter = iw * ih
    union = (
        (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
        + (bbgt[:, 2] - bbgt[:, 0] + 1.0) * (bbgt[:, 3] - bbgt[:, 1] + 1.0)
        - inter
    )
    return inter / np.maximum(union, 1e-12)


def _aabb(boxes7: np.ndarray) -> np.ndarray:
    """Rotated 7-DoF -> axis-aligned BEV envelope (Graphics-Gems,
    ref bbox.py:256-296)."""
    out = np.zeros((len(boxes7), 4))
    for i, b in enumerate(boxes7):
        ex = (abs(b[3] * np.cos(b[6])) + abs(b[4] * np.sin(b[6]))) / 2.0
        ey = (abs(b[3] * np.sin(b[6])) + abs(b[4] * np.cos(b[6]))) / 2.0
        out[i] = [b[0] - ex, b[1] - ey, b[0] + ex, b[1] + ey]
    return out


def _iou_bev(a7: np.ndarray, b7: np.ndarray) -> float:
    inter = rotated_bev_intersection(a7, b7)
    area_a = a7[3] * a7[4]
    area_b = b7[3] * b7[4]
    return inter / max(area_a + area_b - inter, 1e-12)


def _iou_3d(a7: np.ndarray, b7: np.ndarray) -> float:
    """Rotated BEV intersection x z-overlap (ref tools/bbox_rot_debug.py:252)."""
    inter_bev = rotated_bev_intersection(a7, b7)
    za1, za2 = a7[2] - a7[5] / 2.0, a7[2] + a7[5] / 2.0
    zb1, zb2 = b7[2] - b7[5] / 2.0, b7[2] + b7[5] / 2.0
    zi = max(0.0, min(za2, zb2) - max(za1, zb1))
    inter = inter_bev * zi
    vol_a = a7[3] * a7[4] * a7[5]
    vol_b = b7[3] * b7[4] * b7[5]
    return inter / max(vol_a + vol_b - inter, 1e-12)


# ---------------------------------------------------------------------------
# AP
# ---------------------------------------------------------------------------


def ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """Interpolated AP.  Default: all-point (VOC-2010 style: area under the
    monotone-decreasing precision envelope; ref waymo_eval.py:223-247).
    use_07_metric: VOC-2007 11-point sampling (ref voc_eval.py:38-69) —
    used by the legacy pascal_voc evaluation for years < 2010."""
    if use_07_metric:
        total = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            total += p / 11.0
        return float(total)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


# ---------------------------------------------------------------------------
# Greedy matching evaluation (the skeleton shared by waymo/kitti/cadc eval)
# ---------------------------------------------------------------------------


def evaluate_class(
    detections: list,
    gt_frames: dict,
    iou_thresh: float,
    eval_type: str = "2d",
    difficulty_filter=None,
) -> dict:
    """Confidence-sorted greedy TP/FP matching (ref waymo_eval.py:134-247).

    detections: list of dicts {frame_id, bbox (4|7), confidence}.
    gt_frames: {frame_id: {"boxes": (N, 4|7), "ignore": (N,) bool,
                            "difficulty": (N,) int}}
    difficulty_filter: optional callable(difficulty_array) -> bool mask of
      GT counted for recall (L1/L2 style levels, ref waymo_eval.py:134-204).
    """
    matched = {
        fid: np.zeros(len(g["boxes"]), bool) for fid, g in gt_frames.items()
    }
    count_mask = {}
    npos = 0
    for fid, g in gt_frames.items():
        m = ~np.asarray(g.get("ignore", np.zeros(len(g["boxes"]), bool)))
        if difficulty_filter is not None and len(g["boxes"]):
            m &= difficulty_filter(np.asarray(g.get("difficulty", np.zeros(len(g["boxes"])))))
        count_mask[fid] = m
        npos += int(m.sum())

    dets = sorted(detections, key=lambda d: -d["confidence"])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    # frame-level TP/FP/npos counts (ref waymo_eval.py tp_frame/fp_frame/
    # npos_frame, :113-115, 186-201)
    tp_frame = {fid: 0 for fid in gt_frames}
    fp_frame = {fid: 0 for fid in gt_frames}
    npos_frame = {fid: int(m.sum()) for fid, m in count_mask.items()}
    for i, det in enumerate(dets):
        fid = det["frame_id"]
        g = gt_frames.get(fid)
        if g is None or len(g["boxes"]) == 0:
            fp[i] = 1.0
            if fid in fp_frame:
                fp_frame[fid] += 1
            continue
        overlaps = iou(g["boxes"], det["bbox"], eval_type)
        j = int(np.argmax(overlaps))
        if overlaps[j] >= iou_thresh:
            if not count_mask[fid][j]:
                continue  # matched an ignored/out-of-level GT: neither TP nor FP
            if not matched[fid][j]:
                matched[fid][j] = True
                tp[i] = 1.0
                tp_frame[fid] += 1
            else:
                fp[i] = 1.0  # duplicate detection
                fp_frame[fid] += 1
        else:
            fp[i] = 1.0
            fp_frame[fid] += 1

    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    rec = ctp / max(npos, 1)
    prec = ctp / np.maximum(ctp + cfp, np.finfo(np.float64).eps)
    return {
        "ap": ap(rec, prec) if npos > 0 else 0.0,
        "recall": rec,
        "precision": prec,
        "npos": npos,
        "tp": int(ctp[-1]) if len(dets) else 0,
        "fp": int(cfp[-1]) if len(dets) else 0,
        "tp_frame": tp_frame,
        "fp_frame": fp_frame,
        "npos_frame": npos_frame,
    }
