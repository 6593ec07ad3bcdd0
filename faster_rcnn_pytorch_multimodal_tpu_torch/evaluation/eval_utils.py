"""Host-side evaluation geometry and AP (the port's copy).

A copy of faster_rcnn_pytorch_multimodal_tpu/evaluation/eval_utils.py, the
whole module, numpy only: the polygon helpers, `iou` with `_iou_2d`,
`_aabb`, `_iou_bev`, `_iou_3d` (:29-168), `ap` (:170-186), the uncertainty
det-file surface (`uc_widths`, `extract_uncertainties`, `_infer_uc_keys`,
`get_labels_filename`, `find_rec`, `accumulate_scene_uncertainty`,
`write_scene_uncertainty`, `write_frame_uncertainty`,
`display_frame_counts`, `save_detection_results`, :188-355),
`evaluate_class` (:357-430) and `write_pr_pickle` (:432-449).

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
# Uncertainty det-file surface (ref waymo_eval.py:106, 148-155, 207-221 +
# the missing eval_utils functions it calls, SURVEY.md §2.14)
# ---------------------------------------------------------------------------

# det-file trailing-column order (matches data.db_base.UC_KEYS / the
# reference's stack_uncertainties dict insertion order, test.py:260-270)
UC_ORDER = (
    "a_entropy",
    "a_mutual_info",
    "a_cls_var",
    "a_bbox_var",
    "e_entropy",
    "e_mutual_info",
    "e_cls_var",
    "e_bbox_var",
)


def uc_widths(bbox_elem: int, num_classes: int) -> dict:
    """Column width of each uncertainty key in the det files."""
    return {
        "a_entropy": 1,
        "a_mutual_info": 1,
        "a_cls_var": num_classes,
        "a_bbox_var": bbox_elem,
        "e_entropy": 1,
        "e_mutual_info": 1,
        "e_cls_var": num_classes,
        "e_bbox_var": bbox_elem,
    }


def extract_uncertainties(
    bbox_elem: int,
    splitlines: list,
    num_classes: int = 2,
    keys: tuple | None = None,
) -> tuple:
    """Parse det-file trailing uncertainty columns (ref waymo_eval.py:106).

    splitlines: tokenized det-file lines [frame_id, score, b0..b_{E-1}, uc...].
    keys: which uncertainty keys are present; None = infer from the column
    count (enabled-UC flags determine the layout, like the reference's cfg).

    Returns (uc_avg, uncertainties):
      uncertainties: {key: (N, width) float array} per det line;
      uc_avg: {key: {} } per-scene accumulators the caller fills via
        uc_avg[key][scene] += uncertainties[key][i] (ref :148-155).
    """
    n = len(splitlines)
    n_lead = 2 + bbox_elem
    n_trail = (len(splitlines[0]) - n_lead) if n else 0
    widths = uc_widths(bbox_elem, num_classes)
    if keys is None:
        keys = _infer_uc_keys(n_trail, widths)
    uncertainties = {}
    col = n_lead
    for key in UC_ORDER:
        if key not in keys:
            continue
        w = widths[key]
        arr = np.zeros((n, w), np.float64)
        for i, toks in enumerate(splitlines):
            arr[i] = [float(t) for t in toks[col : col + w]]
        uncertainties[key] = arr
        col += w
    uc_avg = {key: {} for key in uncertainties}
    return uc_avg, uncertainties


def _infer_uc_keys(n_trail: int, widths: dict) -> tuple:
    """Infer the enabled-UC key set from the trailing column count.  Tries
    the reference's three common configs (aleatoric / epistemic / both)."""
    a_keys = ("a_entropy", "a_mutual_info", "a_cls_var", "a_bbox_var")
    e_keys = ("e_entropy", "e_mutual_info", "e_cls_var", "e_bbox_var")
    for cand in (a_keys + e_keys, a_keys, e_keys, ()):
        if sum(widths[k] for k in cand) == n_trail:
            return cand
    raise ValueError(
        f"cannot infer uncertainty layout from {n_trail} trailing columns"
    )


def get_labels_filename(db, eval_type: str) -> str:
    """The ground-truth labels file for an eval type (ref waymo_eval.py:87):
    '2d' reads the image labels, everything else the lidar labels."""
    import os

    base = getattr(db, "_devkit_path", getattr(db.cfg, "data_dir", "."))
    name = "image_labels.json" if eval_type == "2d" else "lidar_labels.json"
    return os.path.join(base, db.mode, "labels", name)


def find_rec(class_recs, token):
    """Frame record lookup by frame token (ref waymo_eval.py:141)."""
    if isinstance(class_recs, dict):
        return class_recs.get(token)
    for rec in class_recs:
        if rec.get("frame_id") == token or rec.get("idx") == token:
            return rec
    return None


def accumulate_scene_uncertainty(
    uc_avg: dict, uncertainties: dict, det_idx: int, scene: int
):
    """uc_avg[key][scene] += per-det uncertainty (ref waymo_eval.py:148-151)."""
    for key, val in uncertainties.items():
        acc = uc_avg[key]
        acc[scene] = acc.get(scene, 0.0) + val[det_idx]


def write_scene_uncertainty(uc_avg: dict, scene_dets: float, i) -> str:
    """Per-scene average uncertainty line (ref waymo_eval.py:207-212);
    '' when the scene produced no detections."""
    if not scene_dets:
        return ""
    parts = [f"scene_idx: {i} num_dets: {int(scene_dets)}"]
    for key in UC_ORDER:
        if key in uc_avg and i in uc_avg[key]:
            avg = np.atleast_1d(uc_avg[key][i] / scene_dets).ravel()
            parts.append(f"{key}: " + " ".join(f"{v:.10f}" for v in avg))
    return " ".join(parts) if len(parts) > 1 else ""


def write_frame_uncertainty(uc_frame: dict, frame_dets: float, fid) -> str:
    """Per-frame variant (ref waymo_eval.py write_frame_uncertainty)."""
    if not frame_dets:
        return ""
    parts = [f"frame_id: {fid} num_dets: {int(frame_dets)}"]
    for key in UC_ORDER:
        if key in uc_frame and fid in uc_frame[key]:
            avg = np.atleast_1d(uc_frame[key][fid] / frame_dets).ravel()
            parts.append(f"{key}: " + " ".join(f"{v:.10f}" for v in avg))
    return " ".join(parts) if len(parts) > 1 else ""


def display_frame_counts(tp_frame, fp_frame, npos_frame) -> str:
    """Frame-level TP/FP/npos table (ref waymo_eval.py:215-221)."""
    lines = []
    for fid in sorted(npos_frame):
        lines.append(
            f"frame {fid}: tp {int(tp_frame.get(fid, 0))} "
            f"fp {int(fp_frame.get(fid, 0))} npos {int(npos_frame[fid])}"
        )
    out = "\n".join(lines)
    print(out)
    return out


def save_detection_results(lines: list, out_dir: str, out_file: str) -> str:
    """ref waymo_eval.py:218 (eval_utils.save_detection_results)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, out_file)
    with open(path, "w") as f:
        for line in lines:
            f.write(str(line) + "\n")
    return path


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


def write_pr_pickle(output_dir: str, cls_name: str, results: list) -> str:
    """Persist the per-class PR curve after eval: `<cls>_pr.pkl` holding
    {'rec', 'prec', 'ap'} with one entry per difficulty level, matching the
    reference's artifact (ref lib/datasets/waymo_lidb.py:601-602) that
    parity comparison plots consume."""
    import os
    import pickle

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{cls_name}_pr.pkl")
    payload = {
        "rec": [r["recall"] for r in results],
        "prec": [r["precision"] for r in results],
        "ap": np.asarray([r["ap"] for r in results]),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path
