"""Plain PyTorch operations of the reference detector, in float32 (float64
where noted).

A frozen copy of the semantics of the port's plain twins and host math
(`ops/anchors.py`, `ops/box_transform.py`, `ops/iou.py`, `ops/targets.py`,
`ops/losses.py`, `ops/filter.py`, the `*_plain` functions of `ops/nms.py`,
`ops/roi_align.py` and `ops/voxelize.py` of the port), which in turn copy
the JAX package's.  It imports nothing of either package, so later changes
to the program cannot move it.  Where the port's twin is known to be
inexact (the rotated IoU's 24-candidate sort, up to 0.32 off on collinear
sides), this file computes the quantity another way: rotated IoU here is
Sutherland-Hodgman clipping in float64.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

_EPS32 = 1.1920929e-07  # float32 machine epsilon: the floor on each GT's best IoU


# -- anchors (host numpy, as the port's ops/anchors.py) ------------------------


def _whctrs(a):
    w, h = a[2] - a[0] + 1, a[3] - a[1] + 1
    return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, xc, yc):
    ws, hs = ws[:, None], hs[:, None]
    return np.hstack((xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                      xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)))


def anchors_2d(height: int, width: int, stride: int, scales: Sequence[float],
               ratios: Sequence[float], frame_scale: float) -> np.ndarray:
    """(H * W * A, 4) float32 image anchors in (y, x, a) order."""
    base = np.array([0, 0, 15, 15], np.float64)
    w, h, xc, yc = _whctrs(base)
    ratios = np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    sc = np.asarray(scales, np.float64) * frame_scale
    cell = np.vstack([_mkanchors(rw * sc, rh * sc, rx, ry)
                      for rw, rh, rx, ry in map(_whctrs, _mkanchors(ws, hs, xc, yc))])
    sx, sy = np.meshgrid(np.arange(width) * stride, np.arange(height) * stride)
    shifts = np.stack((sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()), 1)
    return (cell[None] + shifts[:, None]).reshape(-1, 4).astype(np.float32)


def anchors_3d(height: int, width: int, stride: int, sizes_lwh, rotations, voxel_len: float,
               frame_scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """((N, 4) BEV footprints, (N, 7) [x, y, z, l, w, h, ry]) in voxel units, lanes
    (y, x, size, rotation); the last row and column (which the grid's half-open
    range leaves out at stride 1) by edge replication."""
    eff = voxel_len / frame_scale
    sizes = np.asarray(sizes_lwh, np.float64) / np.array([eff, eff, 1.0])
    rot = np.asarray(rotations, np.float64)
    xs = np.arange(0, width * stride - 1, stride, dtype=np.float64)
    ys = np.arange(0, height * stride - 1, stride, dtype=np.float64)
    yy, xx, ss, rr = np.meshgrid(ys, xs, np.arange(len(sizes)), np.arange(len(rot)),
                                 indexing="ij")
    a3 = np.zeros(xx.shape + (7,), np.float32)
    a3[..., 0], a3[..., 1], a3[..., 2] = xx, yy, sizes[0][2] / 2.0
    a3[..., 3:6] = sizes[ss.astype(np.int64)]
    a3[..., 6] = rot[rr.astype(np.int64)]
    a3 = a3.reshape(len(ys), len(xs), -1, 7)
    a3 = np.pad(a3, ((0, height - len(ys)), (0, width - len(xs)), (0, 0), (0, 0)), mode="edge")
    a3 = a3.reshape(-1, 7)
    swap = np.abs(np.sin(a3[:, 6])) > 0.5
    ex, ey = np.where(swap, a3[:, 4], a3[:, 3]), np.where(swap, a3[:, 3], a3[:, 4])
    bev = np.stack([a3[:, 0] - ex / 2.0, a3[:, 1] - ey / 2.0,
                    a3[:, 0] + ex / 2.0, a3[:, 1] + ey / 2.0], 1).astype(np.float32)
    return bev, a3


# -- boxes ------------------------------------------------------------------------


def bbox_transform(ex, gt):
    """Encode gt against ex: diagonal-normalized centers, log +1 sizes."""
    ew, eh = ex[..., 2] - ex[..., 0] + 1.0, ex[..., 3] - ex[..., 1] + 1.0
    gw, gh = gt[..., 2] - gt[..., 0] + 1.0, gt[..., 3] - gt[..., 1] + 1.0
    diag = torch.sqrt(ew ** 2 + eh ** 2)
    return torch.stack([(gt[..., 0] + 0.5 * gw - ex[..., 0] - 0.5 * ew) / diag,
                        (gt[..., 1] + 0.5 * gh - ex[..., 1] - 0.5 * eh) / diag,
                        torch.log(gw / ew), torch.log(gh / eh)], -1)


def bbox_transform_inv(boxes, deltas):
    """(..., 4) boxes and (..., 4K) deltas -> (..., 4K) boxes."""
    w, h = boxes[..., 2] - boxes[..., 0] + 1.0, boxes[..., 3] - boxes[..., 1] + 1.0
    diag = torch.sqrt(w ** 2 + h ** 2)[..., None]
    cx, cy = (boxes[..., 0] + 0.5 * w)[..., None], (boxes[..., 1] + 0.5 * h)[..., None]
    d = deltas.reshape(deltas.shape[:-1] + (-1, 4))
    pcx, pcy = d[..., 0] * diag + cx, d[..., 1] * diag + cy
    pw, ph = torch.exp(d[..., 2]) * w[..., None], torch.exp(d[..., 3]) * h[..., None]
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph],
                       -1).reshape(deltas.shape)


def clip_boxes(boxes, window):
    """Clamp (B, ..., 4K) boxes to each frame's window [x0, x1, y0, y1]."""
    b = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    shape = (window.shape[0],) + (1,) * (b.dim() - 2)
    x0, x1 = window[:, 0].reshape(shape), (window[:, 1] - 1.0).reshape(shape)
    y0, y1 = window[:, 2].reshape(shape), (window[:, 3] - 1.0).reshape(shape)
    out = torch.stack([torch.clamp(b[..., 0], x0, x1), torch.clamp(b[..., 1], y0, y1),
                       torch.clamp(b[..., 2], x0, x1), torch.clamp(b[..., 3], y0, y1)], -1)
    return out.reshape(boxes.shape)


def _bev_geometry(rois):
    lx, wy = rois[..., 2] - rois[..., 0] + 1.0, rois[..., 3] - rois[..., 1] + 1.0
    return lx, wy, rois[..., 0] + lx / 2.0, rois[..., 1] + wy / 2.0, torch.sqrt(lx ** 2 + wy ** 2)


def lidar_transform(rois, a3, gt7):
    """Encode 7-DoF gt against (BEV RoI, 3D anchor) pairs."""
    lx, wy, cx, cy, diag = _bev_geometry(rois)
    return torch.stack([(gt7[..., 0] - cx) / diag, (gt7[..., 1] - cy) / diag,
                        (gt7[..., 2] - a3[..., 2]) / a3[..., 5], torch.log(gt7[..., 3] / lx),
                        torch.log(gt7[..., 4] / wy), torch.log(gt7[..., 5] / a3[..., 5]),
                        gt7[..., 6]], -1)


def lidar_transform_inv(rois, a3, deltas):
    """(..., 7K) deltas -> 7-DoF boxes in voxel units."""
    lx, wy, cx, cy, diag = _bev_geometry(rois)
    hz, cz = a3[..., 5, None], a3[..., 2, None]
    d = deltas.reshape(deltas.shape[:-1] + (-1, 7))
    return torch.stack([d[..., 0] * diag[..., None] + cx[..., None],
                        d[..., 1] * diag[..., None] + cy[..., None],
                        d[..., 2] * hz + cz, torch.exp(d[..., 3]) * lx[..., None],
                        torch.exp(d[..., 4]) * wy[..., None], torch.exp(d[..., 5]) * hz,
                        d[..., 6]], -1).reshape(deltas.shape)


def overlaps_plus1(boxes, query):
    """IoU with +1 areas: (..., N, 4) x (..., K, 4) -> (..., N, K)."""
    area = (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)
    qarea = (query[..., 2] - query[..., 0] + 1.0) * (query[..., 3] - query[..., 1] + 1.0)
    b, q = boxes[..., :, None, :], query[..., None, :, :]
    iw = torch.clamp(torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0])
                     + 1.0, min=0.0)
    ih = torch.clamp(torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1])
                     + 1.0, min=0.0)
    inter = iw * ih
    return inter / (area[..., :, None] + qarea[..., None, :] - inter)


def bev_envelope(box7):
    """Axis-aligned BEV envelope of 7-DoF boxes."""
    c, s = torch.abs(torch.cos(box7[..., 6])), torch.abs(torch.sin(box7[..., 6]))
    ex = (box7[..., 3] * c + box7[..., 4] * s) / 2.0
    ey = (box7[..., 3] * s + box7[..., 4] * c) / 2.0
    return torch.stack([box7[..., 0] - ex, box7[..., 1] - ey, box7[..., 0] + ex,
                        box7[..., 1] + ey], -1)


def gather_lanes(x, idx):
    """x (B, N, ...) at idx (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


# -- targets ----------------------------------------------------------------------


class AnchorTargets(NamedTuple):
    sel: torch.Tensor
    labels: torch.Tensor
    targets: torch.Tensor
    inside: torch.Tensor
    outside: torch.Tensor


def anchor_target(anchors, gt, gt_mask, window, fg_keys, bg_keys, *, batch, fg_fraction,
                  pos, neg) -> AnchorTargets:
    """RPN labels for (N, 4) anchors against (B, G, 5) GT: fg = each GT's best
    inside anchor and IoU >= pos, bg = inside and IoU < neg; then the
    fg_fraction * batch fg lanes and the rest bg, each with the smallest keys."""
    b, n = fg_keys.shape
    dev = anchors.device
    win = window[:, None, :]
    inside = ((anchors[:, 0] >= win[..., 0]) & (anchors[:, 1] >= win[..., 2])
              & (anchors[:, 2] < win[..., 1]) & (anchors[:, 3] < win[..., 3]))
    any_gt = gt_mask.any(1, keepdim=True)
    ov = torch.where(gt_mask[:, None, :], overlaps_plus1(anchors, gt[..., :4]), -1.0)
    arg, mx = torch.argmax(ov, 2), torch.amax(ov, 2)
    labels = torch.where(inside & (mx < neg), 0.0, -1.0)
    col = torch.where(inside[..., None], ov, -2.0)
    best = torch.amax(col, 1).clamp(min=_EPS32)
    is_best = ((col == best[:, None, :]) & gt_mask[:, None, :]).any(2)
    labels = torch.where(inside & (is_best | (mx >= pos)), 1.0, labels)
    labels = torch.where(any_gt, labels, torch.where(inside, 0.0, -1.0))
    n_fg, k_bg = min(int(fg_fraction * batch), n), min(batch, n)
    fv, fs = torch.sort(torch.where(labels == 1.0, fg_keys, 2.0), dim=1, stable=True)
    fv, fs = fv[:, :n_fg], fs[:, :n_fg]
    f_ok = fv < 1.5
    bv, bs = torch.sort(torch.where(labels == 0.0, bg_keys, 2.0), dim=1, stable=True)
    bv, bs = bv[:, :k_bg], bs[:, :k_bg]
    b_ok = (bv < 1.5) & (torch.arange(k_bg, device=dev) < batch - f_ok.sum(1, keepdim=True))
    sel = torch.cat([fs, bs], 1)
    lab = torch.cat([torch.where(f_ok, 1.0, -1.0), torch.where(b_ok, 0.0, -1.0)], 1)
    matched = gather_lanes(gt[..., :4], gather_lanes(arg, sel))
    tg = torch.where(any_gt[..., None], bbox_transform(anchors[sel], matched), 0.0)
    inside_w = (lab == 1.0).float()[..., None].expand(-1, -1, 4)
    active = lab >= 0.0
    w = 1.0 / torch.clamp(active.sum(1).float(), min=1.0)
    outside_w = torch.where(active, w[:, None], 0.0)[..., None].expand(-1, -1, 4)
    return AnchorTargets(sel, lab, tg, inside_w, outside_w)


def _rank(cand, keys):
    key = torch.where(cand, keys, 2.0)
    perm = torch.sort(key, dim=-1, stable=True).indices
    lanes = torch.arange(key.shape[-1], device=key.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, lanes)


class ProposalTargets(NamedTuple):
    labels: torch.Tensor
    rois: torch.Tensor
    targets: torch.Tensor
    inside: torch.Tensor
    outside: torch.Tensor


def proposal_target(rois, valid, gt_bev, gt_mask, fg_keys, bg_keys, means, stds, *,
                    num_classes, elem, batch, fg_fraction, fg_thresh, bg_hi, bg_lo,
                    anchors3d=None, gt7=None, sample_boxes=None) -> ProposalTargets:
    """Sample `batch` RoIs a frame (fg up to fg_fraction: IoU >= fg_thresh; bg:
    bg_lo <= IoU < bg_hi; each list wrapped when it is short) and their
    normalized per-class targets, which stay differentiable in `rois`.  The
    IoUs that choose are those of `sample_boxes` (default: rois)."""
    b, r = valid.shape
    dev = rois.device
    boxes = rois.detach() if sample_boxes is None else sample_boxes
    ov = torch.where(gt_mask[:, None, :] & valid[..., None],
                     overlaps_plus1(boxes, gt_bev[..., :4]), -1.0)
    mx, assign = torch.amax(ov, 2), torch.argmax(ov, 2)
    fg = valid & (mx >= fg_thresh)
    bg = valid & (mx < bg_hi) & (mx >= bg_lo)
    nfg, nbg = fg.sum(1, keepdim=True), bg.sum(1, keepdim=True)
    quota = int(round(fg_fraction * batch))
    take = torch.where((nfg > 0) & (nbg > 0), torch.clamp(nfg, max=quota),
                       torch.where(nfg > 0, batch, 0))
    lanes = torch.arange(r, device=dev).expand(b, r)
    fg_list = torch.zeros_like(lanes).scatter_(1, _rank(fg, fg_keys), lanes)
    bg_list = torch.zeros_like(lanes).scatter_(1, _rank(bg, bg_keys), lanes)
    slot = torch.arange(batch, device=dev)
    is_fg = slot < take
    fg_at = torch.where(nfg > 0, slot % nfg.clamp(min=1), 0)
    bg_at = torch.where(nbg > 0, (slot - take) % nbg.clamp(min=1), 0)
    keep = torch.where(is_fg, gather_lanes(fg_list, fg_at), gather_lanes(bg_list, bg_at))
    ok = torch.where(is_fg, nfg > 0, nbg > 0)
    assigned = gather_lanes(assign, keep)
    labels = torch.where(is_fg & ok, gather_lanes(gt_bev[..., 4], assigned), 0.0).long()
    out_rois = gather_lanes(rois, keep)
    if gt7 is not None:
        tg = lidar_transform(out_rois, gather_lanes(anchors3d, keep),
                             gather_lanes(gt7[..., :7], assigned))
    else:
        tg = bbox_transform(out_rois, gather_lanes(gt_bev[..., :4], assigned))
    tg = (tg - means) / stds
    on = ((labels[..., None] == torch.arange(num_classes, device=dev))
          & (is_fg & ok & (labels > 0))[..., None])  # (B, S, K)
    targets = torch.where(on[..., None], tg[..., None, :], 0.0).reshape(b, batch, -1)
    inside = on[..., None].float().expand(-1, -1, -1, elem).reshape(b, batch, -1)
    return ProposalTargets(labels, out_rois, targets, inside, (inside > 0).float())


# -- losses -----------------------------------------------------------------------


def huber(d):
    """Smooth L1 (Huber, delta 1) elementwise."""
    a = d.abs()
    return torch.where(a < 1.0, 0.5 * d ** 2, a - 0.5)


# -- NMS (torchvision semantics: no +1, suppress when IoU > t) --------------------


def iou_plain(a, b):
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = torch.clamp(torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
                     - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
                     - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]), min=0.0)
    inter = iw * ih
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _corners(b5):
    """(..., 5) [xc, yc, l, w, ry] -> (..., 4, 2) counter-clockwise corners."""
    xc, yc, lx, wy, ry = b5.unbind(-1)
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    sx = torch.stack([lx, lx, -lx, -lx], -1) * 0.5
    sy = torch.stack([-wy, wy, wy, -wy], -1) * 0.5
    return torch.stack([xc[..., None] + sx * c - sy * s, yc[..., None] + sx * s + sy * c], -1)


def _clip(poly, n, p0, p1):
    """Sutherland-Hodgman: polygons (M, 8, 2) with n (M,) vertices, clipped to
    the left of the directed edges p0 -> p1 (M, 2)."""
    m, cap = poly.shape[0], poly.shape[1]
    idx = torch.arange(cap, device=poly.device)
    nxt = torch.where(idx[None] + 1 < n[:, None], idx[None] + 1, 0)
    q = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    e = (p1 - p0)[:, None]

    def side(v):
        w = v - p0[:, None]
        return e[..., 0] * w[..., 1] - e[..., 1] * w[..., 0]

    sp, sq = side(poly), side(q)
    live = idx[None] < n[:, None]
    pin, qin = sp >= 0, sq >= 0
    t = (sp / torch.where(sp - sq == 0, torch.ones_like(sp), sp - sq))[..., None]
    cross_pt = poly + t * (q - poly)
    # each vertex emits itself when inside, then the crossing when its edge crosses
    emit = torch.stack([live & pin, live & (pin != qin)], 2).reshape(m, 2 * cap)
    pts = torch.stack([poly, cross_pt], 2).reshape(m, 2 * cap, 2)
    pos = torch.cumsum(emit.long(), 1) - 1
    out = torch.zeros_like(poly)
    keep = emit & (pos < cap)
    rows = torch.arange(m, device=poly.device)[:, None].expand_as(pos)
    out[rows[keep], pos[keep]] = pts[keep]
    return out, torch.clamp(emit.sum(1), max=cap)


def rotated_iou(a5, b5):
    """IoU of rotated BEV boxes, pairwise: (N, 5) x (M, 5) -> (N, M), in
    float64, each pair relative to the first box's center."""
    n, m = a5.shape[0], b5.shape[0]
    a, b = a5.double(), b5.double()
    rel = b[None].expand(n, m, 5).clone()
    rel[..., :2] -= a[:, None, :2]
    ca = _corners(torch.cat([torch.zeros_like(a[:, :2]), a[:, 2:]], 1))
    cb = _corners(rel).reshape(-1, 4, 2)
    poly = torch.zeros(n * m, 8, 2, dtype=torch.float64, device=a.device)
    poly[:, :4] = ca[:, None].expand(n, m, 4, 2).reshape(-1, 4, 2)
    cnt = torch.full((n * m,), 4, dtype=torch.long, device=a.device)
    for k in range(4):
        poly, cnt = _clip(poly, cnt, cb[:, k], cb[:, (k + 1) % 4])
    idx = torch.arange(8, device=a.device)
    nxt = torch.where(idx[None] + 1 < cnt[:, None], idx[None] + 1, 0)
    q = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    cross = poly[..., 0] * q[..., 1] - q[..., 0] * poly[..., 1]
    inter = 0.5 * torch.abs(torch.where(idx[None] < cnt[:, None], cross, 0.0).sum(1))
    inter = torch.where(cnt >= 3, inter, 0.0).reshape(n, m)
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return torch.where(union > 1e-9, inter / union, 0.0)


def nms(boxes, scores, thresh, max_out, valid=None, rotated=False):
    """Greedy NMS over independent problems (G, N, 4|5) / (G, N): score order
    (stable, invalid lanes never kept) -> (G, M) lanes and their validity,
    M = min(N, max_out), pad slots 0 and False."""
    g, n = scores.shape
    if valid is not None:
        scores = torch.where(valid, scores, -1e30)
    ss, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    ok = (ss > -5e29).cpu().numpy()
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    if rotated:
        over = torch.stack([rotated_iou(sb[i], sb[i]) > thresh for i in range(g)])
    else:
        over = iou_plain(sb, sb) > thresh
    over = over.cpu().numpy()
    keep = np.zeros((g, n), bool)
    supp = ~ok
    for i in range(n):
        keep[:, i] = ~supp[:, i]
        supp |= keep[:, i, None] & over[:, i]
        if i % 64 == 63 and (keep.sum(1) >= max_out).all():
            break
    mm = min(n, max_out)
    rank = np.argsort(~keep, axis=1, kind="stable")[:, :mm]
    kv = np.take_along_axis(keep, rank, 1)
    lanes = np.where(kv, np.take_along_axis(order.cpu().numpy(), rank, 1), 0)
    return (torch.from_numpy(lanes).to(boxes.device),
            torch.from_numpy(kv).to(boxes.device))


# -- RoI align (torchvision's legacy mapping, fixed sampling ratio) ---------------


def roi_align(feat, rois, scale, p=7, sr=2):
    """(B, H, W, C) NHWC features, (B, R, 4) boxes -> (B, R, P, P, C) float32:
    the mean of sr x sr bilinear samples a bin, coordinates clamped to the map,
    RoI sizes floored at one cell.  Differentiable in the features."""
    b, h, w, c = feat.shape
    r = rois.detach().float()
    x1, y1, x2, y2 = (r[..., i] * scale for i in range(4))
    rw, rh = torch.clamp(x2 - x1, min=1.0), torch.clamp(y2 - y1, min=1.0)
    s = (torch.arange(p * sr, dtype=torch.float32, device=feat.device) + 0.5) / sr
    gx = x1[..., None] + s * (rw / p)[..., None]
    gy = y1[..., None] + s * (rh / p)[..., None]

    def taps(cc, dim):
        cc = torch.clamp(torch.clamp(cc, min=0.0), max=float(dim - 1))
        lo = torch.floor(cc)
        return lo.long(), torch.clamp(lo.long() + 1, max=dim - 1), 1.0 - (cc - lo), cc - lo

    ylo, yhi, wyl, wyh = taps(gy, h)
    xlo, xhi, wxl, wxh = taps(gx, w)
    out = []
    for f in range(b):
        flat = feat[f].reshape(h * w, c).float()
        acc = 0.0
        for yi, wy in ((ylo[f], wyl[f]), (yhi[f], wyh[f])):
            for xi, wx in ((xlo[f], wxl[f]), (xhi[f], wxh[f])):
                idx = yi[:, :, None] * w + xi[:, None, :]  # (R, P*sr, P*sr)
                wt = (wy[:, :, None] * wx[:, None, :])[..., None]
                acc = acc + wt * flat[idx.reshape(-1)].reshape(idx.shape + (c,))
        r_, ps = acc.shape[0], p * sr
        out.append(acc.reshape(r_, p, sr, p, sr, c).mean(dim=(2, 4)))
    return torch.stack(out)


# -- the BEV raster (float32 in the JAX loader's folded-constant order) -----------


def _f32(v):
    return torch.tensor(float(v), dtype=torch.float32)


def _recip(v):
    return _f32(1.0) / (v if isinstance(v, torch.Tensor) else _f32(v))


def voxelize(points, valid, *, x_range, y_range, z_range, voxel_height, num_x, num_y,
             num_slices, num_meta, max_pts):
    """(B, P, 5) points [x, y, z, intensity, elongation] -> (B, Y, X, S + meta):
    per voxel the highest point above the slice floor, the column's density
    min(count, cap) / cap (largest over its slices), tanh of the column's mean
    intensity and elongation."""
    b, dev = points.shape[0], points.device
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    pitch = lambda lo, hi, n: _recip((_f32(hi) - _f32(lo)) * _recip(n)).to(dev)  # noqa: E731
    zs = z - _f32(z_range[0]).to(dev)
    ix = torch.floor((x - _f32(x_range[0]).to(dev)) * pitch(*x_range, num_x)).long()
    iy = torch.floor((y - _f32(y_range[0]).to(dev)) * pitch(*y_range, num_y)).long()
    iz = torch.floor(zs * _recip(voxel_height).to(dev)).long()
    ok = (valid & (ix >= 0) & (ix < num_x) & (iy >= 0) & (iy < num_y) & (iz >= 0)
          & (iz < num_slices))
    ncol, frame = num_y * num_x, torch.arange(b, device=dev)[:, None]
    col = torch.where(ok, frame * ncol + iy * num_x + ix, b * ncol).reshape(-1)
    vox = torch.where(ok, (frame * ncol + iy * num_x + ix) * num_slices + iz,
                      b * ncol * num_slices).reshape(-1)
    rel = torch.where(ok, zs - iz.float() * _f32(voxel_height).to(dev), 0.0).reshape(-1)
    height = torch.zeros(b * ncol * num_slices + 1, device=dev).scatter_reduce(
        0, vox, rel, "amax", include_self=True)[:-1]
    chans = [height.reshape(b, num_y, num_x, num_slices)]
    one = ok.reshape(-1).float()
    ccnt = torch.zeros(b * ncol + 1, device=dev).index_add_(0, col, one)[:-1].clamp(min=1.0)
    if num_meta >= 1:
        vcnt = torch.zeros(b * ncol * num_slices + 1, device=dev).index_add_(0, vox, one)[:-1]
        dens = torch.minimum(vcnt, _f32(max_pts).to(dev)) * _recip(max_pts).to(dev)
        chans.append(dens.reshape(b, num_y, num_x, num_slices).amax(3, keepdim=True))
    for m, k in ((2, 3), (3, 4)):
        if num_meta >= m:
            v = torch.where(ok, points[..., k], 0.0).reshape(-1)
            tot = torch.zeros(b * ncol + 1, device=dev).index_add_(0, col, v)[:-1]
            chans.append(torch.tanh((tot / ccnt).double()).float().reshape(b, num_y, num_x, 1))
    return torch.cat(chans, 3)


# -- final per-class filter --------------------------------------------------------


def filter_detections(cls_prob, boxes, roi_valid, *, elem, max_dets, thresh, nms_thresh,
                      lidar, rotated) -> Dict[str, torch.Tensor]:
    """(B, S, K) class probabilities, (B, S, E*K) boxes -> (B, K, M, .): each
    (frame, class) above `thresh` through greedy NMS (image boxes; lidar: the
    axis-aligned footprint, or the rotated one), class 0 never kept."""
    b, s, k = cls_prob.shape
    scores = cls_prob.transpose(1, 2)
    bx = boxes.reshape(b, s, k, elem).transpose(1, 2)
    valid = roi_valid[:, None, :] & (scores > thresh) & (torch.arange(k, device=bx.device)
                                                         > 0)[:, None]
    if lidar and rotated:
        nb = bx[..., [0, 1, 3, 4, 6]]
    elif lidar:
        nb = torch.stack([bx[..., 0] - bx[..., 3] / 2.0, bx[..., 1] - bx[..., 4] / 2.0,
                          bx[..., 0] + bx[..., 3] / 2.0, bx[..., 1] + bx[..., 4] / 2.0], -1)
    else:
        nb = bx[..., :4]
    keep, ok = nms(nb.reshape(b * k, s, -1), scores.reshape(b * k, s), nms_thresh, max_dets,
                   valid.reshape(b * k, s), rotated=lidar and rotated)
    keep, ok = keep.reshape(b, k, -1), ok.reshape(b, k, -1)
    kept = torch.gather(scores, -1, keep)
    return {"boxes": torch.gather(bx, 2, keep[..., None].expand(-1, -1, -1, elem)),
            "scores": torch.where(ok, kept, 0.0), "valid": ok, "src_idx": keep}


def seed_of(*parts: int) -> int:
    """A 63-bit seed from whole numbers of any size (numpy's SeedSequence)."""
    return int(np.random.SeedSequence([int(p) & (2 ** 64 - 1) for p in parts]).generate_state(
        1, np.uint64)[0]) >> 1
