"""Pairwise IoU of rotated BEV rectangles: the plain twin, and a CUDA path.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/rotated_iou.py:31-110
(`box5_corners`, `_points_in_quad`, `_pair_intersection_area`,
`rotated_iou_matrix`), the IoU behind TEST.ROTATED_NMS.  Boxes are
[xc, yc, l, w, ry]: l along the heading, w across it.

`rotated_iou_matrix_plain` follows the JAX formulation op for op, batched
as (..., N, 5) x (..., M, 5) -> (..., N, M) float32: the intersection of
two convex quads from a fixed 24-slot candidate buffer (the 4 + 4 corners
inside the other quad with slack `_EPS`, the 16 edge crossings with the
`|denom| > 1e-12` guard), angularly sorted around the valid centroid
(`atan2`, invalid slots at +inf, a stable sort), a masked shoelace over the
first k slots with the k-gon wrapped at k; area l * w; IoU 0 when the union
is <= 1e-9 or fewer than 3 vertices are valid.  It matches the JAX function
to float32 rounding, is the CPU path of `nms(rotated=True)` and the check
of the kernel.

On a CUDA tensor `rotated_iou_matrix` launches csrc/nms.cu's
`rotated_iou_kernel` (Sutherland-Hodgman clipping, the same `__device__`
function as the rotated NMS mask) or raises; it exists so that the kernel's
IoU can be held against the twin number by number.
"""

from __future__ import annotations

import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

# inside-test slack (length^2 units); candidates missed by the corner test
# on exact-boundary contact are recovered by the edge-crossing candidates
_EPS = 1e-6
# pairs a chunk of the twin handles at once: its (pairs, 24, 2) candidate
# tensors stay ~100 MB whatever the problem size
_CHUNK_PAIRS = 1 << 18


def box5_corners(b5: torch.Tensor) -> torch.Tensor:
    """(..., 5) [xc, yc, l, w, ry] -> (..., 4, 2) corners, counter-clockwise."""
    xc, yc, l, w, ry = b5.unbind(-1)
    c, s = torch.cos(ry), torch.sin(ry)
    sx = torch.stack([l, l, -l, -l], dim=-1) * 0.5
    sy = torch.stack([-w, w, w, -w], dim=-1) * 0.5
    x = xc[..., None] + sx * c[..., None] - sy * s[..., None]
    y = yc[..., None] + sx * s[..., None] + sy * c[..., None]
    return torch.stack([x, y], dim=-1)


def _points_in_quad(pts: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """pts (..., P, 2) inside the convex CCW quad (..., 4, 2) -> (..., P) bool."""
    e = torch.roll(quad, -1, dims=-2) - quad  # (..., 4, 2)
    w = pts[..., :, None, :] - quad[..., None, :, :]  # (..., P, 4, 2)
    cr = e[..., None, :, 0] * w[..., 1] - e[..., None, :, 1] * w[..., 0]
    return torch.all(cr >= -_EPS, dim=-1)


def _pair_intersection_area(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Intersection areas of convex CCW quads (..., 4, 2) x (..., 4, 2) -> (...)."""
    in_ab = _points_in_quad(ca, cb)
    in_ba = _points_in_quad(cb, ca)

    # all 16 edge-pair crossings: A edge p + t * r, B edge q + u * s
    p, r = ca, torch.roll(ca, -1, dims=-2) - ca
    q, s = cb, torch.roll(cb, -1, dims=-2) - cb
    denom = r[..., :, None, 0] * s[..., None, :, 1] - r[..., :, None, 1] * s[..., None, :, 0]
    qp = q[..., None, :, :] - p[..., :, None, :]  # (..., 4, 4, 2)
    t_num = qp[..., 0] * s[..., None, :, 1] - qp[..., 1] * s[..., None, :, 0]
    u_num = qp[..., 0] * r[..., :, None, 1] - qp[..., 1] * r[..., :, None, 0]
    nonpar = torch.abs(denom) > 1e-12
    safe = torch.where(nonpar, denom, torch.ones_like(denom))
    t = t_num / safe
    u = u_num / safe
    crossing = nonpar & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    xpts = p[..., :, None, :] + t[..., None] * r[..., :, None, :]

    lead = ca.shape[:-2]
    cand = torch.cat([ca, cb, xpts.reshape(lead + (16, 2))], dim=-2)  # (..., 24, 2)
    valid = torch.cat([in_ab, in_ba, crossing.reshape(lead + (16,))], dim=-1)

    # angular sort around the valid centroid; masked shoelace over the first
    # k slots (invalid slots sort to the tail through their +inf angle)
    k = valid.sum(dim=-1)
    centroid = torch.where(valid[..., None], cand, 0.0).sum(dim=-2) / torch.clamp(
        k, min=1).to(cand.dtype)[..., None]
    ang = torch.atan2(cand[..., 1] - centroid[..., None, 1], cand[..., 0] - centroid[..., None, 0])
    order = torch.sort(torch.where(valid, ang, torch.inf), dim=-1, stable=True).indices
    v = torch.gather(cand, -2, order[..., None].expand(cand.shape))
    idx = torch.arange(cand.shape[-2], device=cand.device)
    nxt = torch.where(idx + 1 < k[..., None], idx + 1, 0)  # wrap the k-gon
    vn = torch.gather(v, -2, nxt[..., None].expand(v.shape))
    cross = v[..., 0] * vn[..., 1] - vn[..., 0] * v[..., 1]
    area = 0.5 * torch.abs(torch.where(idx < k[..., None], cross, 0.0).sum(dim=-1))
    return torch.where(k >= 3, area, 0.0)


def rotated_iou_matrix_plain(a5: torch.Tensor, b5: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated IoU of (..., N, 5) vs (..., M, 5) boxes -> (..., N, M)
    float32, in row chunks of at most _CHUNK_PAIRS pairs."""
    a5, b5 = a5.float(), b5.float()
    n, m = a5.shape[-2], b5.shape[-2]
    lead = torch.broadcast_shapes(a5.shape[:-2], b5.shape[:-2])
    # each pair relative to its row box's center
    ca = box5_corners(torch.cat([torch.zeros_like(a5[..., :2]), a5[..., 2:]], -1))
    rows = max(1, _CHUNK_PAIRS // max(1, m * lead.numel()))
    parts = []
    for i in range(0, n, rows):
        a = a5[..., i:i + rows, None, :]  # (..., rows, 1, 5)
        rel = torch.cat([b5[..., None, :, :2] - a[..., :2], b5[..., None, :, 2:].expand(
            a.shape[:-2] + (m, 3))], -1)  # (..., rows, M, 5)
        ci = ca[..., i:i + rows, None, :, :].expand(rel.shape[:-1] + (4, 2))
        parts.append(_pair_intersection_area(ci, box5_corners(rel)))
    inter = torch.cat(parts, dim=-2) if n else a5.new_zeros(lead + (0, m))
    area_a = a5[..., 2] * a5[..., 3]
    area_b = b5[..., 2] * b5[..., 3]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 1e-9, inter / union, 0.0)


def _rotated_iou_cuda(a5: torch.Tensor, b5: torch.Tensor) -> torch.Tensor:
    g, n, m = a5.shape[0], a5.shape[1], b5.shape[1]
    if g > 65535 or -(-n // 64) > 65535:
        raise ValueError(f"rotated_iou_matrix: ({g}, {n}) rows exceed the grid limit")
    out = torch.empty((g, n, m), dtype=torch.float32, device=a5.device)
    if n and m:
        lib = _build.library()
        with torch.cuda.device(a5.device):
            err = lib.frcnn_rotated_iou(a5.data_ptr(), b5.data_ptr(), g, n, m, out.data_ptr(),
                                        _build.stream_handle(a5.device))
        _build.check(err, "frcnn_rotated_iou")
        _build.LAUNCH_COUNTS["rotated_iou"] += 1
    return out


def rotated_iou_matrix(a5: torch.Tensor, b5: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated IoU of (..., N, 5) vs (..., M, 5) float32 boxes
    [xc, yc, l, w, ry] with equal leading dims -> (..., N, M) float32.

    On a CUDA tensor the kernel, on a CPU tensor the plain twin."""
    if a5.shape[-1] != 5 or b5.shape[-1] != 5 or a5.shape[:-2] != b5.shape[:-2]:
        raise ValueError(f"rotated_iou_matrix: boxes {tuple(a5.shape)} vs {tuple(b5.shape)}")
    if a5.dtype != torch.float32 or b5.dtype != torch.float32:
        raise TypeError(f"rotated_iou_matrix: float32 boxes required, got {a5.dtype}, {b5.dtype}")
    if a5.device != b5.device:
        raise ValueError("rotated_iou_matrix: both box sets must be on one device")
    if a5.device.type == "cpu":
        return rotated_iou_matrix_plain(a5, b5)
    if a5.device.type != "cuda":
        raise ValueError(f"rotated_iou_matrix: unsupported device {a5.device}")
    lead, n, m = a5.shape[:-2], a5.shape[-2], b5.shape[-2]
    out = _rotated_iou_cuda(a5.reshape(-1, n, 5).contiguous(), b5.reshape(-1, m, 5).contiguous())
    return out.reshape(lead + (n, m))
