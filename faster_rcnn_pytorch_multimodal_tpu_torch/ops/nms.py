"""Batched greedy hard NMS: hand-written CUDA kernels and their plain twin.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/nms.py:53-190.  Semantics are
torchvision's (as in the JAX package): areas without +1, suppress when
IoU > threshold, IoU = inter / union (0 when union <= 0), invalid lanes are
never kept.  The result is exact greedy NMS; the JAX default (chunked Jacobi)
equals it except on a within-chunk suppression chain deeper than its
iteration bound.  With rotated=True the boxes are rotated BEV rectangles
[xc, yc, l, w, ry] and the IoU is the rotated one (ops/rotated_iou.py,
JAX `_pairwise_iou(rotated=True)`, :164).

One call serves any number of independent problems: (..., N, 4|5) boxes ->
(..., M) slots with M = min(N, max_out).  The proposal layer calls it with
G = B problems and the final filter with G = B * K.

On a CUDA tensor `nms` launches csrc/nms.cu (`frcnn_nms`, or
`frcnn_nms_rotated` with rotated=True: the sort, mask and scan kernels) or
raises; on a CPU tensor it runs `nms_plain`, the stable sort
(`_sort_lanes`) and the sequential greedy over a dense IoU matrix (the
rotated twin's IoU with rotated=True).
"""

from __future__ import annotations

import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.rotated_iou import rotated_iou_matrix_plain

NEG_INF = -1e30


def _sort_lanes(boxes, scores, valid):
    """(G, N, E), (G, N) -> score-sorted boxes, valid mask and sort order.

    Invalid lanes take a score of -1e30; the sort is stable so ties keep
    index order, as the JAX code's stable argsort does."""
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    sorted_scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    sorted_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    return sorted_boxes, sorted_scores > NEG_INF / 2, order


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, N, 4) x (G, M, 4) -> (G, N, M) IoU without the +1 area term, in
    the kernel's operation order."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = torch.clamp(
        torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
        - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]),
        min=0.0,
    )
    ih = torch.clamp(
        torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
        - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]),
        min=0.0,
    )
    inter = iw * ih
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _greedy_keep(sorted_boxes, sorted_valid, iou_threshold, max_out, rotated=False):
    """Sequential greedy keep mask over score-sorted lanes, (G, N) bool."""
    g, n = sorted_valid.shape
    iou = rotated_iou_matrix_plain if rotated else pairwise_iou
    over = iou(sorted_boxes, sorted_boxes) > iou_threshold
    later = torch.ones(n, n, dtype=torch.bool, device=over.device).triu(1)
    over &= later
    keep = torch.zeros_like(sorted_valid)
    suppressed = ~sorted_valid
    for i in range(n):
        keep_i = ~suppressed[:, i]
        keep[:, i] = keep_i
        suppressed |= keep_i[:, None] & over[:, i]
        # lanes past the first max_out kept never reach the output
        if i % 64 == 63 and bool((keep.sum(1) >= max_out).all()):
            break
    return keep


def _compact(keep, order, m):
    """First m kept lanes in score order, mapped through `order`; pad slots
    get index 0 and valid False."""
    rank = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True)[1][:, :m]
    keep_valid = torch.gather(keep, 1, rank)
    idx = torch.gather(order, 1, rank)
    idx = torch.where(keep_valid, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), keep_valid


def nms_plain(boxes, scores, iou_threshold, max_out, valid=None, rotated=False):
    """Plain PyTorch greedy NMS on (G, N, 4) (rotated: (G, N, 5)) / (G, N)
    tensors."""
    n = boxes.shape[1]
    sorted_boxes, sorted_valid, order = _sort_lanes(boxes, scores, valid)
    keep = _greedy_keep(sorted_boxes, sorted_valid, iou_threshold, max_out, rotated)
    return _compact(keep, order, min(n, max_out))


_SCAN_SMEM_LIMIT = 232448 - 1024  # csrc/nms.cu kScanSmemLimit


def _scan_smem_bytes(col_blocks):
    """csrc/nms.cu scan_smem_bytes with one staged block of 64 mask rows:
    the least shared memory the keep scan needs (it stages up to 3 blocks
    where they fit)."""
    return (64 * col_blocks + 2 + 2 * col_blocks + (col_blocks + 2) // 2) * 8


def _check_valid(valid, what):
    """The sort kernel reads `valid` as one byte a lane: bool only."""
    if valid is not None and valid.dtype != torch.bool:
        raise TypeError(f"{what}: valid must be bool, got {valid.dtype}")


def _nms_cuda(boxes, scores, iou_threshold, max_out, valid=None, rotated=False):
    g, n = scores.shape
    if g > 65535:
        raise ValueError(f"nms: {g} problems exceed the grid limit of 65535")
    _check_valid(valid, "nms")
    m = min(n, max_out)
    if _scan_smem_bytes((n + 63) // 64) > _SCAN_SMEM_LIMIT:
        raise ValueError(f"nms: N={n} exceeds the scan's shared memory (one staged row block)")
    dev = boxes.device
    lib = _build.library()
    # the sorted boxes, valid bytes and order, then the mask (csrc/nms.cu
    # `workspace`)
    ws = torch.empty(lib.frcnn_nms_workspace_bytes(g, n, boxes.shape[-1]), dtype=torch.uint8,
                     device=dev)
    out_idx = torch.empty((g, m), dtype=torch.int32, device=dev)
    out_valid = torch.empty((g, m), dtype=torch.bool, device=dev)
    boxes, scores = boxes.contiguous(), scores.contiguous()
    valid = None if valid is None else valid.contiguous()  # held until the launch is queued
    valid_ptr = None if valid is None else valid.data_ptr()
    with torch.cuda.device(dev):
        name = "nms_rotated" if rotated else "nms"
        err = getattr(lib, f"frcnn_{name}")(
            scores.data_ptr(), valid_ptr, boxes.data_ptr(), g, n, float(iou_threshold), m,
            ws.data_ptr(), out_idx.data_ptr(), out_valid.data_ptr(), _build.stream_handle(dev))
    _build.check(err, f"frcnn_{name}")
    _build.LAUNCH_COUNTS[name] += 1
    return out_idx, out_valid


def sort_lanes_cuda(boxes, scores, valid=None):
    """csrc/nms.cu's sort kernel alone on (G, N, E) / (G, N) CUDA tensors:
    (sorted boxes, sorted valid, int32 order), to hold against
    `_sort_lanes`.  The NMS wrappers run the same kernel inside their call."""
    g, n = scores.shape
    _check_valid(valid, "sort_lanes_cuda")
    boxes, scores = boxes.contiguous(), scores.contiguous()
    out = torch.empty_like(boxes)
    ok = torch.empty((g, n), dtype=torch.bool, device=boxes.device)
    order = torch.empty((g, n), dtype=torch.int32, device=boxes.device)
    valid = None if valid is None else valid.contiguous()
    valid_ptr = None if valid is None else valid.data_ptr()
    with torch.cuda.device(boxes.device):
        err = _build.library().frcnn_nms_sort(
            scores.data_ptr(), valid_ptr, boxes.data_ptr(), g, n, boxes.shape[-1], out.data_ptr(),
            ok.data_ptr(), order.data_ptr(), _build.stream_handle(boxes.device))
    _build.check(err, "frcnn_nms_sort")
    _build.LAUNCH_COUNTS["nms_sort"] += 1
    return out, ok, order


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: torch.Tensor | None = None,
    rotated: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy hard NMS over independent problems.

    Args:
      boxes: (..., N, 4) float32 x1y1x2y2, or with rotated=True (..., N, 5)
        rotated BEV rectangles [xc, yc, l, w, ry].
      scores: (..., N) float32.
      iou_threshold: suppress a lower-scored box when IoU > threshold.
      max_out: output slot count (the output has min(N, max_out) slots).
      valid: optional (..., N) bool; invalid lanes are never kept.
      rotated: suppress by the IoU of the rotated footprints.

    Returns:
      keep_idx: (..., M) int32 indices into N, score-ordered, 0 on pad slots.
      keep_valid: (..., M) bool.
    """
    lead, n = scores.shape[:-1], scores.shape[-1]
    e = 5 if rotated else 4
    if boxes.shape != scores.shape + (e,):
        raise ValueError(f"nms: boxes {tuple(boxes.shape)} vs scores {tuple(scores.shape)}")
    if valid is not None and valid.shape != scores.shape:
        raise ValueError(f"nms: valid {tuple(valid.shape)} vs scores {tuple(scores.shape)}")
    if max_out < 1 or n < 1:
        raise ValueError(f"nms: need N >= 1 and max_out >= 1, got {n}, {max_out}")
    if rotated and not iou_threshold >= 0:
        raise ValueError(f"nms: rotated NMS needs a threshold >= 0, got {iou_threshold}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms: float32 boxes and scores required, got {boxes.dtype}, {scores.dtype}")
    tensors = (boxes, scores) if valid is None else (boxes, scores, valid)
    if any(t.device != boxes.device for t in tensors):
        raise ValueError("nms: boxes, scores and valid must be on one device")
    b = boxes.reshape(-1, n, e)
    s = scores.reshape(-1, n)
    v = None if valid is None else valid.reshape(-1, n)
    if boxes.device.type == "cpu":
        idx, ok = nms_plain(b, s, iou_threshold, max_out, v, rotated)
    elif boxes.device.type == "cuda":
        idx, ok = _nms_cuda(b, s, iou_threshold, max_out, v, rotated)
    else:
        raise ValueError(f"nms: unsupported device {boxes.device}")
    m = idx.shape[-1]
    return idx.reshape(lead + (m,)), ok.reshape(lead + (m,))
