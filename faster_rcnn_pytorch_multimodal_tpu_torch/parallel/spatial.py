"""The backbone's rows over the model axis (MESH.SPATIAL): the port of JAX's
spatial partitioning (parallel/mesh.py shard_batch shards the image's H
over `model` where H % m == 0; GSPMD exchanges halos in the backbone's
convs).

Inside `row_split` (models.detector.FasterRCNN.features) every rank of a
model group runs the backbone on a slab of rows of the same frames.  The
rank that owns a map's output rows is given by that map's height: rank j
of m holds rows [j * h // m, (j + 1) * h // m) (floor partitions, which
may be uneven: the BEV raster's 400 rows are 25 at stride 16, 12 and 13
rows on two ranks).  A conv or max-pool (`Conv2d`, `MaxPool2d`, the
backbone's layer classes) takes, from their owners, exactly the input rows
its window over the rank's output rows reads: one all-reduce over the
model group of a buffer that holds only the rows some rank needs and does
not own, each written by its owner (`_Halo`; its backward sends each halo
row's gradient back to its owner the same way).  Rows outside the map are
zeros for a conv and -inf for a max-pool, as the whole map's padding.
The stride-2 1x1 convs (caffe_stride, the downsample) read rows 2o, which
may lie in a neighbour's slab: the same exchange.  The backbone's output
is gathered whole (`RowSplit.gather`, whose backward gives each rank its
rows' gradient), and everything after it runs replicated on the model
group.

Within a split, live BN (models.resnet.LiveBatchNorm) sums its statistics
over every rank, data and model, and the backbone's dropout takes the
rank's rows of the whole mask.  A pass knows a slab's global height by its
width: rows split, columns stay whole, so within one pass a width names one
map size (`RowSplit.heights`).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from faster_rcnn_pytorch_multimodal_tpu_torch.parallel import mesh

_SPLIT: contextvars.ContextVar[Optional["RowSplit"]] = contextvars.ContextVar(
    "row_split", default=None)


def floor_rows(h: int, m: int, j: int) -> Tuple[int, int]:
    """Rank j's rows [lo, hi) of a map of h rows over m ranks."""
    return j * h // m, (j + 1) * h // m


class _Halo(torch.autograd.Function):
    """The rows [lo, hi) of a map of `h` rows (clipped to the map) from
    this rank's slab x (rows `own` of it) and, for the rows it does not
    own, from `halo`: the sorted rows some rank of the model group needs
    and does not own, each written by its owner into one buffer that is
    summed over the group.  Backward: the window's own rows' gradient to
    the slab, its halo rows' gradient through the same buffer to their
    owners, who add it to their rows."""

    @staticmethod
    def forward(ctx, x, dp, halo: Tuple[int, ...], own: Tuple[int, int], lo: int, hi: int):
        o0, o1 = own
        pos = {r: i for i, r in enumerate(halo)}
        sent = [r for r in halo if o0 <= r < o1]  # rows of this slab others need
        got = [r for r in range(lo, hi) if not o0 <= r < o1]  # rows this window needs
        ctx.dp, ctx.args = dp, (halo, own, lo, hi, sent, got)
        ctx.x_shape, ctx.fmt = x.shape, mesh._memory_format(x)
        buf = None
        if halo:
            buf = _rows_buffer(x, len(halo))
            if sent:
                buf.index_copy_(2, _index(x, [pos[r] for r in sent]),
                                x.index_select(2, _index(x, [r - o0 for r in sent])))
            mesh.all_reduce_(buf, dp, "model", "forward")
        parts = []
        if lo < min(o0, hi):
            parts.append(buf.narrow(2, pos[lo], min(o0, hi) - lo))
        a, b = max(lo, o0), min(hi, o1)
        if b > a:
            parts.append(x.narrow(2, a - o0, b - a))
        if hi > max(o1, lo):
            start = max(o1, lo)
            parts.append(buf.narrow(2, pos[start], hi - start))
        if not parts:
            return _rows_buffer(x, 0)
        return torch.cat(parts, dim=2).contiguous(memory_format=ctx.fmt)

    @staticmethod
    def backward(ctx, dy):
        halo, (o0, o1), lo, hi, sent, got = ctx.args
        pos = {r: i for i, r in enumerate(halo)}
        dx = mesh.zeros_like_layout(ctx.x_shape, dy, ctx.fmt)
        a, b = max(lo, o0), min(hi, o1)
        if b > a:
            dx.narrow(2, a - o0, b - a).copy_(dy.narrow(2, a - lo, b - a))
        if halo:
            buf = _rows_buffer(dx, len(halo))
            if got:
                buf.index_copy_(2, _index(dy, [pos[r] for r in got]),
                                dy.index_select(2, _index(dy, [r - lo for r in got])))
            mesh.all_reduce_(buf, ctx.dp, "model", "backward")
            if sent:
                dx.index_add_(2, _index(dx, [r - o0 for r in sent]),
                              buf.index_select(2, _index(dx, [pos[r] for r in sent])))
        return dx, None, None, None, None, None


def _rows_buffer(x: torch.Tensor, rows: int) -> torch.Tensor:
    return mesh.zeros_like_layout((x.shape[0], x.shape[1], rows, x.shape[3]), x)


def _index(x: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.long, device=x.device)


class RowSplit:
    """One backbone pass split by rows on a rank of the model group:
    `heights` maps each width the pass has seen to its map's global
    height."""

    def __init__(self, dp: mesh.DataParallel, h: int, w: int):
        self.dp, self.j, self.m = dp, dp.model_rank, dp.model
        self.heights: Dict[int, int] = {w: h}

    def rows(self, h: int) -> Tuple[int, int]:
        return floor_rows(h, self.m, self.j)

    def height(self, x: torch.Tensor) -> int:
        """The global height of the map `x` is this rank's slab of."""
        h = self.heights.get(x.shape[-1])
        if h is None:
            raise RuntimeError(f"row split: a map of width {x.shape[-1]} that no layer made")
        lo, hi = self.rows(h)
        if x.shape[-2] != hi - lo:
            raise RuntimeError(f"row split: a slab of {x.shape[-2]} rows where rank {self.j} "
                               f"of {self.m} holds {hi - lo} of {h}")
        return h

    def _note(self, h: int, w: int) -> None:
        if self.heights.setdefault(w, h) != h:
            raise RuntimeError(f"row split: maps of heights {self.heights[w]} and {h} at width {w}")

    def window(self, x: torch.Tensor, k: int, s: int, p: int, w_out: int, fill: float
               ) -> torch.Tensor:
        """The rows of the map a k-tall window at stride s and padding p
        reads for this rank's output rows (of an output `w_out` wide),
        padded with `fill` where they leave the map."""
        h = self.height(x)
        h_out = (h + 2 * p - k) // s + 1
        self._note(h_out, w_out)
        need, halo = [], set()
        for j in range(self.m):
            o0, o1 = floor_rows(h_out, self.m, j)
            a, b = (o0 * s - p, (o1 - 1) * s - p + k) if o1 > o0 else (0, 0)
            need.append((a, b))
            i0, i1 = floor_rows(h, self.m, j)
            halo.update(r for r in range(max(a, 0), min(b, h)) if not i0 <= r < i1)
        a, b = need[self.j]
        lo, hi = max(a, 0), min(b, h)
        if not halo and (lo, hi) == self.rows(h):  # a 1x1 stride-1 conv: the slab itself
            return x
        win = _Halo.apply(x, self.dp, tuple(sorted(halo)), self.rows(h), lo, max(hi, lo))
        if hi > lo and (lo - a or b - hi):
            win = F.pad(win, (0, 0, lo - a, b - hi), value=fill)
        return win

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map from the ranks' slabs; backward: this rank's rows
        of the gradient, which every rank holds whole."""
        h = self.height(x)
        return mesh.gather_model(x, 2, self.rows(h)[0], h)


def active() -> Optional[RowSplit]:
    """The row split of the enclosing backbone pass, or None."""
    return _SPLIT.get()


@contextlib.contextmanager
def row_split(dp: mesh.DataParallel, h: int, w: int) -> Iterator[RowSplit]:
    """Within the block the backbone's layers run on this rank's rows of
    maps whose first is h x w."""
    split = RowSplit(dp, h, w)
    token = _SPLIT.set(split)
    try:
        yield split
    finally:
        _SPLIT.reset(token)


def _empty_out(win: torch.Tensor, x: torch.Tensor, channels: int, w_out: int) -> torch.Tensor:
    """A rank's empty output slab (an output map of fewer rows than ranks),
    tied to the window so that its exchange runs backward on every rank."""
    out = mesh.zeros_like_layout((x.shape[0], channels, 0, w_out), x)
    return out + win.sum() * 0


class Conv2d(nn.Conv2d):
    """nn.Conv2d that, inside a row split, computes this rank's output rows
    from the rows its window reads (zeros beyond the map)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = _SPLIT.get()
        if split is None:
            return super().forward(x)
        if self.padding_mode != "zeros" or self.dilation != (1, 1):
            raise NotImplementedError("row split: a dilated or non-zero-padded conv")
        (kh, kw), (sh, sw), (ph, pw) = self.kernel_size, self.stride, self.padding
        w_out = (x.shape[-1] + 2 * pw - kw) // sw + 1
        win = split.window(x, kh, sh, ph, w_out, 0.0)
        if win.shape[2] == 0:
            return _empty_out(win, x, self.weight.shape[0], w_out)
        return F.conv2d(win, self.weight, self.bias, self.stride, (0, pw), 1, self.groups)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """F.max_pool2d (square, floor mode) that, inside a row split, pools
    this rank's output rows (-inf beyond the map, as the whole map's
    padding)."""
    split = _SPLIT.get()
    if split is None:
        return F.max_pool2d(x, kernel, stride, padding)
    w_out = (x.shape[-1] + 2 * padding - kernel) // stride + 1
    win = split.window(x, kernel, stride, padding, w_out, float("-inf"))
    if win.shape[2] == 0:
        return _empty_out(win, x, x.shape[1], w_out)
    return F.max_pool2d(win, kernel, stride, (0, padding))


class MaxPool2d(nn.MaxPool2d):
    """nn.MaxPool2d (square, floor mode) through `max_pool2d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, p = (_one(v) for v in (self.kernel_size, self.stride or self.kernel_size,
                                     self.padding))
        if self.ceil_mode or _one(self.dilation) != 1:
            raise NotImplementedError("spatial.MaxPool2d: a ceil-mode or dilated max-pool")
        return max_pool2d(x, k, s, p)


def _one(v) -> int:
    """A square window's side."""
    if isinstance(v, (tuple, list)):
        if len(set(v)) != 1:
            raise NotImplementedError("spatial.MaxPool2d: a non-square window")
        return v[0]
    return v
