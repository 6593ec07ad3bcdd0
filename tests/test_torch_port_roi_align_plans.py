"""The index rules of the two RoI-align kernel designs in
csrc/roi_align.cu, written as small numpy mirrors of the kernels' index
math (float32 op for op) and held against the JAX package on the CPU.

* The single-level forward's read plan (`build_axis_plan`, the ring of
  staged tap rows in `roi_align_fwd_kernel`): each axis's distinct taps in
  increasing order and each sample's place among them; the rows computed
  once each, in order, each staged before it is computed and never
  overwritten before; the staged x-then-y evaluation equal to JAX
  `roi_align_batched` within 1e-5 * max|F|.
* The multiscale forward (`roi_align_ms_fwd_kernel`): the same staged body
  on the map of each RoI's level (`roi_level`), at that level's scale,
  equal to JAX `multiscale_roi_align_batched` within 1e-5 * max|F|.
* The multiscale backward's per-level tile gather (`roi_bucket_kernel`,
  then `gather_tile` under `roi_align_ms_bwd_kernel`): per level, per tile
  (4 x 4 cells on p2 and p3, 2 x 4 on p4 and p5), keep the RoIs that
  `roi_level` maps there and whose footprint (`axis_span`) on that level
  meets the tile, build the bin-row and bin-column profiles, sum.  Within
  `chip_smoke.sum_order_tolerance` of the twin's gradient and within 1e-5
  * max|dF| of JAX's VJP of `multiscale_roi_align_batched` in the four
  maps (JAX's own weights round differently from the twin's; see the
  test).
* Each RoI's gradient, by JAX's VJP, is zero on every level but its own and
  lies inside its footprint there: the culling loses nothing.

Inputs come from numpy seeds: 2 frames, C 8, a 16 x 24 map at stride 16,
and a pyramid 16 x 24 .. 2 x 3 at strides 4 .. 32, with RoIs that straddle
the edge, lie outside, are under a cell or cover the whole frame.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu.ops.roi_align import (  # noqa: E402
    multiscale_roi_align_batched as j_msra,
)
from faster_rcnn_pytorch_multimodal_tpu.ops.roi_align import (  # noqa: E402
    roi_align_batched as j_roi_align,
)
from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (  # noqa: E402
    _sample_coords,
    _taps,
    multiscale_roi_align_batched_plain,
    roi_levels,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

f32 = np.float32
B, C = 2, 8
MAP_HW, STRIDE = (16, 24), 16
PYRAMID = [(16, 24), (8, 12), (4, 6), (2, 3)]  # p2..p5 of a 64 x 96 frame
STRIDES = (4, 8, 16, 32)
P, SR = 7, 2
MS_TILE_H, MS_TILE_W = (4, 4, 2, 2), 4  # kMsFineH on p2, p3, kMsCoarseH on p4, p5; kMsTileW
FWD_CELLS = 3  # kFwdCap: the forward's ring holds 3 x P x sr cells
FWD_MAX_SLOTS = 7  # kFwdMaxSlots


def awkward_rois(rng, b, r, frame_hw, sides):
    """Random RoIs with log-uniform sides, and in every frame: over each
    edge, outside (both corners), under a cell, the whole frame."""
    fh, fw = frame_hw
    x1 = rng.uniform(-0.1 * fw, fw, (b, r))
    y1 = rng.uniform(-0.1 * fh, fh, (b, r))
    side = np.exp(rng.uniform(np.log(sides[0]), np.log(sides[1]), (b, r, 2)))
    rois = np.stack([x1, y1, x1 + side[..., 0], y1 + side[..., 1]], -1)
    rois[:, 0] = [-30, 10, 40, 60]
    rois[:, 1] = [20, -25, 70, 30]
    rois[:, 2] = [fw - 30, 20, fw + 40, 70]
    rois[:, 3] = [30, fh - 20, 90, fh + 35]
    rois[:, 4] = [fw + 100, fh + 50, fw + 180, fh + 90]
    rois[:, 5] = [-90, -70, -20, -10]
    rois[:, 6] = [33.3, 41.7, 36.1, 44.0]
    rois[:, 7] = [0, 0, fw, fh]
    return rois.astype(f32)


# -- float32 mirrors of the device functions ---------------------------------


def axis_taps(start, bin_size, s, sr, dim):
    """axis_taps: (lo, hi, w_lo, w_hi)."""
    frac = f32(f32(s) + f32(0.5)) / f32(sr)
    c = min(max(f32(start + f32(frac * bin_size)), f32(0)), f32(dim - 1))
    lo = int(np.floor(c))
    w_hi = f32(c - f32(lo))
    return lo, min(lo + 1, dim - 1), f32(f32(1) - w_hi), w_hi


def roi_box(roi, scale, p):
    """roi_box with aligned=False: (x1, y1, bin_w, bin_h)."""
    x1, y1, x2, y2 = (f32(f32(v) * f32(scale)) for v in roi)
    return (x1, y1, max(f32(x2 - x1), f32(1)) / f32(p), max(f32(y2 - y1), f32(1)) / f32(p))


def axis_span(start, bin_size, p, sr, dim):
    """axis_span: the low tap of the first sample, the high tap of the last."""
    last = p * sr - 1
    return axis_taps(start, bin_size, 0, sr, dim)[0], axis_taps(start, bin_size, last, sr, dim)[1]


def roi_level(roi):
    """roi_level: compare sqrt(area) / 224 + 1e-6 with 0.5, 1, 2."""
    x1, y1, x2, y2 = (f32(v) for v in roi)
    area = max(f32(f32(x2 - x1) * f32(y2 - y1)), f32(1e-6))
    x = f32(f32(np.sqrt(area)) / f32(224)) + f32(1e-6)
    return int(x >= 0.5) + int(x >= 1) + int(x >= 2)


def build_axis_plan_lanes(start, bin_size, p, sr, dim):
    """build_axis_plan as the kernel's lanes run it, one lane a sample: a
    tap is new where it exceeds the previous sample's hi; its place counts
    the new taps before it; a low tap's place is the count of new taps up
    to it less one, less hi_{s-1} where that lies above it.  Returns
    (taps, ilo, ihi)."""
    taps = [axis_taps(start, bin_size, s, sr, dim) for s in range(p * sr)]
    prev_hi = [None] + [t[1] for t in taps[:-1]]
    new_lo = [s == 0 or t[0] > prev_hi[s] for s, t in enumerate(taps)]
    new_hi = [t[1] != t[0] and (s == 0 or t[1] > prev_hi[s]) for s, t in enumerate(taps)]
    tap = [0] * (sum(new_lo) + sum(new_hi))
    ilo, ihi = [], []
    for s, (lo, hi, _, _) in enumerate(taps):
        before = sum(new_lo[:s]) + sum(new_hi[:s])
        if new_lo[s]:
            tap[before] = lo
        if new_hi[s]:
            tap[before + new_lo[s]] = hi
        il = before + new_lo[s] - 1 - int(s > 0 and prev_hi[s] > lo)
        ilo.append(il)
        ihi.append(il + int(hi != lo))
    return tap, ilo, ihi


def build_axis_plan(start, bin_size, p, sr, dim):
    """The read plan of one axis, sample by sample: (taps, ilo, ihi, wlo,
    whi); a low tap is one of the last two taps so far or new, a high tap
    the low one, the last one or new."""
    tap, ilo, ihi, wlo, whi = [], [], [], [], []
    for s in range(p * sr):
        lo, hi, w_lo, w_hi = axis_taps(start, bin_size, s, sr, dim)
        if tap and tap[-1] == lo:
            il = len(tap) - 1
        elif len(tap) > 1 and tap[-2] == lo:
            il = len(tap) - 2
        else:
            tap.append(lo)
            il = len(tap) - 1
        if hi == lo:
            ih = il
        elif tap[-1] == hi:
            ih = len(tap) - 1
        else:
            tap.append(hi)
            ih = len(tap) - 1
        ilo.append(il)
        ihi.append(ih)
        wlo.append(w_lo)
        whi.append(w_hi)
    return tap, ilo, ihi, wlo, whi


def staged_forward(fmap, roi, scale, p, sr):
    """roi_align_fwd_kernel on one RoI: (P, P, C) float32, and the rows in
    the order they were computed.  Replays the ring: row k is staged into
    slot k % slots `ahead` rows before it is computed, and the test checks
    that no slot is restaged before its row was computed."""
    h, w, _ = fmap.shape
    x1, y1, bin_w, bin_h = roi_box(roi, scale, p)
    xt, xlo, xhi, xwl, xwh = build_axis_plan(x1, bin_w, p, sr, w)
    yt, ylo, yhi, ywl, ywh = build_axis_plan(y1, bin_h, p, sr, h)
    nx, ny = len(xt), len(yt)
    slots = min(FWD_MAX_SLOTS, FWD_CELLS * p * sr // nx)
    assert slots >= 1
    ahead = slots - 1  # 0: one slot, each row staged where it is computed
    ring = [None] * slots  # (row index, staged cells) a slot
    computed = []

    def stage(k):
        old = ring[k % slots]
        assert old is None or old[0] in computed  # its row was computed already
        ring[k % slots] = (k, fmap[yt[k]][xt])  # (nx, C): the cells at the distinct columns

    for k in range(min(ahead, ny)):
        stage(k)
    out = np.zeros((p, p, fmap.shape[-1]), f32)
    acc = np.zeros((p, fmap.shape[-1]), f32)
    prev = last = None
    have = -1
    for sy in range(p * sr):
        while have < yhi[sy]:
            have += 1
            if ahead == 0:
                stage(have)
            k, cells = ring[have % slots]
            assert k == have  # staged, and not overwritten by a later row
            bins = np.zeros_like(acc)
            for pw in range(p):
                for ix in range(sr):
                    s = pw * sr + ix
                    bins[pw] += xwl[s] * cells[xlo[s]] + xwh[s] * cells[xhi[s]]
            prev, last = last, bins
            computed.append(have)
            if ahead and have + ahead < ny:
                stage(have + ahead)
        assert ylo[sy] in (have, have - 1) and yhi[sy] == have
        lo_row = last if ylo[sy] == have else prev
        acc += ywl[sy] * lo_row + ywh[sy] * last
        if sy % sr == sr - 1:
            out[sy // sr] = acc / f32(sr * sr)
            acc[:] = 0
    return out, computed, nx, ny


def bin_profile(start, bin_size, bin_, sr, dim, t0, n):
    """bin_profile: the bin's summed nonzero tap weights on cells t0 .. t0+n-1."""
    wt = [f32(0)] * n
    for s in range(sr):
        lo, hi, w_lo, w_hi = axis_taps(start, bin_size, bin_ * sr + s, sr, dim)
        for i in range(n):
            if w_lo != 0 and lo == t0 + i:
                wt[i] = f32(wt[i] + w_lo)
            if w_hi != 0 and hi == t0 + i:
                wt[i] = f32(wt[i] + w_hi)
    return np.array(wt, f32)


def tile_gather(maps, rois, g, strides, p, sr):
    """roi_bucket_kernel then roi_align_ms_bwd_kernel: each frame's RoIs
    listed by level in RoI order, then every level's gradient tile by tile
    (MS_TILE_H[level] x MS_TILE_W cells) from the RoIs of its list whose
    footprint meets the tile.  Returns the gradients and the kept (level,
    frame, RoI) triples."""
    inv = f32(1) / f32(sr * sr)
    grads, kept_any = [], set()
    for lvl, (m, stride) in enumerate(zip(maps, strides)):
        b_, h, w, c = m.shape
        grad = np.full(m.shape, np.nan, f32)  # every cell must be written
        scale = f32(1) / f32(stride)
        th, tw = MS_TILE_H[lvl], MS_TILE_W
        for b in range(b_):
            order = [r for r, roi in enumerate(rois[b]) if roi_level(roi) == lvl]
            for ty0 in range(0, h, th):
                for tx0 in range(0, w, tw):
                    acc = np.zeros((th, tw, c), f32)
                    ty1, tx1 = min(ty0 + th, h) - 1, min(tx0 + tw, w) - 1
                    for r in order:
                        x1, y1, bw, bh = roi_box(rois[b, r], scale, p)
                        ylo, yhi = axis_span(y1, bh, p, sr, h)
                        xlo, xhi = axis_span(x1, bw, p, sr, w)
                        if not (ylo <= ty1 and yhi >= ty0 and xlo <= tx1 and xhi >= tx0):
                            continue
                        kept_any.add((lvl, b, r))
                        wy = [bin_profile(y1, bh, q, sr, h, ty0, th) for q in range(p)]
                        wx = [bin_profile(x1, bw, q, sr, w, tx0, tw) for q in range(p)]
                        for ph in range(p):
                            row = np.zeros((tw, c), f32)
                            for pw in range(p):
                                row += wx[pw][:, None] * g[b, r, ph, pw][None, :]
                            acc += (wy[ph] * inv)[:, None, None] * row[None]
                    grad[b, ty0:ty1 + 1, tx0:tx1 + 1] = acc[:ty1 - ty0 + 1, :tx1 - tx0 + 1]
        grads.append(grad)
    return grads, kept_any


# -- the forward's read plan -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_read_plan_covers_every_twin_tap_in_order(seed):
    """Each axis's plan: strictly increasing distinct taps, at most 2 P sr;
    each sample's low and high tap and weights exactly the twin's; every
    tap the twin's samples produce is in the plan and nothing else."""
    rng = np.random.RandomState(seed)
    h, w = MAP_HW
    rois = awkward_rois(rng, B, 24, (h * STRIDE, w * STRIDE), (2.0, 420.0))
    gy, gx = _sample_coords(torch.from_numpy(rois), 1.0 / STRIDE, P, SR, False)
    for coords, dim, axis in ((gy, h, 1), (gx, w, 0)):
        lo, hi, w_lo, w_hi = (t.numpy() for t in _taps(coords, dim))
        for b in range(B):
            for r in range(rois.shape[1]):
                x1, y1, bw, bh = roi_box(rois[b, r], 1.0 / STRIDE, P)
                start, size = (y1, bh) if axis else (x1, bw)
                tap, ilo, ihi, wlo, whi = build_axis_plan(start, size, P, SR, dim)
                assert build_axis_plan_lanes(start, size, P, SR, dim) == (tap, ilo, ihi)
                assert all(a < b_ for a, b_ in zip(tap, tap[1:])) and len(tap) <= 2 * P * SR
                assert [tap[i] for i in ilo] == lo[b, r].tolist()
                assert [tap[i] for i in ihi] == hi[b, r].tolist()
                assert np.array_equal(np.array(wlo, f32), w_lo[b, r])
                assert np.array_equal(np.array(whi, f32), w_hi[b, r])
                assert set(tap) == set(lo[b, r].tolist()) | set(hi[b, r].tolist())


@pytest.mark.parametrize("seed", [0, 1])
def test_staged_forward_matches_jax(seed):
    """The ring of staged tap rows, replayed: every distinct row computed
    once, in increasing order, staged before and not overwritten until it
    is computed; the staged x-then-y sums within 1e-5 * max|F| of JAX
    roi_align_batched, at the RoIs' sizes from under a cell to the whole
    map (up to 24 distinct tap columns a RoI)."""
    rng = np.random.RandomState(seed + 10)
    h, w = MAP_HW
    feats = rng.normal(size=(B, h, w, C)).astype(f32)
    rois = awkward_rois(rng, B, 24, (h * STRIDE, w * STRIDE), (2.0, 420.0))
    got = np.zeros((B, rois.shape[1], P, P, C), f32)
    widths = set()
    for b in range(B):
        for r in range(rois.shape[1]):
            got[b, r], computed, nx, ny = staged_forward(feats[b], rois[b, r], 1.0 / STRIDE, P, SR)
            assert computed == list(range(ny))
            widths.add(nx)
    # sub-cell RoIs to the whole map, whose 24 distinct columns leave one ring slot
    assert min(widths) <= 3 and max(widths) == w
    want = np.asarray(j_roi_align(jnp.asarray(feats), jnp.asarray(rois), 1.0 / STRIDE, P, SR))
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(feats).max())


# -- the multiscale forward: the staged body on each RoI's level -------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multiscale_staged_forward_matches_jax(seed):
    """roi_align_ms_fwd_kernel: each RoI's level by roi_level (the twin's
    roi_levels and JAX's floor(4 + log2(.))), then the single-level
    forward's staged body (read plan, ring of tap rows, x-then-y sums) on
    that level's map at its scale; within 1e-5 * max|F| of JAX
    multiscale_roi_align_batched on RoIs over the edges, outside, under a
    cell, on every level, and elongated p2 RoIs whose distinct tap columns
    leave the ring one row."""
    rng = np.random.RandomState(seed + 20)
    maps = [rng.normal(size=(B,) + hw + (C,)).astype(f32) for hw in PYRAMID]
    rois = awkward_rois(rng, B, 24, (64, 96), (6.0, 700.0))
    rois[:, 8] = [-200, -150, 400, 450]  # 600 px: p5
    rois[:, 9] = [2.0, 30.0, 94.0, 33.0]  # 92 x 3 px: p2, 23 columns of the 24
    rois[:, 10] = [5.0, 1.0, 9.0, 62.5]  # 4 x 61.5 px: p2, 16 rows
    levels = np.array([[roi_level(roi) for roi in frame] for frame in rois])
    assert np.array_equal(levels, roi_levels(torch.from_numpy(rois), 4).numpy())
    assert set(levels.ravel().tolist()) == {0, 1, 2, 3}
    got = np.zeros((B, rois.shape[1], P, P, C), f32)
    widths = []
    for b in range(B):
        for r in range(rois.shape[1]):
            lvl = levels[b, r]
            scale = f32(1) / f32(STRIDES[lvl])
            got[b, r], computed, nx, ny = staged_forward(maps[lvl][b], rois[b, r], scale, P, SR)
            assert computed == list(range(ny))
            widths.append(nx)
    assert max(widths) > FWD_CELLS * P * SR // 2  # a ring of one tap row
    want = np.asarray(j_msra([jnp.asarray(m) for m in maps], jnp.asarray(rois), STRIDES, P, SR))
    fmax = max(float(np.abs(m).max()) for m in maps)
    assert float(np.abs(got - want).max()) <= 1e-5 * fmax


# -- the multiscale backward's per-level tile gather -------------------------


def _pyramid_case(seed, r=20):
    rng = np.random.RandomState(seed)
    maps = [rng.normal(size=(B,) + hw + (C,)).astype(f32) for hw in PYRAMID]
    rois = awkward_rois(rng, B, r, (64, 96), (6.0, 700.0))
    rois[:, 8] = [-200, -150, 400, 450]  # 600 px: p5
    g = rng.normal(size=(B, r, P, P, C)).astype(f32)
    return maps, rois, g


def _jax_vjp(maps, rois, g):
    _, vjp = jax.vjp(lambda *ms: j_msra(ms, jnp.asarray(rois), STRIDES, P, SR),
                     *[jnp.asarray(m) for m in maps])
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_gather_matches_jax_vjp(seed):
    """The gather over every level's tiles writes every cell; each element
    is within the sum-order limit of the twin's autograd gradient (the
    limit the kernel is held to on the card), and each level within 1e-5 *
    max|dF| of JAX's VJP in the four maps.  JAX itself is not within the
    sum-order limit of the twin: its hat weights 1 - |c - x| round a
    near-integer coordinate's small weight differently from c - floor(c),
    the twin's and the kernels' weight (5x the limit at single cells here,
    5e-7 of max|dF|).  The mirror's level rule equals the twin's
    (roi_levels) and JAX's floor(4 + log2(.))."""
    maps, rois, g = _pyramid_case(seed)
    levels = np.array([[roi_level(roi) for roi in frame] for frame in rois])
    assert np.array_equal(levels, roi_levels(torch.from_numpy(rois), 4).numpy())
    area = np.maximum((rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1]), 1e-6)
    j_lvl = np.clip(np.floor(4 + np.log2(np.sqrt(area) / 224 + 1e-6)), 2, 5) - 2
    assert np.array_equal(levels, j_lvl)
    assert set(levels.ravel().tolist()) == {0, 1, 2, 3}
    got, kept = tile_gather(maps, rois, g, STRIDES, P, SR)
    assert {lvl for lvl, _, _ in kept} == {0, 1, 2, 3}
    want = _jax_vjp(maps, rois, g)

    def twin(xs):
        return multiscale_roi_align_batched_plain(xs, torch.from_numpy(rois), STRIDES, P, SR)

    t_maps = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    twin_grads = torch.autograd.grad(twin(t_maps), t_maps, torch.from_numpy(g))
    limits = chip_smoke.sum_order_tolerance(twin, [torch.from_numpy(m) for m in maps],
                                            torch.from_numpy(g))
    for lvl, (a, t_, w_, lim) in enumerate(zip(got, twin_grads, want, limits)):
        assert np.isfinite(a).all(), lvl  # every cell written
        assert chip_smoke.limit_ratio(torch.from_numpy(a), t_, lim) <= 1.0, lvl
        assert np.abs(a - w_).max() <= 1e-5 * np.abs(w_).max(), lvl


@pytest.mark.parametrize("seed", [0, 1])
def test_each_roi_gradient_stays_on_its_level_and_footprint(seed):
    """One RoI's output gradient at a time, through JAX's VJP: the
    gradient is exactly zero on every level but the RoI's own (roi_level)
    and, there, zero outside the RoI's footprint on that level (axis_span
    at the level's scale).  So a tile that culls the RoI loses nothing."""
    maps, rois, g = _pyramid_case(seed + 5, r=12)
    vjp = jax.jit(lambda ms, gg: jax.vjp(lambda *m: j_msra(m, jnp.asarray(rois), STRIDES, P, SR),
                                         *ms)[1](gg))
    jm = [jnp.asarray(m) for m in maps]
    reached = 0
    for b in range(B):
        for r in range(rois.shape[1]):
            one = np.zeros_like(g)
            one[b, r] = g[b, r]
            grads = [np.asarray(a) for a in vjp(jm, jnp.asarray(one))]
            lvl = roi_level(rois[b, r])
            for other in range(4):
                if other != lvl:
                    assert not grads[other].any(), (b, r, other)
            h, w = PYRAMID[lvl]
            x1, y1, bw, bh = roi_box(rois[b, r], f32(1) / f32(STRIDES[lvl]), P)
            y0, y1_ = axis_span(y1, bh, P, SR, h)
            x0, x1_ = axis_span(x1, bw, P, SR, w)
            mask = np.zeros((B, h, w), bool)
            mask[b, y0:y1_ + 1, x0:x1_ + 1] = True
            nonzero = np.abs(grads[lvl]).sum(-1) != 0
            assert not (nonzero & ~mask).any(), (b, r)
            reached += int(nonzero.any())
    assert reached == B * rois.shape[1]
