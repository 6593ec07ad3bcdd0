"""Two rules the RoI-align backward kernels rely on, checked on the CPU.

* The sum-order tolerance (`chip_smoke.sum_order_tolerance`): a float32
  gradient that adds the twin's contributions in another order (the
  backward kernels' tile gathers) is
  held to the twin per element within 64 float32 eps times the sum of the
  magnitudes of the element's contributions.  Here the twin's own float32
  gradient, with the RoIs in a permuted order, stays within that limit of
  a float64 gradient on several seeds, single-level and multiscale; and a
  gradient with one element moved by 10x its limit fails it.
* The footprint rule of the single-level backward's culling
  (csrc/roi_align.cu `axis_span`): every tap of a RoI lies in the rows from
  the low tap of its first sample to the high tap of its last, and the
  columns likewise.  The rule is written here in Python, float32 op for
  op as the device function, and the twin's gradient of each single RoI
  is zero outside it.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from faster_rcnn_pytorch_multimodal_tpu_torch.ops.roi_align import (  # noqa: E402
    _pool_frames,
    _sample_coords,
    _taps,
    multiscale_roi_align_batched_plain,
    roi_align_batched_plain,
    roi_levels,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

B, H, W, C, R = 2, 16, 20, 8, 32
STRIDE = 16
P, SR = 7, 2
FPN_HW = [(32, 40), (16, 20), (8, 10), (4, 5)]  # p2..p5 of a 128x160 frame
FPN_STRIDES = (4, 8, 16, 32)


def _rois(rng, b, r, frame_hw, sides=(2.0, 200.0)):
    """RoIs on a frame of frame_hw pixels: random ones, and in every frame
    ones straddling each edge, ones outside the frame, ones smaller than a
    stride-16 cell and one covering the whole frame."""
    fh, fw = frame_hw
    x1 = rng.uniform(-20, fw, (b, r))
    y1 = rng.uniform(-20, fh, (b, r))
    side = np.exp(rng.uniform(np.log(sides[0]), np.log(sides[1]), (b, r, 2)))
    rois = np.stack([x1, y1, x1 + side[..., 0], y1 + side[..., 1]], -1)
    rois[:, 0] = [-30, 10, 40, 60]  # over the left edge
    rois[:, 1] = [20, -25, 70, 30]  # over the top edge
    rois[:, 2] = [fw - 30, 20, fw + 40, 70]  # over the right edge
    rois[:, 3] = [30, fh - 20, 90, fh + 35]  # over the bottom edge
    rois[:, 4] = [fw + 100, fh + 50, fw + 180, fh + 90]  # outside
    rois[:, 5] = [-90, -70, -20, -10]  # outside, the other corner
    rois[:, 6] = [33.3, 41.7, 38.1, 44.9]  # smaller than a cell
    rois[:, 7] = [0, 0, fw, fh]  # the whole frame
    rois[:, 8] = [-200, -150, 400, 450]  # 600 px a side: the coarsest FPN level
    return rois.astype(np.float32)


def _grad(out, leaves, g):
    return torch.autograd.grad(out, leaves, g)


def _single_f64(feats, rois, g):
    """The twin's formula in float64: the same float32 sample coordinates
    and weights, taps and sums in float64."""
    f = feats.detach().double().requires_grad_(True)
    _, h, w, c = f.shape
    gy, gx = _sample_coords(rois, 1.0 / STRIDE, P, SR, False)
    out = _pool_frames(lambda i: f[i].reshape(h * w, c), gy, gx, h, w, 0, SR, c, torch.float64)
    return _grad(out, [f], g.double())


def _multiscale_f64(maps, rois, g):
    """multiscale_roi_align_batched_plain in float64, as _single_f64."""
    fs = [m.detach().double().requires_grad_(True) for m in maps]
    c = fs[0].shape[-1]
    lvl = roi_levels(rois, len(fs))
    hs = torch.tensor([m.shape[1] for m in fs])
    ws = torch.tensor([m.shape[2] for m in fs])
    sizes = hs * ws
    offsets = torch.cumsum(sizes, 0) - sizes
    scales = torch.tensor([1.0 / float(s) for s in FPN_STRIDES], dtype=torch.float32)
    gy, gx = _sample_coords(rois, scales[lvl], P, SR, False)
    out = _pool_frames(lambda i: torch.cat([m[i].reshape(-1, c) for m in fs]), gy, gx,
                       hs[lvl][..., None], ws[lvl][..., None], offsets[lvl][..., None, None], SR, c,
                       torch.float64)
    return _grad(out, fs, g.double())


def _single_case(seed):
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32))
    rois = torch.from_numpy(_rois(rng, B, R, (H * STRIDE, W * STRIDE)))
    g = torch.from_numpy(rng.normal(size=(B, R, P, P, C)).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(R))

    def twin(xs, rois_=rois):
        return roi_align_batched_plain(xs[0], rois_, 1.0 / STRIDE, P, SR)

    f = feats.clone().requires_grad_(True)
    permuted = _grad(twin([f], rois[:, perm]), [f], g[:, perm])
    return twin, [feats], rois, g, permuted, _single_f64(feats, rois, g)


def _multiscale_case(seed):
    rng = np.random.RandomState(seed)
    maps = [torch.from_numpy(rng.normal(size=(B,) + hw + (C,)).astype(np.float32)) for hw in FPN_HW]
    rois = torch.from_numpy(_rois(rng, B, R, (128, 160), sides=(8.0, 600.0)))
    g = torch.from_numpy(rng.normal(size=(B, R, P, P, C)).astype(np.float32))
    perm = torch.from_numpy(rng.permutation(R))

    def twin(xs, rois_=rois):
        return multiscale_roi_align_batched_plain(xs, rois_, FPN_STRIDES, P, SR)

    fs = [m.clone().requires_grad_(True) for m in maps]
    permuted = _grad(twin(fs, rois[:, perm]), fs, g[:, perm])
    return twin, maps, rois, g, permuted, _multiscale_f64(maps, rois, g)


CASES = {"single": _single_case, "multiscale": _multiscale_case}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_permuted_float32_gradient_within_the_sum_order_limit(kind, seed):
    twin, inputs, rois, g, permuted, exact = CASES[kind](seed)
    if kind == "multiscale":
        assert set(roi_levels(rois, 4).unique().tolist()) == {0, 1, 2, 3}
    limits = chip_smoke.sum_order_tolerance(twin, inputs, g)
    for got, want, lim in zip(permuted, exact, limits):
        assert got.dtype == torch.float32 and lim.shape == got.shape
        assert float(want.abs().max()) > 0
        ratio = chip_smoke.limit_ratio(got, want, lim)
        print(f"{kind} seed {seed}: max |fp32 - fp64| / limit {ratio:.3g}, "
              f"max limit / max|dF| {float(lim.max()) / float(want.abs().max()):.3g}")
        assert ratio <= 1.0


@pytest.mark.parametrize("kind", sorted(CASES))
def test_sum_order_limit_catches_one_element_off_by_ten_limits(kind):
    twin, inputs, _, g, permuted, exact = CASES[kind](3)
    limits = chip_smoke.sum_order_tolerance(twin, inputs, g)
    for got, want, lim in zip(permuted, exact, limits):
        assert chip_smoke.limit_ratio(got, want, lim) <= 1.0
        i = int(torch.argmax(lim))
        moved = got.clone().reshape(-1)
        moved[i] += 10 * lim.reshape(-1)[i]
        assert chip_smoke.limit_ratio(moved.reshape(got.shape), want, lim) > 1.0
        untouched = torch.nonzero(lim.reshape(-1) == 0)
        if untouched.numel():  # an element no RoI reaches must be exact
            moved = got.clone().reshape(-1)
            moved[int(untouched[0])] += 1e-30
            assert chip_smoke.limit_ratio(moved.reshape(got.shape), want, lim) > 1.0


def test_bf16_limit_covers_one_rounding_of_each_side():
    """bf16 gradients: the twin's bf16 gradient (rounded once from float32)
    within the limit of the float64 gradient rounded to bf16."""
    twin, inputs, rois, g, _, _ = _single_case(4)
    g = g.bfloat16()
    (exact,) = _single_f64(inputs[0], rois, g.float())
    f = inputs[0].bfloat16().requires_grad_(True)
    (got,) = _grad(twin([f]), [f], g)
    (lim,) = chip_smoke.sum_order_tolerance(twin, inputs, g, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert chip_smoke.limit_ratio(got, exact.bfloat16(), lim) <= 1.0


# -- the footprint rule ------------------------------------------------------


def _axis_taps(start, bin_size, s, sr, dim):
    """csrc/roi_align.cu axis_taps, float32 op for op: (lo, hi)."""
    f32 = np.float32
    frac = f32(f32(s) + f32(0.5)) / f32(sr)
    c = min(max(f32(start + f32(frac * bin_size)), f32(0)), f32(dim - 1))
    lo = int(np.floor(c))
    return lo, min(lo + 1, dim - 1)


def footprint(roi, scale, p, sr, h, w):
    """csrc/roi_align.cu roi_box + axis_span: the rows and columns
    (y0, y1, x0, x1), inclusive, that a RoI's taps can touch: from the low
    tap of sample 0 to the high tap of sample p * sr - 1 on each axis.
    aligned=False: the RoI's size floored at one cell."""
    f32 = np.float32
    x1, y1, x2, y2 = (f32(f32(v) * f32(scale)) for v in roi)
    bin_w = max(f32(x2 - x1), f32(1)) / f32(p)
    bin_h = max(f32(y2 - y1), f32(1)) / f32(p)
    last = p * sr - 1
    return (_axis_taps(y1, bin_h, 0, sr, h)[0], _axis_taps(y1, bin_h, last, sr, h)[1],
            _axis_taps(x1, bin_w, 0, sr, w)[0], _axis_taps(x1, bin_w, last, sr, w)[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_roi_gradient_lies_inside_its_footprint(seed):
    rng = np.random.RandomState(seed + 10)
    rois = _rois(rng, 1, 24, (H * STRIDE, W * STRIDE))[0]
    feats = torch.from_numpy(rng.normal(size=(1, H, W, C)).astype(np.float32))
    touched = 0
    for roi in rois:
        y0, y1, x0, x1 = footprint(roi, 1.0 / STRIDE, P, SR, H, W)
        assert 0 <= y0 <= y1 < H and 0 <= x0 <= x1 < W
        r = torch.from_numpy(roi[None, None])
        # the rule is the extreme taps of the twin's samples
        gy, gx = _sample_coords(r, 1.0 / STRIDE, P, SR, False)
        ylo, yhi, _, _ = _taps(gy, H)
        xlo, xhi, _, _ = _taps(gx, W)
        assert (int(ylo.min()), int(yhi.max()), int(xlo.min()), int(xhi.max())) == (y0, y1, x0, x1)
        f = feats.clone().requires_grad_(True)
        g = torch.from_numpy(rng.normal(size=(1, 1, P, P, C)).astype(np.float32))
        (grad,) = _grad(roi_align_batched_plain(f, r, 1.0 / STRIDE, P, SR), [f], g)
        nonzero = grad[0].abs().sum(-1) != 0
        inside = torch.zeros(H, W, dtype=torch.bool)
        inside[y0:y1 + 1, x0:x1 + 1] = True
        assert not bool((nonzero & ~inside).any())
        touched += int(nonzero.any())
    assert touched == len(rois)  # every RoI, outside ones too, reaches some cell
