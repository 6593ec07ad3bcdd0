"""RoI align, single-level (C4) and multiscale (FPN): hand-written CUDA
kernels (forward and the feature gradient) and their plain twins.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/roi_align.py:32-242
(`_sample_coords`, `roi_align`, `roi_align_batched`, `multiscale_roi_align`,
`multiscale_roi_align_batched`).  Semantics follow the
JAX package: torchvision's box mapping with aligned=False (RoI size floored at
1 feature cell), a FIXED sampling_ratio (parity waiver 6), sample coordinates
clamped to [0, dim - 1] before the bilinear taps, and the mean over the
sr x sr samples of each bin.  Features are NHWC.  The RoIs get no gradient,
as under the JAX package's stop_gradient (ops/roi_align.py:144).

On a CUDA tensor `roi_align_batched` runs `_RoIAlignCuda`, an autograd
Function whose forward launches the forward kernel of csrc/roi_align.cu and
whose backward launches its backward kernel, or raises.  On a CPU tensor it
runs `roi_align_batched_plain`, a gather formulation of the same formula,
which torch's autograd differentiates.  `multiscale_roi_align_batched`
dispatches the same way, to `_MultiscaleRoIAlignCuda` or
`multiscale_roi_align_batched_plain`: each RoI is pooled from the one level
that torchvision's LevelMapper gives it (`roi_levels`).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16
_KERNEL_LEVELS = 4  # the multiscale kernels' pyramid: p2..p5
_FWD_MAX_P = 7  # csrc/roi_align.cu kFwdMaxP: bins a side of the single-level forward
_FWD_MAX_SAMPLES = 32  # kFwdMaxSamples: P x sr, one lane a sample builds its read plan


def _sample_coords(rois, spatial_scale, p, sr, aligned):
    """(..., 4) rois -> (gy, gx), each (..., p * sr) sample coordinates on
    the feature map, unclamped."""
    offset = 0.5 if aligned else 0.0
    x1 = rois[..., 0] * spatial_scale - offset
    y1 = rois[..., 1] * spatial_scale - offset
    x2 = rois[..., 2] * spatial_scale - offset
    y2 = rois[..., 3] * spatial_scale - offset
    floor = 0.0 if aligned else 1.0
    roi_w = torch.clamp(x2 - x1, min=floor)
    roi_h = torch.clamp(y2 - y1, min=floor)
    s_idx = (torch.arange(p * sr, dtype=torch.float32, device=rois.device) + 0.5) / sr
    gx = x1[..., None] + s_idx * (roi_w / p)[..., None]
    gy = y1[..., None] + s_idx * (roi_h / p)[..., None]
    return gy, gx


def _taps(coords, dim):
    """Clamped coordinates -> (lo, hi, w_lo, w_hi) of the bilinear taps.
    `dim` is an int, or an int64 tensor of per-RoI sizes broadcasting
    against `coords`."""
    top = dim - 1
    c = torch.minimum(torch.clamp(coords, min=0.0), torch.as_tensor(top, dtype=coords.dtype))
    lo = torch.floor(c)
    w_hi = c - lo
    lo = lo.long()
    return lo, torch.minimum(lo + 1, torch.as_tensor(top)), 1.0 - w_hi, w_hi


def _pool_frames(flat_rows, gy, gx, h, w, row_base, sr, c, dtype):
    """The sr x sr sample mean of every bin, gathered one frame at a time to
    bound the intermediates.  flat_rows(f): frame f's (N, C) float32 rows;
    gy, gx (B, R, P*SR) sample coordinates; h, w the map size (ints or
    per-RoI (B, R, 1) tensors); the tap (y, x) is row row_base + y * w + x.
    Returns (B, R, P, P, C) in `dtype`."""
    ylo, yhi, wylo, wyhi = _taps(gy, h)
    xlo, xhi, wxlo, wxhi = _taps(gx, w)
    wl = w[..., None] if torch.is_tensor(w) else w  # (B, R, 1, 1) or int
    out = []
    for f in range(gy.shape[0]):
        flat = flat_rows(f)
        base, wf = (row_base[f], wl[f]) if torch.is_tensor(wl) else (row_base, wl)
        acc = None
        for iy in range(sr):
            ys = slice(iy, None, sr)  # sample iy of every bin: (R, P)
            for ix in range(sr):
                xs = slice(ix, None, sr)
                val = None
                for yi, wy in ((ylo, wylo), (yhi, wyhi)):
                    for xi, wx in ((xlo, wxlo), (xhi, wxhi)):
                        idx = base + yi[f][:, ys, None] * wf + xi[f][:, None, xs]  # (R, P, P)
                        wt = (wy[f][:, ys, None] * wx[f][:, None, xs])[..., None]
                        tap = wt * flat[idx.reshape(-1)].reshape(idx.shape + (c,))
                        val = tap if val is None else val + tap
                acc = val if acc is None else acc + val
        out.append((acc / (sr * sr)).to(dtype))
    return torch.stack(out)


def roi_align_batched_plain(
    features, rois, spatial_scale, output_size=7, sampling_ratio=2, aligned=False
):
    """Plain PyTorch RoI align: (B, H, W, C), (B, R, 4) -> (B, R, P, P, C).

    Computes in float32 and returns the features' dtype."""
    _, h, w, c = features.shape
    gy, gx = _sample_coords(rois.float(), spatial_scale, output_size, sampling_ratio, aligned)
    return _pool_frames(lambda f: features[f].reshape(h * w, c).float(), gy, gx, h, w, 0,
                        sampling_ratio, c, features.dtype)


def _roi_align_cuda(features, rois, spatial_scale, p, sr, aligned):
    b, h, w, c = features.shape
    r = rois.shape[1]
    out = torch.empty((b, r, p, p, c), dtype=features.dtype, device=features.device)
    if out.numel() == 0:
        return out
    vec = _VEC_BYTES // features.element_size()
    vectorized = (
        c % vec == 0
        and features.data_ptr() % _VEC_BYTES == 0
        and out.data_ptr() % _VEC_BYTES == 0
    )
    lib = _build.library()
    with torch.cuda.device(features.device):
        err = lib.frcnn_roi_align_fwd(
            features.data_ptr(), rois.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[features.dtype], int(vectorized), b, h, w, c, r,
            float(spatial_scale), p, sr, int(aligned),
            _build.stream_handle(features.device),
        )
    _build.check(err, "frcnn_roi_align_fwd")
    _build.LAUNCH_COUNTS["roi_align"] += 1
    return out


def _bwd_scratch(lib, b, r, levels, device):
    """The backward entries' scratch: each RoI's footprint and the frames'
    RoIs listed by level, written by their first pass."""
    nbytes = lib.frcnn_roi_align_bwd_scratch_bytes(b, r, levels)
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)


def _roi_align_bwd_cuda(grad_out, rois, feat_shape, feat_dtype, spatial_scale, p, sr, aligned):
    """Feature gradient (B, H, W, C) in the features' dtype from the output
    gradient (B, R, P, P, C): a first pass lists each frame's RoIs with
    their footprints, then the backward kernel owns tiles of the map,
    gathers each cell's contributions in a fixed order and writes every
    element once (bf16 rounded in the same pass), so the gradient starts
    empty and the result is the same from run to run."""
    b, h, w, c = feat_shape
    r = rois.shape[1]
    device = grad_out.device
    grad_out = grad_out.to(feat_dtype).contiguous()
    grad = torch.empty(feat_shape, dtype=feat_dtype, device=device)
    if grad.numel() == 0:
        return grad
    lib = _build.library()
    scratch = _bwd_scratch(lib, b, r, 1, device)
    with torch.cuda.device(device):
        err = lib.frcnn_roi_align_bwd(
            grad_out.data_ptr(), rois.data_ptr(), grad.data_ptr(), scratch.data_ptr(),
            _DTYPE_CODE[feat_dtype], b, h, w, c, r,
            float(spatial_scale), p, sr, int(aligned), _build.stream_handle(device),
        )
    _build.check(err, "frcnn_roi_align_bwd")
    _build.LAUNCH_COUNTS["roi_align_bwd"] += 1
    return grad


class _RoIAlignCuda(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel; the RoIs
    get no gradient."""

    @staticmethod
    def forward(ctx, features, rois, spatial_scale, p, sr, aligned):
        ctx.save_for_backward(rois)
        ctx.geometry = (features.shape, features.dtype, spatial_scale, p, sr, aligned)
        return _roi_align_cuda(features, rois, spatial_scale, p, sr, aligned)

    @staticmethod
    def backward(ctx, grad_out):
        (rois,) = ctx.saved_tensors
        shape, dtype, spatial_scale, p, sr, aligned = ctx.geometry
        grad = None
        if ctx.needs_input_grad[0]:
            grad = _roi_align_bwd_cuda(grad_out, rois, shape, dtype, spatial_scale, p, sr, aligned)
        return grad, None, None, None, None, None


def roi_align_batched(
    features: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float,
    output_size: int = 7,
    sampling_ratio: int = 2,
    aligned: bool = False,
) -> torch.Tensor:
    """Batched RoI align.

    Args:
      features: (B, H, W, C) NHWC feature maps, float32 or bfloat16.
      rois: (B, R, 4) float32 boxes [x1, y1, x2, y2] in input pixels.
      spatial_scale: feature stride reciprocal (1/16 for C4).
      output_size: bins per side (cfg.POOLING_SIZE).
      sampling_ratio: fixed samples per bin side.
      aligned: half-pixel offset (False keeps torchvision's legacy mapping).

    Returns: (B, R, output_size, output_size, C) in the features' dtype,
    differentiable in the features only.
    """
    if features.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(
            f"roi_align: features (B,H,W,C) and rois (B,R,4) required, got "
            f"{tuple(features.shape)}, {tuple(rois.shape)}"
        )
    if rois.shape[0] != features.shape[0]:
        raise ValueError("roi_align: features and rois disagree on the batch")
    if features.dtype not in _DTYPE_CODE or rois.dtype != torch.float32:
        raise TypeError(
            f"roi_align: float32/bfloat16 features and float32 rois required, "
            f"got {features.dtype}, {rois.dtype}"
        )
    if rois.device != features.device:
        raise ValueError("roi_align: features and rois must be on one device")
    if output_size < 1 or sampling_ratio < 1:
        raise ValueError("roi_align: output_size and sampling_ratio must be >= 1")
    rois = rois.detach()
    if features.device.type == "cpu":
        return roi_align_batched_plain(
            features, rois, spatial_scale, output_size, sampling_ratio, aligned
        )
    if features.device.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {features.device}")
    if not (features.is_contiguous() and rois.is_contiguous()):
        raise ValueError("roi_align: contiguous NHWC features and rois required")
    if output_size > _FWD_MAX_P or output_size * sampling_ratio > _FWD_MAX_SAMPLES:
        raise ValueError(f"roi_align: the CUDA forward holds at most {_FWD_MAX_P} bins a side "
                         f"in registers and {_FWD_MAX_SAMPLES} samples a side, got output_size "
                         f"{output_size}, sampling_ratio {sampling_ratio}")
    return _RoIAlignCuda.apply(
        features, rois, spatial_scale, output_size, sampling_ratio, aligned
    )


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float,
    output_size: int = 7,
    sampling_ratio: int = 2,
    aligned: bool = False,
) -> torch.Tensor:
    """One frame: features (H, W, C), rois (R, 4) -> (R, P, P, C)."""
    return roi_align_batched(
        features[None], rois[None], spatial_scale, output_size,
        sampling_ratio, aligned,
    )[0]


# -- multiscale (FPN) -------------------------------------------------------


def level_thresholds(num_levels: int, canonical_level: int = 4) -> list:
    """x >= thresholds[j - 1] maps a RoI to level index >= j, where
    x = sqrt(area) / canonical_scale + 1e-6: floor(k + log2(x)) >= j + k0
    exactly when x >= 2^(j + k0 - k), with k0 = k - (L - 2) the finest
    level's id (2 for p2..p5)."""
    k0 = canonical_level - (num_levels - 2)
    return [2.0 ** (k0 + j - canonical_level) for j in range(1, num_levels)]


def roi_levels(
    rois: torch.Tensor, num_levels: int, canonical_scale: int = 224, canonical_level: int = 4
) -> torch.Tensor:
    """torchvision's LevelMapper as the JAX package writes it,
    clip(floor(k + log2(sqrt(max(area, 1e-6)) / s + 1e-6)), k0, k0 + L - 1) - k0,
    without the log2 (see level_thresholds): (..., 4) float32 rois ->
    (...) int64 level indices 0..L-1 (0 = the finest map).  The area has no
    +1.  Every step is one float32 op, as in the CUDA kernels."""
    rois = rois.float()
    area = ((rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])).clamp(min=1e-6)
    x = torch.sqrt(area) / canonical_scale + 1e-6
    lvl = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for t in level_thresholds(num_levels, canonical_level):
        lvl += (x >= t).long()
    return lvl


def multiscale_roi_align_batched_plain(
    feature_maps, rois, strides, output_size=7, sampling_ratio=2,
    canonical_scale=224, canonical_level=4,
):
    """Plain PyTorch multiscale RoI align: each RoI gathers its bilinear taps
    from its mapped level only, through the single-level twin's sample
    coordinates and taps with per-RoI scale and map size.  Maps
    (B, H_l, W_l, C) finest first, rois (B, R, 4) -> (B, R, P, P, C) in the
    maps' dtype, computed in float32 one frame at a time; torch's autograd
    differentiates it in the maps."""
    c = feature_maps[0].shape[-1]
    device = rois.device
    rois = rois.float()
    lvl = roi_levels(rois, len(feature_maps), canonical_scale, canonical_level)  # (B, R)
    hs = torch.tensor([f.shape[1] for f in feature_maps], device=device)
    ws = torch.tensor([f.shape[2] for f in feature_maps], device=device)
    sizes = hs * ws
    offsets = torch.cumsum(sizes, 0) - sizes  # each level's first row in a frame's rows
    scales = torch.tensor([1.0 / float(s) for s in strides], dtype=torch.float32, device=device)
    gy, gx = _sample_coords(rois, scales[lvl], output_size, sampling_ratio, False)
    return _pool_frames(
        lambda f: torch.cat([m[f].reshape(-1, c) for m in feature_maps]).float(),
        gy, gx, hs[lvl][..., None], ws[lvl][..., None], offsets[lvl][..., None, None],
        sampling_ratio, c, feature_maps[0].dtype,
    )


def _level_arrays(shapes, strides):
    """Host arrays of the maps' heights, widths and scales for the kernels."""
    n = len(shapes)
    heights = (ctypes.c_int * n)(*(s[1] for s in shapes))
    widths = (ctypes.c_int * n)(*(s[2] for s in shapes))
    scales = (ctypes.c_float * n)(*(1.0 / float(s) for s in strides))
    return heights, widths, scales


def _addr(arr) -> int:
    return ctypes.cast(arr, ctypes.c_void_p).value


def _multiscale_roi_align_cuda(feature_maps, rois, strides, p, sr):
    """The forward kernel over the four maps p2..p5 (canonical scale 224 at
    level 4): the single-level forward's staged read plan on each RoI's
    level.  Returns (out (B, R, P, P, C), levels (B, R) int32)."""
    b, c = feature_maps[0].shape[0], feature_maps[0].shape[-1]
    r = rois.shape[1]
    device, dtype = rois.device, feature_maps[0].dtype
    out = torch.empty((b, r, p, p, c), dtype=dtype, device=device)
    levels = torch.empty((b, r), dtype=torch.int32, device=device)
    vec = _VEC_BYTES // feature_maps[0].element_size()
    vectorized = c % vec == 0 and all(
        t.data_ptr() % _VEC_BYTES == 0 for t in (*feature_maps, out))
    ptrs = (ctypes.c_void_p * _KERNEL_LEVELS)(*(f.data_ptr() for f in feature_maps))
    heights, widths, scales = _level_arrays([f.shape for f in feature_maps], strides)
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.frcnn_roi_align_ms_fwd(
            _addr(ptrs), _addr(heights), _addr(widths), _addr(scales),
            rois.data_ptr(), out.data_ptr(), levels.data_ptr(), _DTYPE_CODE[dtype],
            int(vectorized), b, c, r, p, sr, _build.stream_handle(device),
        )
    _build.check(err, "frcnn_roi_align_ms_fwd")
    _build.LAUNCH_COUNTS["roi_align_multiscale"] += 1
    return out, levels


def _multiscale_roi_align_bwd_cuda(grad_out, rois, shapes, dtype, strides, p, sr):
    """The maps' gradients (a tuple of (B, H_l, W_l, C) in the maps' dtype)
    from dOut (B, R, P, P, C): a first pass lists each frame's RoIs by
    level, then the backward kernel gathers each tile of each level's map
    from the RoIs mapped to that level, in a fixed order, and writes every
    element once (bf16 rounded in the same pass), so the gradients start
    empty and the result is the same from run to run.  Four maps, p2..p5."""
    device = grad_out.device
    b, _, _, c = shapes[0]
    r = rois.shape[1]
    grad_out = grad_out.to(dtype).contiguous()
    grads = tuple(torch.empty(s, dtype=dtype, device=device) for s in shapes)
    ptrs = (ctypes.c_void_p * _KERNEL_LEVELS)(*(g.data_ptr() for g in grads))
    heights, widths, scales = _level_arrays(shapes, strides)
    lib = _build.library()
    scratch = _bwd_scratch(lib, b, r, _KERNEL_LEVELS, device)
    with torch.cuda.device(device):
        err = lib.frcnn_roi_align_ms_bwd(
            grad_out.data_ptr(), rois.data_ptr(), _addr(ptrs), scratch.data_ptr(),
            _addr(heights), _addr(widths), _addr(scales), _DTYPE_CODE[dtype], b, c, r, p, sr,
            _build.stream_handle(device),
        )
    _build.check(err, "frcnn_roi_align_ms_bwd")
    _build.LAUNCH_COUNTS["roi_align_multiscale_bwd"] += 1
    return grads


class _MultiscaleRoIAlignCuda(torch.autograd.Function):
    """The multiscale forward kernel, differentiated by its backward kernel;
    the RoIs get no gradient."""

    @staticmethod
    def forward(ctx, rois, geometry, *feature_maps):  # geometry: (strides, P, sr)
        ctx.save_for_backward(rois)
        ctx.geometry = geometry
        ctx.shapes = [tuple(f.shape) for f in feature_maps]
        ctx.dtype = feature_maps[0].dtype
        out, _levels = _multiscale_roi_align_cuda(feature_maps, rois, *geometry)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        (rois,) = ctx.saved_tensors
        grads = (None,) * len(ctx.shapes)
        if any(ctx.needs_input_grad[2:]):
            grads = _multiscale_roi_align_bwd_cuda(
                grad_out, rois, ctx.shapes, ctx.dtype, *ctx.geometry)
        return (None, None, *grads)


def multiscale_roi_align_batched(
    feature_maps: Sequence[torch.Tensor],
    rois: torch.Tensor,
    strides: Sequence[int],
    output_size: int = 7,
    sampling_ratio: int = 2,
    canonical_scale: int = 224,
    canonical_level: int = 4,
) -> torch.Tensor:
    """Batched FPN multiscale RoI align.

    Args:
      feature_maps: up to 4 (B, H_l, W_l, C) NHWC maps, finest first (p2..p5),
        one dtype, float32 or bfloat16.  On CUDA exactly 4, with the
        canonical scale 224 at level 4 (the kernels' pyramid).
      rois: (B, R, 4) float32 boxes [x1, y1, x2, y2] in input pixels.
      strides: the maps' strides, e.g. (4, 8, 16, 32).
      output_size, sampling_ratio: as in roi_align_batched (aligned=False).
      canonical_scale, canonical_level: the LevelMapper's 224 and 4.

    Returns: (B, R, output_size, output_size, C) in the maps' dtype, each RoI
    pooled from its level (roi_levels), differentiable in the maps only.
    """
    maps = tuple(feature_maps)
    if not 1 <= len(maps) <= 4 or len(strides) != len(maps):
        raise ValueError(f"multiscale_roi_align: 1-4 maps with one stride each, got "
                         f"{len(maps)} maps, {len(strides)} strides")
    if rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"multiscale_roi_align: rois (B,R,4) required, got {tuple(rois.shape)}")
    b, c = rois.shape[0], maps[0].shape[-1]
    for m in maps:
        if m.dim() != 4 or m.shape[0] != b or m.shape[-1] != c:
            raise ValueError(f"multiscale_roi_align: maps (B,H,W,C) with the rois' batch and one C "
                             f"required, got {[tuple(x.shape) for x in maps]}, rois {tuple(rois.shape)}")
        if m.dtype != maps[0].dtype or m.device != rois.device:
            raise ValueError("multiscale_roi_align: the maps and rois need one dtype and device")
    if maps[0].dtype not in _DTYPE_CODE or rois.dtype != torch.float32:
        raise TypeError(f"multiscale_roi_align: float32/bfloat16 maps and float32 rois required, "
                        f"got {maps[0].dtype}, {rois.dtype}")
    if output_size < 1 or sampling_ratio < 1:
        raise ValueError("multiscale_roi_align: output_size and sampling_ratio must be >= 1")
    rois = rois.detach()
    geometry = (tuple(int(s) for s in strides), output_size, sampling_ratio)
    if rois.device.type == "cpu":
        return multiscale_roi_align_batched_plain(maps, rois, *geometry, canonical_scale,
                                                  canonical_level)
    if rois.device.type != "cuda":
        raise ValueError(f"multiscale_roi_align: unsupported device {rois.device}")
    if len(maps) != _KERNEL_LEVELS or (canonical_scale, canonical_level) != (224, 4):
        raise NotImplementedError(
            f"multiscale_roi_align: the CUDA kernels pool the detector's pyramid, 4 maps p2..p5 "
            f"with canonical scale 224 at level 4; got {len(maps)} maps, "
            f"{canonical_scale} at level {canonical_level}")
    if not (rois.is_contiguous() and all(m.is_contiguous() for m in maps)):
        raise ValueError("multiscale_roi_align: contiguous NHWC maps and rois required")
    if output_size > _FWD_MAX_P or output_size * sampling_ratio > _FWD_MAX_SAMPLES:
        raise ValueError(f"multiscale_roi_align: the CUDA forward holds at most {_FWD_MAX_P} bins "
                         f"a side in registers and {_FWD_MAX_SAMPLES} samples a side, got "
                         f"output_size {output_size}, sampling_ratio {sampling_ratio}")
    return _MultiscaleRoIAlignCuda.apply(rois, geometry, *maps)


def multiscale_roi_align(feature_maps, rois, strides, output_size=7, sampling_ratio=2,
                         canonical_scale=224, canonical_level=4):
    """One frame: maps (H_l, W_l, C), rois (R, 4) -> (R, P, P, C)."""
    return multiscale_roi_align_batched(
        [m[None] for m in feature_maps], rois[None], strides, output_size, sampling_ratio,
        canonical_scale, canonical_level,
    )[0]
