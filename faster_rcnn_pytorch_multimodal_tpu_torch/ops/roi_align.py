"""Single-level RoI align: hand-written CUDA kernels (forward and the
feature gradient) and their plain twin.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/roi_align.py:32-150
(`_sample_coords`, `roi_align`, `roi_align_batched`).  Semantics follow the
JAX package: torchvision's box mapping with aligned=False (RoI size floored at
1 feature cell), a FIXED sampling_ratio (parity waiver 6), sample coordinates
clamped to [0, dim - 1] before the bilinear taps, and the mean over the
sr x sr samples of each bin.  Features are NHWC.  The RoIs get no gradient,
as under the JAX package's stop_gradient (ops/roi_align.py:144).

On a CUDA tensor `roi_align_batched` runs `_RoIAlignCuda`, an autograd
Function whose forward launches the forward kernel of csrc/roi_align.cu and
whose backward launches its backward kernel, or raises.  On a CPU tensor it
runs `roi_align_batched_plain`, a gather formulation of the same formula,
which torch's autograd differentiates.
"""

from __future__ import annotations

import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16


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
    """Clamped coordinates -> (lo, hi, w_lo, w_hi) of the bilinear taps."""
    c = torch.clamp(coords, 0.0, dim - 1.0)
    lo = torch.floor(c)
    w_hi = c - lo
    lo = lo.long()
    return lo, torch.clamp(lo + 1, max=dim - 1), 1.0 - w_hi, w_hi


def roi_align_batched_plain(
    features, rois, spatial_scale, output_size=7, sampling_ratio=2, aligned=False
):
    """Plain PyTorch RoI align: (B, H, W, C), (B, R, 4) -> (B, R, P, P, C).

    Computes in float32 and returns the features' dtype; one frame at a time
    to bound the gathered intermediates."""
    b, h, w, c = features.shape
    p, sr = output_size, sampling_ratio
    gy, gx = _sample_coords(rois.float(), spatial_scale, p, sr, aligned)
    ylo, yhi, wylo, wyhi = _taps(gy, h)  # (B, R, P*SR)
    xlo, xhi, wxlo, wxhi = _taps(gx, w)
    out = []
    for f in range(b):
        flat = features[f].reshape(h * w, c).float()
        acc = None
        for iy in range(sr):
            ys = slice(iy, None, sr)  # sample iy of every bin: (R, P)
            for ix in range(sr):
                xs = slice(ix, None, sr)
                val = None
                for yi, wy in ((ylo, wylo), (yhi, wyhi)):
                    for xi, wx in ((xlo, wxlo), (xhi, wxhi)):
                        idx = yi[f][:, ys, None] * w + xi[f][:, None, xs]  # (R, P, P)
                        wt = (wy[f][:, ys, None] * wx[f][:, None, xs])[..., None]
                        tap = wt * flat[idx.reshape(-1)].reshape(idx.shape + (c,))
                        val = tap if val is None else val + tap
                acc = val if acc is None else acc + val
        out.append((acc / (sr * sr)).to(features.dtype))
    return torch.stack(out)


def _roi_align_cuda(features, rois, spatial_scale, p, sr, aligned):
    b, h, w, c = features.shape
    r = rois.shape[1]
    out = torch.empty((b, r, p, p, c), dtype=features.dtype, device=features.device)
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


def _roi_align_bwd_cuda(grad_out, rois, feat_shape, feat_dtype, spatial_scale, p, sr, aligned):
    """Feature gradient (B, H, W, C) in the features' dtype from the output
    gradient (B, R, P, P, C): float32 atomics into a zeroed accumulator,
    then (bfloat16) one rounding pass, both in the backward kernel's entry."""
    b, h, w, c = feat_shape
    r = rois.shape[1]
    device = grad_out.device
    grad_out = grad_out.to(feat_dtype).contiguous()
    accum = torch.zeros(feat_shape, dtype=torch.float32, device=device)
    grad = accum if feat_dtype == torch.float32 else torch.empty(
        feat_shape, dtype=feat_dtype, device=device)
    if grad_out.numel() == 0:
        return grad.zero_()
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.frcnn_roi_align_bwd(
            grad_out.data_ptr(), rois.data_ptr(), accum.data_ptr(), grad.data_ptr(),
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
