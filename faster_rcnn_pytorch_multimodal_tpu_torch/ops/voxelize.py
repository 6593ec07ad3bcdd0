"""LiDAR points -> BEV raster: a hand-written CUDA kernel and its plain twin.

Port of faster_rcnn_pytorch_multimodal_tpu/ops/voxelize.py:39-129
(`voxelize_bev`, `bev_grid_size`).  The raster of one frame is
(num_y, num_x, num_slices + num_meta) float32, y-major:
  * channel s < num_slices: the largest height above the slice floor of the
    points in voxel (x, y, s), 0 for an empty voxel;
  * channel num_slices: the density min(count, max_pts_per_voxel) /
    max_pts_per_voxel, the largest over the column's slices;
  * the next two: tanh of the column's mean intensity and mean elongation.
A point counts when it is valid and its (ix, iy, iz) lies inside the grid;
every other point goes nowhere (the JAX code's trash segment).

The arithmetic is that of the JAX package's serving path, the loader's
``jax.jit(jax.vmap(partial(voxelize_bev, **grid)))`` (data/loader.py:443-468),
in float32.  There the grid constants fold at compile time, and XLA's
algebraic simplifier turns every division by a constant into a multiply by
its float32 reciprocal 1.0f / c.  So the pitch is
``eff_x = (x1 - x0) * (1.0f / num_x)`` in float32 (at 80 m / 400 cells that
is 0.19999999, not 0.2f: the product is a tie that rounds to even), and
``ix = floor((x - x0) * (1.0f / eff_x))``; likewise y; ``zs = z - z0``,
``iz = floor(zs * (1.0f / voxel_height))``, ``rel_h = zs - iz *
voxel_height`` with the product rounded first, and the density
``min(count, cap) * (1.0f / cap)``.  With that, the height and density
channels equal the JAX loader's bit for bit.  (A direct call of the jitted
JAX function takes the ranges as traced arguments and divides truly by
eff_x, which puts some of the points that lie on a cell boundary in the
next cell.)  The meta channels are float sums whose order depends on the
backend (arrival order within a tile on the card), so they agree to ~1e-6.

On a CUDA tensor `voxelize_bev` launches csrc/voxelize.cu or raises; on a CPU
tensor it runs `voxelize_bev_plain` (scatter_reduce / index_add_ into
segments with a trailing trash segment, as the JAX code does).
"""

from __future__ import annotations

from typing import Tuple

import torch

from faster_rcnn_pytorch_multimodal_tpu_torch.ops import _build

_MAX_SLICES = 111  # csrc/voxelize.cu: a tile's 2 x 256 x S voxel words in shared memory


def _f32(v: float) -> torch.Tensor:
    """The float32 rounding of a Python float, as a 0-d tensor."""
    return torch.tensor(float(v), dtype=torch.float32)


def _recip(v) -> torch.Tensor:
    """1.0f / float32(v), rounded in float32: XLA's reciprocal of a constant."""
    return _f32(1.0) / (v if isinstance(v, torch.Tensor) else _f32(v))


def _pitch_recip(lo: float, hi: float, n: int) -> torch.Tensor:
    """1.0f / ((hi - lo) * (1.0f / n)), every step rounded in float32: the
    folded reciprocal of the cell pitch in the JAX loader's raster."""
    return _recip((_f32(hi) - _f32(lo)) * _recip(n))


def _indices(points, x_range, y_range, z_range, voxel_height, num_x, num_y):
    """(ix, iy, iz) int64 and zs float32 of (..., 5) points, in the float32
    operation order of the JAX loader's raster."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    dev = points.device
    zs = z - _f32(z_range[0]).to(dev)
    ix = torch.floor((x - _f32(x_range[0]).to(dev)) * _pitch_recip(*x_range, num_x).to(dev))
    iy = torch.floor((y - _f32(y_range[0]).to(dev)) * _pitch_recip(*y_range, num_y).to(dev))
    iz = torch.floor(zs * _recip(voxel_height).to(dev))
    return ix.long(), iy.long(), iz.long(), zs


def voxelize_bev_plain(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    x_range: Tuple[float, float],
    y_range: Tuple[float, float],
    z_range: Tuple[float, float],
    voxel_len: float,
    voxel_height: float,
    num_x: int,
    num_y: int,
    num_slices: int,
    num_meta: int = 3,
    max_pts_per_voxel: int = 32,
) -> torch.Tensor:
    """Plain PyTorch voxelizer: (B, P, 5), (B, P) -> (B, num_y, num_x, C).

    `voxel_len` is accepted for the JAX signature; the grid pitch comes from
    the ranges and num_x / num_y, as in the JAX code."""
    del voxel_len
    b = points.shape[0]
    dev = points.device
    ix, iy, iz, zs = _indices(points, x_range, y_range, z_range, voxel_height, num_x, num_y)
    ok = (valid & (ix >= 0) & (ix < num_x) & (iy >= 0) & (iy < num_y)
          & (iz >= 0) & (iz < num_slices))
    n_col = num_y * num_x
    n_vox = n_col * num_slices
    frame = torch.arange(b, device=dev)[:, None]
    # y-major segments, one block per frame, one trash segment at the end
    col = iy * num_x + ix
    col_id = torch.where(ok, frame * n_col + col, b * n_col).reshape(-1)
    vox_id = torch.where(ok, (frame * n_col + col) * num_slices + iz, b * n_vox).reshape(-1)
    okf = ok.reshape(-1)

    rel_h = torch.where(ok, zs - iz.float() * _f32(voxel_height).to(dev),
                        torch.zeros((), device=dev))
    # zero init: empty voxels and slightly negative heights give 0, which is
    # the JAX code's maximum(segment_max, 0)
    height = torch.zeros(b * n_vox + 1, device=dev).scatter_reduce(
        0, vox_id, rel_h.reshape(-1), "amax", include_self=True)[:-1]
    channels = [height.reshape(b, num_y, num_x, num_slices)]

    ones = okf.float()
    col_cnt = torch.zeros(b * n_col + 1, device=dev).index_add_(0, col_id, ones)[:-1]
    col_cnt_safe = torch.clamp(col_cnt, min=1.0)
    if num_meta >= 1:
        vox_cnt = torch.zeros(b * n_vox + 1, device=dev).index_add_(0, vox_id, ones)[:-1]
        cap = _f32(max_pts_per_voxel).to(dev)
        density = torch.minimum(vox_cnt, cap) * _recip(max_pts_per_voxel).to(dev)
        channels.append(density.reshape(b, num_y, num_x, num_slices).amax(dim=3, keepdim=True))
    for m, k in ((2, 3), (3, 4)):
        if num_meta >= m:
            val = torch.where(ok, points[..., k], torch.zeros((), device=dev)).reshape(-1)
            s = torch.zeros(b * n_col + 1, device=dev).index_add_(0, col_id, val)[:-1]
            # tanh in float64, rounded once: torch's float32 tanh on the CPU
            # has returned values ~4e-5 off on its first call in a process
            mean = (s / col_cnt_safe).double()
            channels.append(torch.tanh(mean).float().reshape(b, num_y, num_x, 1))
    return torch.cat(channels, dim=3)


def _voxelize_cuda(points, valid, x_range, y_range, z_range, voxel_height,
                   num_x, num_y, num_slices, num_meta, max_pts_per_voxel):
    """The four passes of csrc/voxelize.cu: the points counting-sorted by
    tile of the raster, then one block a tile writes its cells once, so
    `out` starts empty; the scratch holds the tiles' counts and offsets and
    one rank and one 16-byte list entry a point."""
    b, p = valid.shape
    dev = points.device
    out = torch.empty((b, num_y, num_x, num_slices + num_meta), dtype=torch.float32, device=dev)
    lib = _build.library()
    nbytes = lib.frcnn_voxelize_scratch_bytes(b, p, num_y, num_x)
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
    f32 = lambda v: float(_f32(v))  # noqa: E731
    recip = lambda v: float(_recip(v))  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.frcnn_voxelize_bev(
            points.data_ptr(), valid.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, p,
            f32(x_range[0]), f32(y_range[0]), f32(z_range[0]),
            float(_pitch_recip(*x_range, num_x)), float(_pitch_recip(*y_range, num_y)),
            f32(voxel_height), recip(voxel_height), num_x, num_y, num_slices, num_meta,
            max_pts_per_voxel, recip(max_pts_per_voxel), _build.stream_handle(dev),
        )
    _build.check(err, "frcnn_voxelize_bev")
    _build.LAUNCH_COUNTS["voxelize_bev"] += 1
    return out


def voxelize_bev(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    x_range: Tuple[float, float],
    y_range: Tuple[float, float],
    z_range: Tuple[float, float],
    voxel_len: float,
    voxel_height: float,
    num_x: int,
    num_y: int,
    num_slices: int,
    num_meta: int = 3,
    max_pts_per_voxel: int = 32,
) -> torch.Tensor:
    """Rasterize point clouds to BEV tensors.

    Args:
      points: (B, P, 5) float32 [x, y, z, intensity, elongation] in meters.
      valid: (B, P) bool padding mask.
      x_range / y_range / z_range: the grid's extent in meters.
      voxel_len: accepted for the JAX signature (the pitch is range / num).
      voxel_height: slice height in meters.
      num_x / num_y: cells along x / y; num_slices: height slices.
      num_meta: meta channels (density, intensity, elongation), 0-3.
      max_pts_per_voxel: the density's cap.

    Returns: (B, num_y, num_x, num_slices + num_meta) float32, y-major.
    """
    if points.dim() != 3 or points.shape[-1] != 5 or valid.shape != points.shape[:2]:
        raise ValueError(
            f"voxelize_bev: points (B, P, 5) and valid (B, P) required, got "
            f"{tuple(points.shape)}, {tuple(valid.shape)}")
    if points.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"voxelize_bev: float32 points and bool valid required, got {points.dtype}, {valid.dtype}")
    if valid.device != points.device:
        raise ValueError("voxelize_bev: points and valid must be on one device")
    if not 0 <= num_meta <= 3 or min(num_x, num_y, num_slices, max_pts_per_voxel) < 1:
        raise ValueError("voxelize_bev: need 0 <= num_meta <= 3 and positive grid sizes")
    kw = dict(x_range=x_range, y_range=y_range, z_range=z_range, voxel_height=voxel_height,
              num_x=num_x, num_y=num_y, num_slices=num_slices, num_meta=num_meta,
              max_pts_per_voxel=max_pts_per_voxel)
    if points.device.type == "cpu":
        return voxelize_bev_plain(points, valid, voxel_len=voxel_len, **kw)
    if points.device.type != "cuda":
        raise ValueError(f"voxelize_bev: unsupported device {points.device}")
    if not (points.is_contiguous() and valid.is_contiguous()):
        raise ValueError("voxelize_bev: contiguous points and valid required")
    if num_slices > _MAX_SLICES or points.shape[0] * points.shape[1] >= 2**31 - 1:
        raise ValueError(f"voxelize_bev: the CUDA kernel takes at most {_MAX_SLICES} slices (a "
                         f"tile's voxels in shared memory) and fewer than 2^31 - 1 points, got "
                         f"{num_slices}, {tuple(points.shape)}")
    return _voxelize_cuda(points, valid, **kw)


def bev_grid_size(cfg, frame_scale: float = 1.0) -> Tuple[int, int, int]:
    """(num_y, num_x, channels) of the raster for a config and frame scale
    (copied with its Python float arithmetic: at voxel_len 0.1 / scale 0.5,
    int(70 / 0.2) is 350)."""
    voxel_len = cfg.lidar.voxel_len / frame_scale
    num_x = int((cfg.lidar.x_range[1] - cfg.lidar.x_range[0]) / voxel_len)
    num_y = int((cfg.lidar.y_range[1] - cfg.lidar.y_range[0]) / voxel_len)
    return num_y, num_x, cfg.lidar.num_channel


def raster_kwargs(cfg, frame_scale: float) -> dict:
    """The voxelize_bev keywords of a config at a frame scale (the JAX
    loader's `_make_raster_fn`, data/loader.py:443-468)."""
    num_y, num_x, _ = bev_grid_size(cfg, frame_scale)
    lc = cfg.lidar
    return dict(
        x_range=lc.x_range, y_range=lc.y_range, z_range=lc.z_range,
        voxel_len=lc.voxel_len / frame_scale, voxel_height=lc.voxel_height,
        num_x=num_x, num_y=num_y, num_slices=lc.num_slices,
        num_meta=lc.num_meta_channel, max_pts_per_voxel=lc.max_pts_per_voxel,
    )
