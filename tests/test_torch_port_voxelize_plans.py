"""The BEV voxelizer kernel's design (csrc/voxelize.cu), written as a small
numpy mirror of its four passes and held against the JAX loader's raster
on the CPU.

* Pass 1 (`voxelize_bin_kernel`): each point's (ix, iy, iz) in the float32
  operation order of the JAX loader (folded reciprocals, the product
  rounded before the subtraction); a kept point adds one to its frame's
  tile count and takes the count before it as its rank.  Atomics hand out
  ranks in arrival order, so the mirror lets the points arrive in a
  shuffled order.
* Pass 2 (`voxelize_scan_kernel`): exclusive prefix sums of the B x tiles
  counts.
* Pass 3 (`voxelize_place_kernel`): each kept point's entry at its tile's
  offset plus its rank; every place of the list is written once.
* Pass 4 (`voxelize_tile_kernel`): one tile at a time, accumulators for
  its 8 x 32 columns only (the largest rel_h as int bits over a 0 start,
  the voxel counts, the column sums), its list walked in rounds of 1,024
  entries (256 threads x 4), then the density, the two tanh means, and
  every cell of the tile's (y, x, c) block written once.

Heights and density equal the JAX loader's raster bit for bit, the meta
channels (float sums in another order) are within 1e-5, and every cell of
the raster is written exactly once, on the six cases of
test_torch_port_lidar.py and on one where a frame's 6,000 points all fall
in one tile.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
sys.path.insert(0, str(TESTS.parent))
import chip_smoke  # noqa: E402
from test_torch_port_lidar import _cfgs, _jax_raster, _points  # noqa: E402

from faster_rcnn_pytorch_multimodal_tpu_torch.ops.voxelize import raster_kwargs  # noqa: E402

f32 = np.float32
TILE_H, TILE_W = 8, 32  # kTileH, kTileW
ROUND = 256 * 4  # kTileThreads x kTileUnroll: list entries a tile block takes a round


def classify(points, valid, grid):
    """`classify` on (B, P, 5) points: (ok, ix, iy, iz, rel_h), every step a
    float32 operation with the loader's folded reciprocals."""
    (x0, x1), (y0, y1), (z0, _) = grid["x_range"], grid["y_range"], grid["z_range"]
    nx, ny, ns, vh = grid["num_x"], grid["num_y"], grid["num_slices"], f32(grid["voxel_height"])
    rx = f32(1) / (f32(f32(x1) - f32(x0)) * (f32(1) / f32(nx)))
    ry = f32(1) / (f32(f32(y1) - f32(y0)) * (f32(1) / f32(ny)))
    zs = points[..., 2] - f32(z0)
    fx = np.floor((points[..., 0] - f32(x0)) * rx)
    fy = np.floor((points[..., 1] - f32(y0)) * ry)
    fz = np.floor(zs * (f32(1) / vh))
    with np.errstate(invalid="ignore"):
        ok = valid & (fx >= 0) & (fx < nx) & (fy >= 0) & (fy < ny) & (fz >= 0) & (fz < ns)
    ix, iy, iz = (np.where(ok, a, 0).astype(np.int64) for a in (fx, fy, fz))
    rel_h = zs - iz.astype(f32) * vh
    return ok, ix, iy, iz, rel_h.astype(f32)


def binned_raster(points, valid, grid, rng):
    """The four passes: (raster, times each cell was written, tile sizes)."""
    b = points.shape[0]
    nx, ny, ns = grid["num_x"], grid["num_y"], grid["num_slices"]
    nmeta, cap = grid.get("num_meta", 3), grid.get("max_pts_per_voxel", 32)
    tiles_x, tiles_y = -(-nx // TILE_W), -(-ny // TILE_H)
    tiles = tiles_x * tiles_y
    ok, ix, iy, iz, rel_h = classify(points, valid, grid)
    frame = np.broadcast_to(np.arange(b)[:, None], ok.shape)
    key = frame * tiles + (iy // TILE_H) * tiles_x + ix // TILE_W
    col = (iy % TILE_H) * TILE_W + ix % TILE_W

    # pass 1: counts, and ranks in a shuffled arrival order
    kept = np.flatnonzero(ok.ravel())
    arrival = kept[rng.permutation(kept.size)]
    count = np.zeros(b * tiles, np.int64)
    rank = np.full(ok.size, -1, np.int64)
    for t in arrival:
        k = key.flat[t]
        rank[t] = count[k]
        count[k] += 1
    # pass 2
    offset = np.concatenate([[0], np.cumsum(count)])
    # pass 3: (col, iz, rel_h, intensity, elongation) entries, each place once
    place = offset[key.ravel()[kept]] + rank[kept]
    assert np.array_equal(np.sort(place), np.arange(offset[-1]))
    entries = np.zeros((offset[-1], 5), f32)
    entries[place] = np.stack([col.ravel()[kept], iz.ravel()[kept], rel_h.ravel()[kept],
                               points[..., 3].ravel()[kept], points[..., 4].ravel()[kept]], -1)
    ecol, eiz = entries[:, 0].astype(np.int64), entries[:, 1].astype(np.int64)

    # pass 4, a tile at a time
    out = np.full((b, ny, nx, ns + nmeta), np.nan, f32)
    written = np.zeros(out.shape, np.int64)
    rcap = f32(1) / f32(cap)
    for k in range(b * tiles):
        vmax = np.zeros((TILE_H * TILE_W, ns), np.int32)  # 0: maximum(segmax, 0)
        vcnt = np.zeros((TILE_H * TILE_W, ns), np.int64)
        csum = np.zeros((TILE_H * TILE_W, 2), f32)
        for lo in range(offset[k], offset[k + 1], ROUND):
            rnd = slice(lo, min(lo + ROUND, offset[k + 1]))
            c, z = ecol[rnd], eiz[rnd]
            np.maximum.at(vmax, (c, z), entries[rnd, 2].view(np.int32))
            np.add.at(vcnt, (c, z), 1)
            np.add.at(csum, c, entries[rnd, 3:5])  # float32, one add at a time
        density = (np.minimum(vcnt, cap).astype(f32) * rcap).max(1)
        cnt = np.maximum(vcnt.sum(1), 1).astype(f32)
        means = np.tanh((csum / cnt[:, None]).astype(np.float64)).astype(f32)
        cells = np.concatenate([vmax.view(f32), density[:, None], means], 1)[:, :ns + nmeta]
        fb, tile = divmod(k, tiles)
        y0, x0 = (tile // tiles_x) * TILE_H, (tile % tiles_x) * TILE_W
        rows, cols = min(TILE_H, ny - y0), min(TILE_W, nx - x0)
        block = cells.reshape(TILE_H, TILE_W, -1)[:rows, :cols]
        out[fb, y0:y0 + rows, x0:x0 + cols] = block
        written[fb, y0:y0 + rows, x0:x0 + cols] += 1
    return out, written, count


def one_tile_points(rng, grid):
    """Frame 0's 6,000 points all in the tile at tile row 3, tile column 2
    (40 of them in one voxel), frame 1 all invalid (chip_smoke.skew_points)."""
    return chip_smoke.skew_points(rng, 2, 6000, grid)


@pytest.mark.parametrize("scale", [0.5, 0.25])
@pytest.mark.parametrize("case", ["random", "boundaries", "invalid_lanes", "out_of_range",
                                  "overfull_voxel", "all_invalid_frame", "one_tile"])
def test_binned_raster_matches_jax(case, scale):
    """The four passes against jit(vmap(voxelize_bev)) as the loader runs
    it: heights and density equal, meta within 1e-5, every cell written
    exactly once (zeros included) and no other."""
    _, cfg = _cfgs()
    grid = raster_kwargs(cfg, scale)
    rng = np.random.RandomState(len(case))
    pts, valid = (one_tile_points(rng, grid) if case == "one_tile"
                  else _points(case, rng, grid))
    want = np.asarray(_jax_raster(grid)(jnp.asarray(pts), jnp.asarray(valid)))
    got, written, count = binned_raster(pts, valid, grid, np.random.RandomState(7))
    s = grid["num_slices"]
    assert got.shape == want.shape
    assert (written == 1).all()
    np.testing.assert_array_equal(got[..., :s + 1], want[..., :s + 1])
    np.testing.assert_allclose(got[..., s + 1:], want[..., s + 1:], rtol=0, atol=1e-5)
    if case == "one_tile":
        assert count.max() > 4 * ROUND  # the tile takes several rounds of its list
        assert want[0, 24:32, 64:96, s].max() == 1.0  # the over-full voxel caps at 1.0
        assert not want[0, :24].any() and not want[0, :, :64].any()
    if case in ("all_invalid_frame", "one_tile"):
        assert not got[1].any()
