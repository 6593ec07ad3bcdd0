// LiDAR points -> BEV raster for Hopper (sm_90a), plain C ABI (ctypes).
//
// Replaces: faster_rcnn_pytorch_multimodal_tpu/ops/voxelize.py:39
// `voxelize_bev` (segment max / segment sums into a trash-padded segment
// space, then a transpose to y-major).  Output per frame is
// (num_y, num_x, num_slices + num_meta) float32 in (y, x, c) order, the NHWC
// layout the backbone reads:
//   c <  S      largest height above the slice floor in voxel (x, y, c), 0 if empty
//   c == S      max over slices of min(count, cap) / cap            (num_meta >= 1)
//   c == S + 1  tanh(column intensity sum / max(column count, 1))   (num_meta >= 2)
//   c == S + 2  tanh(column elongation sum / max(column count, 1))  (num_meta >= 3)
//
// Two passes, both simple:
//   1. voxelize_scatter_kernel, one thread per point over B x P.  A point
//      that is valid and inside the grid does
//        - atomicMax on the int bits of rel_h into the output's slice
//          channel, which the wrapper zeroed: non-negative floats order like
//          their bits, and a slightly negative rel_h (int bits < 0) loses to
//          the 0 init, which is exactly the JAX code's maximum(segmax, 0);
//        - atomicAdd of 1 into its voxel's and its column's int count;
//        - float atomicAdd of intensity and elongation into its column's sums.
//   2. voxelize_finalize_kernel, one thread per (b, y, x): the density and
//      the two tanh channels, written straight into (y, x, c).
// Scratch comes from the wrapper (torch.zeros): int32 voxel counts
// (B, Y, X, S), int32 column counts (B, Y, X) and float32 column sums
// (B, Y, X, 2).  At the Waymo-size raster, 8 x 800 x 700 x 12 voxels, the
// voxel counts alone are 215 MB.
//
// Rounding hazards, and what the code does about them:
//   - The JAX package rasterizes in its loader, under
//     jit(vmap(partial(voxelize_bev, **grid))): the grid constants fold, and
//     XLA's algebraic simplifier turns each division by a constant -- the
//     pitch (x1 - x0) / num_x, (x - x0) / pitch, zs / vh, min(cnt, cap) / cap
//     -- into a multiply by its float32 reciprocal 1.0f / c.  A true division
//     puts some of the points that lie on a cell boundary in the next cell.
//     The wrapper passes the reciprocals, rounded as XLA rounds them (the
//     y pitch at 80 m / 400 cells is 0.19999999, not 0.2f), and the kernel
//     multiplies.
//   - nvcc contracts a*b+c into an FMA by default.  rel_h = zs - iz * vh must
//     round the product first, as the JAX code does, so it is
//     __fsub_rn(zs, __fmul_rn(iz, vh)); every other step uses an _rn
//     intrinsic too, so no step can be contracted.
//   - The meta channels are float sums in atomic (arrival) order: they
//     differ from JAX's sequential sums in the last bits, and from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Grid {
  float x0, y0, z0;     // range floors (float32)
  float rx, ry;         // 1.0f / float32 cell pitch along x and y
  float vh, rvh;        // slice height and 1.0f / it
  int nx, ny, ns;       // cells along x, y; height slices
  int nmeta, cap;       // meta channels; density cap (max points per voxel)
  float rcap;           // 1.0f / cap
};

__global__ void voxelize_scatter_kernel(const float* __restrict__ points,
                                        const uint8_t* __restrict__ valid,
                                        long long n_points, int p, Grid g,
                                        float* __restrict__ out,
                                        int* __restrict__ vox_cnt,
                                        int* __restrict__ col_cnt,
                                        float* __restrict__ col_sum) {
  const int channels = g.ns + g.nmeta;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < n_points;
       t += (long long)gridDim.x * blockDim.x) {
    if (!valid[t]) continue;
    const float* pt = points + t * 5;
    const float zs = __fsub_rn(pt[2], g.z0);
    const int ix = (int)floorf(__fmul_rn(__fsub_rn(pt[0], g.x0), g.rx));
    const int iy = (int)floorf(__fmul_rn(__fsub_rn(pt[1], g.y0), g.ry));
    const int iz = (int)floorf(__fmul_rn(zs, g.rvh));
    if (ix < 0 || ix >= g.nx || iy < 0 || iy >= g.ny || iz < 0 || iz >= g.ns) continue;
    const long long b = t / p;
    const long long col = (b * g.ny + iy) * g.nx + ix;
    const float rel_h = __fsub_rn(zs, __fmul_rn((float)iz, g.vh));
    atomicMax(reinterpret_cast<int*>(out + col * channels + iz), __float_as_int(rel_h));
    if (g.nmeta >= 1) atomicAdd(vox_cnt + col * g.ns + iz, 1);
    if (g.nmeta >= 2) {
      atomicAdd(col_cnt + col, 1);
      atomicAdd(col_sum + col * 2, pt[3]);
      if (g.nmeta >= 3) atomicAdd(col_sum + col * 2 + 1, pt[4]);
    }
  }
}

__global__ void voxelize_finalize_kernel(long long n_cols, Grid g,
                                         float* __restrict__ out,
                                         const int* __restrict__ vox_cnt,
                                         const int* __restrict__ col_cnt,
                                         const float* __restrict__ col_sum) {
  const int channels = g.ns + g.nmeta;
  for (long long col = blockIdx.x * (long long)blockDim.x + threadIdx.x; col < n_cols;
       col += (long long)gridDim.x * blockDim.x) {
    float* o = out + col * channels + g.ns;
    const int* vc = vox_cnt + col * g.ns;
    float density = 0.f;
    for (int s = 0; s < g.ns; ++s) {
      density = fmaxf(density, __fmul_rn((float)min(vc[s], g.cap), g.rcap));
    }
    o[0] = density;
    if (g.nmeta >= 2) {
      const float cnt = (float)max(col_cnt[col], 1);
      o[1] = tanhf(__fdiv_rn(col_sum[col * 2], cnt));
      if (g.nmeta >= 3) o[2] = tanhf(__fdiv_rn(col_sum[col * 2 + 1], cnt));
    }
  }
}

int grid_blocks(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 65535LL * 32 ? (blocks > 0 ? blocks : 1) : 65535LL * 32);
}

}  // namespace

// points: (B, P, 5) float32; valid: (B, P) bool (one byte each).
// recip_*: 1.0f / the float32 constant, rounded in float32 (see above).
// out: (B, Y, X, S + num_meta) float32, zeroed.  vox_cnt: (B, Y, X, S) int32,
// col_cnt: (B, Y, X) int32, col_sum: (B, Y, X, 2) float32, all zeroed.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int frcnn_voxelize_bev(const void* points, const void* valid, void* out,
                                  void* vox_cnt, void* col_cnt, void* col_sum,
                                  int b, int p, float x0, float y0, float z0,
                                  float recip_x, float recip_y, float voxel_height,
                                  float recip_vh, int num_x, int num_y, int num_slices,
                                  int num_meta, int max_pts_per_voxel, float recip_cap,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{x0, y0, z0, recip_x, recip_y, voxel_height, recip_vh, num_x, num_y,
               num_slices, num_meta, max_pts_per_voxel, recip_cap};
  const long long n_points = (long long)b * p;
  if (n_points > 0) {
    voxelize_scatter_kernel<<<grid_blocks(n_points), kThreads, 0, s>>>(
        static_cast<const float*>(points), static_cast<const uint8_t*>(valid), n_points, p,
        g, static_cast<float*>(out), static_cast<int*>(vox_cnt), static_cast<int*>(col_cnt),
        static_cast<float*>(col_sum));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_meta >= 1) {
    const long long n_cols = (long long)b * num_y * num_x;
    voxelize_finalize_kernel<<<grid_blocks(n_cols), kThreads, 0, s>>>(
        n_cols, g, static_cast<float*>(out), static_cast<const int*>(vox_cnt),
        static_cast<const int*>(col_cnt), static_cast<const float*>(col_sum));
  }
  return static_cast<int>(cudaGetLastError());
}
