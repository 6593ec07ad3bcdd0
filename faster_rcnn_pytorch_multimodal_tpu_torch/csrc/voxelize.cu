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
// What bounds it on this card: bytes, the points read once and the raster
// written once (at 8 x 32768 points -> 8 x 400 x 350 x 15, 5.5 MB against
// 67.2 MB).  The points touch a few hundred kB of the raster, so the raster
// is written once, zeros included, and never zeroed, read back or held in
// a full-size scratch.  The frame's raster is cut into tiles of kTileH x
// kTileW columns, and the points are counting-sorted by tile:
//   1. voxelize_bin_kernel, one thread per point: a point that is valid and
//      inside the grid adds one to its frame's tile count (one atomic for
//      the lanes of a warp that share a tile) and keeps its rank there.
//   2. voxelize_scan_kernel, one block: exclusive prefix sums of the
//      B x tiles counts, each tile's first place in the list.
//   3. voxelize_place_kernel, one thread per kept point: its voxel in the
//      tile, rel_h, intensity and elongation (16 bytes) into its place.
//   4. voxelize_tile_kernel, one block per tile: per voxel the largest
//      rel_h (int bits) and the count, per column the two sums, all in
//      shared memory, summed with shared-memory atomics over the tile's
//      list a block-stride at a time (however many points the tile holds);
//      then the density and the two tanh means a column, and every cell of
//      the tile's (y, x, c) block written once, a warp a tile row (a row
//      of the tile is contiguous in the raster).
// Only the B x tiles counts are zeroed (18 kB at 400 x 350); the list and
// the ranks are B x P entries of scratch from the wrapper (torch.empty).
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
//   - Passes 1 and 3 classify a point by one function (`classify`), so a
//     point counted in a tile is placed in it.
//   - The largest height is an atomicMax on the int bits of rel_h into a
//     0-initialised word: non-negative floats order like their bits, and a
//     slightly negative rel_h (int bits < 0) loses to the 0, which is
//     exactly the JAX code's maximum(segmax, 0).  Heights and density are
//     the same bit for bit from run to run.
//   - The meta channels are float sums in arrival order within a tile:
//     they differ from JAX's sequential sums in the last bits, and from
//     run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;  // a tile: kTileH rows x kTileW columns of one frame's raster
constexpr int kTileW = 32;
constexpr int kTileCols = kTileH * kTileW;
constexpr int kPointThreads = 256;
constexpr int kTileThreads = 256;
constexpr int kTileUnroll = 4;  // list entries a tile thread loads before it adds them
constexpr int kScanThreads = 1024;  // one warp's lane per warp in the scan's second level
constexpr int kScanItems = 8;       // counts a scan thread sums per round
constexpr size_t kMaxSmemBytes = 232448;  // a block's shared memory on sm_90

struct Grid {
  float x0, y0, z0;     // range floors (float32)
  float rx, ry;         // 1.0f / float32 cell pitch along x and y
  float vh, rvh;        // slice height and 1.0f / it
  int nx, ny, ns;       // cells along x, y; height slices
  int nmeta, cap;       // meta channels; density cap (max points per voxel)
  float rcap;           // 1.0f / cap
  int tiles_x, tiles;   // tiles along a raster row; tiles of one frame
  unsigned ch_magic;    // ceil(2^32 / (ns + nmeta)): e / ch == umulhi(e, ch_magic) in a tile row
  int vs;               // a tile column's stride in the voxel words: ns made odd, so that
                        // threads walking one column each meet no shared-memory bank conflict
};

// One kept point in its tile's list: (column in the tile << 16) | slice,
// and the values the tile sums.
struct __align__(16) Entry {
  int vox;
  float rel_h, intensity, elongation;
};

// A point's tile, its column in the tile, its slice and rel_h; false if it
// lies outside the grid (or has a NaN coordinate).
__device__ __forceinline__ bool classify(const float* pt, const Grid& g, int* tile, int* col,
                                         int* iz, float* rel_h) {
  const float zs = __fsub_rn(pt[2], g.z0);
  const float fx = floorf(__fmul_rn(__fsub_rn(pt[0], g.x0), g.rx));
  const float fy = floorf(__fmul_rn(__fsub_rn(pt[1], g.y0), g.ry));
  const float fz = floorf(__fmul_rn(zs, g.rvh));
  if (!(fx >= 0.f && fx < static_cast<float>(g.nx) && fy >= 0.f &&
        fy < static_cast<float>(g.ny) && fz >= 0.f && fz < static_cast<float>(g.ns))) {
    return false;
  }
  const int ix = static_cast<int>(fx), iy = static_cast<int>(fy);
  *iz = static_cast<int>(fz);
  *tile = (iy / kTileH) * g.tiles_x + ix / kTileW;
  *col = (iy % kTileH) * kTileW + ix % kTileW;
  *rel_h = __fsub_rn(zs, __fmul_rn(static_cast<float>(*iz), g.vh));
  return true;
}

// Pass 1.  rank[t]: the point's place among its tile's points, -1 if it
// goes nowhere.  The grid covers the points exactly, so every lane of a
// warp takes part in the match.
__global__ void __launch_bounds__(kPointThreads)
    voxelize_bin_kernel(const float* __restrict__ points, const uint8_t* __restrict__ valid,
                        int n_points, int p, Grid g, int* __restrict__ tile_count,
                        int* __restrict__ rank) {
  const int t = blockIdx.x * kPointThreads + threadIdx.x;
  int key = -1;  // b * tiles + tile
  if (t < n_points && valid[t]) {
    int tile, col, iz;
    float rel_h;
    if (classify(points + (size_t)t * 5, g, &tile, &col, &iz, &rel_h)) key = (t / p) * g.tiles + tile;
  }
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (key >= 0 && lane == leader) base = atomicAdd(tile_count + key, __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (t < n_points) rank[t] = key >= 0 ? base + __popc(peers & ((1u << lane) - 1u)) : -1;
}

// Pass 2.  offset[i] = count[0] + ... + count[i - 1] for i <= n, in rounds
// of kScanThreads x kScanItems counts staged in shared memory.
__global__ void __launch_bounds__(kScanThreads)
    voxelize_scan_kernel(const int* __restrict__ count, int n, int* __restrict__ offset) {
  __shared__ int items[kScanThreads * kScanItems];
  __shared__ int warp_sum[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += kScanThreads * kScanItems) {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = base + k * kScanThreads + t;
      items[k * kScanThreads + t] = i < n ? count[i] : 0;
    }
    __syncthreads();
    int local[kScanItems], sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      local[k] = items[t * kScanItems + k];
      sum += local[k];
    }
    int incl = sum;  // inclusive scan of the threads' sums within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += v;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    int before = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      items[t * kScanItems + k] = before;
      before += local[k];
    }
    carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = base + k * kScanThreads + t;
      if (i < n) offset[i] = items[k * kScanThreads + t];
    }
    __syncthreads();  // items is refilled next round
  }
  if (t == 0) offset[n] = carry;
}

// Pass 3.  Each kept point's entry into its tile's segment of the list.
__global__ void __launch_bounds__(kPointThreads)
    voxelize_place_kernel(const float* __restrict__ points, int n_points, int p, Grid g,
                          const int* __restrict__ rank, const int* __restrict__ offset,
                          Entry* __restrict__ list) {
  const int t = blockIdx.x * kPointThreads + threadIdx.x;
  if (t >= n_points) return;
  const int r = rank[t];
  if (r < 0) return;
  const float* pt = points + (size_t)t * 5;
  int tile, col, iz;
  float rel_h;
  classify(pt, g, &tile, &col, &iz, &rel_h);  // true: pass 1 kept it
  list[offset[(t / p) * g.tiles + tile] + r] = Entry{(col << 16) | iz, rel_h, pt[3], pt[4]};
}

// Element e of row r of a tile's (y, x, c) block: (x, c) = (e / ch, e % ch),
// from the tile's voxel heights and its columns' meta channels.
__device__ __forceinline__ float tile_value(const int* vmax, const float* meta, const Grid& g,
                                            int r, int e) {
  const int x = static_cast<int>(__umulhi(static_cast<unsigned>(e), g.ch_magic));
  const int c = e - x * (g.ns + g.nmeta);
  const int col = r * kTileW + x;
  return c < g.ns ? __int_as_float(vmax[col * g.vs + c]) : meta[3 * col + c - g.ns];
}

// Pass 4's shared memory: per voxel of the tile the largest rel_h's int bits
// and the count, per column the two sums and the num_meta channels.
size_t tile_smem_bytes(int vs) { return (size_t)(2 * vs + 5) * kTileCols * sizeof(int); }

// Pass 4.  Block `key` = b * tiles + tile sums its list and writes its
// kTileH x kTileW x (S + num_meta) cells of the raster.
__global__ void __launch_bounds__(kTileThreads)
    voxelize_tile_kernel(const Entry* __restrict__ list, const int* __restrict__ offset, Grid g,
                         float* __restrict__ out) {
  extern __shared__ int4 tile_smem[];
  const int ns = g.ns, vs = g.vs;
  int* vmax = reinterpret_cast<int*>(tile_smem);            // [kTileCols][vs]
  int* vcnt = vmax + kTileCols * vs;                        // [kTileCols][vs]
  float* csum = reinterpret_cast<float*>(vcnt + kTileCols * vs);  // [kTileCols][2]
  float* meta = csum + 2 * kTileCols;                       // [kTileCols][3]
  const int t = threadIdx.x;
  for (int i = t; i < (2 * vs + 2) * kTileCols / 4; i += kTileThreads) {
    tile_smem[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  const int key = blockIdx.x;
  const int begin = offset[key], end = offset[key + 1];
  for (int base = begin; base < end; base += kTileThreads * kTileUnroll) {
    Entry e[kTileUnroll];
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      const int i = base + u * kTileThreads + t;
      if (i < end) e[u] = list[i];
    }
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      if (base + u * kTileThreads + t >= end) break;
      const int col = e[u].vox >> 16;
      const int v = col * vs + (e[u].vox & 0xffff);
      atomicMax(vmax + v, __float_as_int(e[u].rel_h));
      if (g.nmeta >= 1) atomicAdd(vcnt + v, 1);
      if (g.nmeta >= 2) atomicAdd(csum + 2 * col, e[u].intensity);
      if (g.nmeta >= 3) atomicAdd(csum + 2 * col + 1, e[u].elongation);
    }
  }
  __syncthreads();
  if (g.nmeta >= 1) {
    for (int col = t; col < kTileCols; col += kTileThreads) {
      float density = 0.f;
      int count = 0;  // the column's points: its voxels' counts
      for (int s = 0; s < ns; ++s) {
        const int c = vcnt[col * vs + s];
        density = fmaxf(density, __fmul_rn(static_cast<float>(min(c, g.cap)), g.rcap));
        count += c;
      }
      meta[3 * col] = density;
      const float cnt = static_cast<float>(max(count, 1));
      if (g.nmeta >= 2) meta[3 * col + 1] = tanhf(__fdiv_rn(csum[2 * col], cnt));
      if (g.nmeta >= 3) meta[3 * col + 2] = tanhf(__fdiv_rn(csum[2 * col + 1], cnt));
    }
    __syncthreads();
  }

  const int b = key / g.tiles, tile = key - b * g.tiles;
  const int y0 = (tile / g.tiles_x) * kTileH, x0 = (tile % g.tiles_x) * kTileW;
  const int rows = min(kTileH, g.ny - y0), cols = min(kTileW, g.nx - x0);
  const int ch = ns + g.nmeta;
  const int row_elems = cols * ch;  // one tile row: contiguous in (y, x, c)
  const int lane = t & 31;
  // a warp a row, its lanes on consecutive elements: coalesced stores, and
  // consecutive voxel words in shared memory (16-byte stores, whose lanes
  // read words 4 apart, measured slower)
  for (int r = t >> 5; r < rows; r += kTileThreads / 32) {
    float* row = out + (((size_t)b * g.ny + y0 + r) * g.nx + x0) * ch;
    for (int e = lane; e < row_elems; e += 32) row[e] = tile_value(vmax, meta, g, r, e);
  }
}

// The scratch, carved from one 16-byte aligned buffer: the B x tiles counts
// and B x tiles + 1 offsets, then the B x P ranks and list entries.
struct Scratch {
  int* count;
  int* offset;
  int* rank;
  Entry* list;
};

size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

size_t scratch_bytes(long long n_tiles, long long n_points) {
  return align16(n_tiles * sizeof(int)) + align16((n_tiles + 1) * sizeof(int)) +
         align16(n_points * sizeof(int)) + n_points * sizeof(Entry);
}

Scratch carve(void* base, long long n_tiles, long long n_points) {
  char* p = static_cast<char*>(base);
  Scratch s;
  s.count = reinterpret_cast<int*>(p);
  p += align16(n_tiles * sizeof(int));
  s.offset = reinterpret_cast<int*>(p);
  p += align16((n_tiles + 1) * sizeof(int));
  s.rank = reinterpret_cast<int*>(p);
  p += align16(n_points * sizeof(int));
  s.list = reinterpret_cast<Entry*>(p);
  return s;
}

long long frame_tiles(int num_y, int num_x) {
  return (long long)((num_y + kTileH - 1) / kTileH) * ((num_x + kTileW - 1) / kTileW);
}

}  // namespace

// The bytes of scratch frcnn_voxelize_bev takes for B frames of P points on
// a num_y x num_x raster.
extern "C" long long frcnn_voxelize_scratch_bytes(int b, int p, int num_y, int num_x) {
  return static_cast<long long>(scratch_bytes((long long)b * frame_tiles(num_y, num_x),
                                              (long long)b * p));
}

// points: (B, P, 5) float32; valid: (B, P) bool (one byte each).
// recip_*: 1.0f / the float32 constant, rounded in float32 (see above).
// out: (B, Y, X, S + num_meta) float32, every element written (no zeroing).
// scratch: frcnn_voxelize_scratch_bytes(B, P, Y, X) bytes of device memory,
// 16-byte aligned.  num_slices at most 111 (pass 4's shared memory), B x P
// below 2^31.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int frcnn_voxelize_bev(const void* points, const void* valid, void* out, void* scratch,
                                  int b, int p, float x0, float y0, float z0, float recip_x,
                                  float recip_y, float voxel_height, float recip_vh, int num_x,
                                  int num_y, int num_slices, int num_meta, int max_pts_per_voxel,
                                  float recip_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_points = (long long)b * p;
  const long long n_tiles = (long long)b * frame_tiles(num_y, num_x);
  const size_t smem = tile_smem_bytes(num_slices | 1);
  if (n_points >= 0x7fffffffLL || n_tiles >= 0x7fffffffLL || smem > kMaxSmemBytes ||
      num_slices < 1 || num_meta < 0 || num_meta > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  const int tiles_x = (num_x + kTileW - 1) / kTileW;
  const unsigned ch = static_cast<unsigned>(num_slices + num_meta);
  const Grid g{x0, y0, z0, recip_x, recip_y, voxel_height, recip_vh, num_x, num_y, num_slices,
               num_meta, max_pts_per_voxel, recip_cap, tiles_x,
               static_cast<int>(frame_tiles(num_y, num_x)),
               static_cast<unsigned>((0x100000000ULL + ch - 1) / ch), num_slices | 1};
  const Scratch sc = carve(scratch, n_tiles, n_points);
  cudaError_t err = cudaMemsetAsync(sc.count, 0, n_tiles * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int point_blocks = static_cast<int>((n_points + kPointThreads - 1) / kPointThreads);
  const float* pts = static_cast<const float*>(points);
  if (n_points > 0) {
    voxelize_bin_kernel<<<point_blocks, kPointThreads, 0, s>>>(
        pts, static_cast<const uint8_t*>(valid), static_cast<int>(n_points), p, g, sc.count,
        sc.rank);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  voxelize_scan_kernel<<<1, kScanThreads, 0, s>>>(sc.count, static_cast<int>(n_tiles), sc.offset);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_points > 0) {
    voxelize_place_kernel<<<point_blocks, kPointThreads, 0, s>>>(
        pts, static_cast<int>(n_points), p, g, sc.rank, sc.offset, sc.list);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(voxelize_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  voxelize_tile_kernel<<<static_cast<unsigned>(n_tiles), kTileThreads, smem, s>>>(
      sc.list, sc.offset, g, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
