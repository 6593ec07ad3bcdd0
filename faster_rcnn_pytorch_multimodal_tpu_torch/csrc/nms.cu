// Batched greedy hard NMS for Hopper (sm_90a), plain C ABI (loaded with ctypes):
// on axis-aligned boxes (K1) and on rotated BEV rectangles (K4).
//
// Replaces: faster_rcnn_pytorch_multimodal_tpu/ops/nms.py `nms`,
// `_chunked_greedy_keep` and `_iou_no_plus1` (the JAX package's fixed-shape
// chunked-Jacobi NMS), and for `rotated=True` also ops/rotated_iou.py
// `rotated_iou_matrix` (+ `_pair_intersection_area`, `_points_in_quad`,
// `box5_corners`), reached through ops/nms.py `_pairwise_iou`.  This kernel
// computes exact greedy NMS with torchvision semantics: suppress when
// IoU > threshold, IoU = union > 0 ? inter / union : 0 (axis-aligned, areas
// without +1), or for rotated boxes IoU = inter / union, 0 when the union is
// <= 1e-9 or the intersection has fewer than 3 vertices.
//
// Input is G problems of N boxes already sorted by descending score (the
// wrapper sorts with a stable torch.sort, as the JAX code's stable argsort
// does), a per-lane validity byte and the sort order.  Output is the first
// M = min(N, max_out) kept lanes in score order, mapped back through the sort
// order, padded with index 0 and valid 0.
//
// What bounds it on the card: not bytes or FLOPs (the proposal problem is
// 8 x 2048 boxes, 4 MB of mask), but launch count and latency.  The keep scan
// is inherently sequential over up to N rows.  The design keeps that scan
// cheap:
//   1. nms_mask_kernel (rotated: nms_rotated_mask_kernel): one 64-thread
//      block per (problem, row block, column block >= row block).  The block
//      stages its 64 column boxes in shared memory and each thread writes one
//      64-bit word for its row: bit j set when column j > row i and
//      iou(i, j) > threshold.  Fully parallel, N^2/2 IoUs per problem.
//   2. nms_scan_kernel: one warp per problem.  The `removed` bit set (N/64
//      words) lives in shared memory and starts as the complement of the
//      valid lanes, so the sequential loop over rows touches only shared
//      memory, except for a kept row, whose mask words are ORed in.  The
//      loop stops as soon as M lanes are kept.  Kept sorted lanes are
//      collected in shared memory and mapped through the sort order in one
//      parallel pass at the end.
//
// Axis-aligned arithmetic: every IoU step uses the round-to-nearest
// intrinsics so that nvcc cannot contract a multiply-add into an FMA.  The
// result then matches the plain PyTorch version op for op, and the keep sets
// are identical.
//
// Rotated arithmetic (rot_iou): the JAX package's formulation is a
// fixed 24-slot candidate buffer with an atan2 sort, shaped for vector
// units.  Here each thread computes the area of the intersection of its two
// convex quads by Sutherland-Hodgman: quad A clipped by B's four edges, at
// most 8 vertices (capacity 16 for rounding's sake) in a small local array,
// then a shoelace.  No atan2 and no sort; the area equals the candidate
// form's up to float32 rounding.  Every coordinate is taken relative to A's
// center (translation does not change the area): in voxel units the centers
// reach 400, and cross products of absolute coordinates would cancel.  A
// box is staged as its center, two half-axis vectors (from the precise
// sincosf of its heading) and its area l * w, the twin's area.  The IoU is
// not bitwise the twin's, so the keeps equal the twin's except where an IoU
// lies within float32 rounding of the threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBoxesPerBlock = 64;
constexpr int kScanThreads = 32;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float iou_no_plus1(float4 a, float area_a, float4 b,
                                              float area_b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// A rotated BEV rectangle [xc, yc, l, w, ry]: center, half-length axis
// u = (l / 2)(cos ry, sin ry), half-width axis v = (w / 2)(-sin ry, cos ry),
// area l * w.  Its corners, counter-clockwise as the twin's box5_corners:
// c + u - v, c + u + v, c - u + v, c - u - v.
struct RotBox {
  float cx, cy, ux, uy, vx, vy, area;
};

constexpr int kMaxVerts = 16;  // a convex quad clipped by 4 half-planes has <= 8

__device__ __forceinline__ RotBox load_rot_box(const float* b) {
  float s, c;
  sincosf(b[4], &s, &c);
  const float hl = 0.5f * b[2], hw = 0.5f * b[3];
  return {b[0], b[1], hl * c, hl * s, -hw * s, hw * c, b[2] * b[3]};
}

// The four corners of r relative to the point (ox, oy), counter-clockwise.
__device__ __forceinline__ void rot_corners(const RotBox& r, float ox, float oy, float* x,
                                            float* y) {
  const float dx = r.cx - ox, dy = r.cy - oy;
  x[0] = dx + r.ux - r.vx;  y[0] = dy + r.uy - r.vy;
  x[1] = dx + r.ux + r.vx;  y[1] = dy + r.uy + r.vy;
  x[2] = dx - r.ux + r.vx;  y[2] = dy - r.uy + r.vy;
  x[3] = dx - r.ux - r.vx;  y[3] = dy - r.uy - r.vy;
}

// Area of the intersection of two rotated rectangles: a's quad clipped by
// b's four edges (Sutherland-Hodgman), then the shoelace; everything
// relative to a's center.  A point p is inside an edge e from q when
// cross(e, p - q) >= 0; a crossing point is interpolated from the two
// signed distances, whose difference is then nonzero.
__device__ float rot_intersection(const RotBox& a, const RotBox& b) {
  float px[kMaxVerts], py[kMaxVerts], qx[kMaxVerts], qy[kMaxVerts];
  float bx[4], by[4];
  rot_corners(a, a.cx, a.cy, px, py);
  rot_corners(b, a.cx, a.cy, bx, by);
  int n = 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ox = bx[k], oy = by[k];
    const float ex = bx[(k + 1) & 3] - ox, ey = by[(k + 1) & 3] - oy;
    int m = 0;
    float sx = px[n - 1], sy = py[n - 1];
    float ss = ex * (sy - oy) - ey * (sx - ox);
    for (int i = 0; i < n; ++i) {
      const float cx = px[i], cy = py[i];
      const float cs = ex * (cy - oy) - ey * (cx - ox);
      if ((cs >= 0.f) != (ss >= 0.f) && m < kMaxVerts) {
        const float t = ss / (ss - cs);
        qx[m] = sx + t * (cx - sx);
        qy[m] = sy + t * (cy - sy);
        ++m;
      }
      if (cs >= 0.f && m < kMaxVerts) {
        qx[m] = cx;
        qy[m] = cy;
        ++m;
      }
      sx = cx; sy = cy; ss = cs;
    }
    n = m;
    if (n == 0) return 0.f;
    for (int i = 0; i < n; ++i) {
      px[i] = qx[i];
      py[i] = qy[i];
    }
  }
  if (n < 3) return 0.f;
  float twice = 0.f;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1 == n) ? 0 : i + 1;
    twice += px[i] * py[j] - px[j] * py[i];
  }
  return 0.5f * fabsf(twice);
}

__device__ __forceinline__ float rot_iou(const RotBox& a, const RotBox& b) {
  const float inter = rot_intersection(a, b);
  const float uni = a.area + b.area - inter;
  return uni > 1e-9f ? inter / uni : 0.f;
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n,
                                int col_blocks, float threshold,
                                unsigned long long* __restrict__ mask) {
  const int g = blockIdx.z;
  const int row_blk = blockIdx.y;
  const int col_blk = blockIdx.x;
  if (row_blk > col_blk) return;  // the scan never reads words left of the diagonal

  const int row_size = min(n - row_blk * kBoxesPerBlock, kBoxesPerBlock);
  const int col_size = min(n - col_blk * kBoxesPerBlock, kBoxesPerBlock);
  const float4* gb = boxes + (size_t)g * n;

  __shared__ float4 cols[kBoxesPerBlock];
  __shared__ float col_area[kBoxesPerBlock];
  if (threadIdx.x < col_size) {
    const float4 c = gb[col_blk * kBoxesPerBlock + threadIdx.x];
    cols[threadIdx.x] = c;
    col_area[threadIdx.x] = box_area(c);
  }
  __syncthreads();

  if (threadIdx.x < row_size) {
    const int i = row_blk * kBoxesPerBlock + threadIdx.x;
    const float4 a = gb[i];
    const float area_a = box_area(a);
    unsigned long long bits = 0ULL;
    const int start = (row_blk == col_blk) ? threadIdx.x + 1 : 0;
    for (int j = start; j < col_size; ++j) {
      if (iou_no_plus1(a, area_a, cols[j], col_area[j]) > threshold) {
        bits |= 1ULL << j;
      }
    }
    mask[((size_t)g * n + i) * col_blocks + col_blk] = bits;
  }
}

// nms_mask_kernel for rotated boxes, (G, N, 5) [xc, yc, l, w, ry] float32.
__global__ void nms_rotated_mask_kernel(const float* __restrict__ boxes, int n, int col_blocks,
                                        float threshold, unsigned long long* __restrict__ mask) {
  const int g = blockIdx.z;
  const int row_blk = blockIdx.y;
  const int col_blk = blockIdx.x;
  if (row_blk > col_blk) return;

  const int row_size = min(n - row_blk * kBoxesPerBlock, kBoxesPerBlock);
  const int col_size = min(n - col_blk * kBoxesPerBlock, kBoxesPerBlock);
  const float* gb = boxes + (size_t)g * n * 5;

  __shared__ RotBox cols[kBoxesPerBlock];
  if (threadIdx.x < col_size) {
    cols[threadIdx.x] = load_rot_box(gb + (size_t)(col_blk * kBoxesPerBlock + threadIdx.x) * 5);
  }
  __syncthreads();

  if (threadIdx.x < row_size) {
    const int i = row_blk * kBoxesPerBlock + threadIdx.x;
    const RotBox a = load_rot_box(gb + (size_t)i * 5);
    unsigned long long bits = 0ULL;
    const int start = (row_blk == col_blk) ? threadIdx.x + 1 : 0;
    for (int j = start; j < col_size; ++j) {
      if (rot_iou(a, cols[j]) > threshold) bits |= 1ULL << j;
    }
    mask[((size_t)g * n + i) * col_blocks + col_blk] = bits;
  }
}

// The (G, N, M) rotated IoU matrix of (G, N, 5) rows vs (G, M, 5) columns,
// one 64-thread block per (problem, row block, column block), one row a
// thread, the block's columns staged in shared memory.
__global__ void rotated_iou_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                   int n, int m, float* __restrict__ out) {
  const int g = blockIdx.z;
  const int row = blockIdx.y * kBoxesPerBlock + threadIdx.x;
  const int col0 = blockIdx.x * kBoxesPerBlock;
  const int col_size = min(m - col0, kBoxesPerBlock);

  __shared__ RotBox cols[kBoxesPerBlock];
  if (threadIdx.x < col_size) {
    cols[threadIdx.x] = load_rot_box(b + ((size_t)g * m + col0 + threadIdx.x) * 5);
  }
  __syncthreads();
  if (row >= n) return;
  const RotBox r = load_rot_box(a + ((size_t)g * n + row) * 5);
  float* o = out + ((size_t)g * n + row) * m + col0;
  for (int j = 0; j < col_size; ++j) o[j] = rot_iou(r, cols[j]);
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid,
                                const int* __restrict__ order, int n,
                                int col_blocks, int m, int* __restrict__ out_idx,
                                uint8_t* __restrict__ out_valid) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;                       // col_blocks words
  int* kept = reinterpret_cast<int*>(smem + col_blocks);    // m sorted lanes

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* gm = mask + (size_t)g * n * col_blocks;
  const uint8_t* gv = valid + (size_t)g * n;

  // removed starts as "not valid": lanes past n count as removed too
  for (int w = 0; w < col_blocks; ++w) {
    const int i0 = w * kBoxesPerBlock + lane;
    const int i1 = i0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, i0 < n && gv[i0] != 0);
    const unsigned hi = __ballot_sync(0xffffffffu, i1 < n && gv[i1] != 0);
    if (lane == 0) {
      removed[w] = ~(((unsigned long long)hi << 32) | (unsigned long long)lo);
    }
  }
  __syncwarp();

  int count = 0;
  for (int i = 0; i < n && count < m; ++i) {
    const int blk = i / kBoxesPerBlock;
    if ((removed[blk] >> (i % kBoxesPerBlock)) & 1ULL) continue;  // uniform
    if (lane == 0) kept[count] = i;
    ++count;
    const unsigned long long* row = gm + (size_t)i * col_blocks;
    for (int w = blk + lane; w < col_blocks; w += kScanThreads) {
      removed[w] |= row[w];
    }
    __syncwarp();
  }
  __syncwarp();

  const int* go = order + (size_t)g * n;
  int* oi = out_idx + (size_t)g * m;
  uint8_t* ov = out_valid + (size_t)g * m;
  for (int s = lane; s < m; s += kScanThreads) {
    const bool ok = s < count;
    oi[s] = ok ? go[kept[s]] : 0;
    ov[s] = ok ? 1 : 0;
  }
}

// The keep scan over the G problems' masks (both NMS entries).
int launch_scan(const void* mask, const void* valid, const void* order, int g, int n,
                int col_blocks, int m, void* out_idx, void* out_valid, cudaStream_t s) {
  const size_t smem = col_blocks * sizeof(unsigned long long) + m * sizeof(int);
  nms_scan_kernel<<<g, kScanThreads, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<const int*>(order), n,
      col_blocks, m, static_cast<int*>(out_idx),
      static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes: (G, N, 4) float32, score-sorted, 16-byte aligned.
// valid: (G, N) uint8 of the sorted lanes.  order: (G, N) int32 sort order.
// mask: scratch of G * N * ceil(N / 64) 64-bit words.
// out_idx: (G, M) int32, out_valid: (G, M) uint8, M = min(N, max_out).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int frcnn_nms(const void* boxes, const void* valid, const void* order,
                         int g, int n, float threshold, int m, void* mask,
                         void* out_idx, void* out_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBoxesPerBlock - 1) / kBoxesPerBlock;
  const dim3 grid(col_blocks, col_blocks, g);
  nms_mask_kernel<<<grid, kBoxesPerBlock, 0, s>>>(
      static_cast<const float4*>(boxes), n, col_blocks, threshold,
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_scan(mask, valid, order, g, n, col_blocks, m, out_idx, out_valid, s);
}

// frcnn_nms for rotated boxes: boxes (G, N, 5) float32 [xc, yc, l, w, ry],
// score-sorted; every other argument as frcnn_nms.
extern "C" int frcnn_nms_rotated(const void* boxes, const void* valid, const void* order,
                                 int g, int n, float threshold, int m, void* mask,
                                 void* out_idx, void* out_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBoxesPerBlock - 1) / kBoxesPerBlock;
  const dim3 grid(col_blocks, col_blocks, g);
  nms_rotated_mask_kernel<<<grid, kBoxesPerBlock, 0, s>>>(
      static_cast<const float*>(boxes), n, col_blocks, threshold,
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_scan(mask, valid, order, g, n, col_blocks, m, out_idx, out_valid, s);
}

// a: (G, N, 5), b: (G, M, 5) float32 [xc, yc, l, w, ry]; out: (G, N, M)
// float32 rotated IoU, rows of a against columns of b.
extern "C" int frcnn_rotated_iou(const void* a, const void* b, int g, int n, int m, void* out,
                                 void* stream) {
  const dim3 grid((m + kBoxesPerBlock - 1) / kBoxesPerBlock,
                  (n + kBoxesPerBlock - 1) / kBoxesPerBlock, g);
  rotated_iou_kernel<<<grid, kBoxesPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), n, m,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
