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
//   2. nms_scan_kernel: one block of 256 threads per problem.  The
//      `removed` bit set (N/64 words)
//      lives in shared memory and starts as the complement of the valid
//      lanes.  The scan walks the rows in blocks of 64.  The words of block
//      j's rows from the diagonal on are copied into shared memory by one
//      TMA bulk copy on an mbarrier, two blocks ahead (fewer where three
//      buffers do not fit), so no kept row's words come from global memory
//      while the scan waits.
//      One warp resolves the block's 64 keep decisions from removed[j] and
//      the staged diagonal words, as the fixed point of a warp-wide OR of
//      the kept rows' diagonal words; then the warps OR the kept rows'
//      staged words into `removed`, a share of the rows each, a word a lane.  The scan stops as soon as
//      M lanes are kept.  The kept bits are mapped to slots and through the
//      sort order in one parallel pass at the end.
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
constexpr size_t kScanSmemLimit = 232448 - 1024;  // sm_90's 227 KB, less the static part

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

using u64 = unsigned long long;

constexpr int kScanThreads = 256;
constexpr int kMaxStages = 3;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Row block j of a problem's mask: its words from (row 0, word j) to the
// end of its last row, one contiguous range (the scan reads only words j..
// of each row; the words left of the diagonal in rows 1.. ride along).
// One thread issues it as a TMA bulk copy completed on `bar`.  The copy is
// widened to 16-byte bounds (the wrapper pads the mask by 2 words), and the
// block lands at buffer word block_shift(...), so that both ends are
// 16-byte aligned: word k of the block is dst[k + shift].
__device__ __forceinline__ int block_shift(int g, int n, int col_blocks, int j) {
  return static_cast<int>((((size_t)g * n + (size_t)j * kBoxesPerBlock) * col_blocks) & 1);
}

__device__ __forceinline__ void stage_block(u64* dst, u64* bar, const u64* mask, int g, int n,
                                            int col_blocks, int j) {
  const int rows = min(n - j * kBoxesPerBlock, kBoxesPerBlock);
  const size_t block = ((size_t)g * n + (size_t)j * kBoxesPerBlock) * col_blocks;
  const size_t first = (block + j) & ~(size_t)1;
  const size_t end = (block + (size_t)rows * col_blocks + 1) & ~(size_t)1;
  const unsigned bytes = static_cast<unsigned>((end - first) * sizeof(u64));
  u64* to = dst + ((long long)first - (long long)block + (long long)(block & 1));  // first >= block - 1
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // earlier reads of the buffer
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(to)),
      "l"(mask + first), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Dynamic shared memory, 16-byte aligned: `stages` buffers of 64 x
// col_blocks + 2 staged words, then removed[col_blocks], kept[col_blocks]
// (each block's kept rows as bits), first_slot[col_blocks + 1] (int).
// Block j is staged into buffer j % stages, stages - 1 blocks ahead of the
// scan (with one buffer: just before it), on that buffer's mbarrier.
__global__ void nms_scan_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                                const int* __restrict__ order, int n, int col_blocks, int m,
                                int stages, int* __restrict__ out_idx,
                                uint8_t* __restrict__ out_valid) {
  extern __shared__ __align__(16) u64 smem[];
  __shared__ int count_s;
  __shared__ int kept_rows_s[kBoxesPerBlock];  // block j's kept rows, in order
  __shared__ __align__(8) u64 bars[kMaxStages];
  const size_t stage_words = (size_t)kBoxesPerBlock * col_blocks + 2;
  u64* stage = smem;
  u64* removed = stage + stages * stage_words;
  u64* kept = removed + col_blocks;
  int* first_slot = reinterpret_cast<int*>(kept + col_blocks);

  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  const uint8_t* gv = valid + (size_t)g * n;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s + 1 < stages && s < col_blocks; ++s) {
      stage_block(stage + s * stage_words, &bars[s], mask, g, n, col_blocks, s);
    }
  }
  // removed starts as "not valid": lanes past n count as removed too; a
  // warp's ballot is half a word
  unsigned* removed_half = reinterpret_cast<unsigned*>(removed);
#pragma unroll 4
  for (int half = warp; half < 2 * col_blocks; half += warps) {
    const int i = half * 32 + lane;
    const unsigned ok = __ballot_sync(0xffffffffu, i < n && gv[i] != 0);
    if (lane == 0) removed_half[half] = ~ok;
  }
  for (int w = t; w < col_blocks; w += blockDim.x) kept[w] = 0ULL;
  if (t == 0) count_s = 0;
  __syncthreads();  // the barriers are initialised before anyone waits on them

  int count = 0;  // every thread's copy of count_s, updated once a block
  int j = 0;
  for (; j < col_blocks && count < m; ++j) {
    const int buf = j % stages;
    if (stages == 1) {
      __syncthreads();  // the one buffer is free once block j - 1 is applied
      if (t == 0) stage_block(stage, &bars[0], mask, g, n, col_blocks, j);
    }
    mbar_wait(&bars[buf], (j / stages) & 1);
    __syncthreads();  // removed[j] final, block j - 1 applied
    if (t == 0 && stages > 1 && j + stages - 1 < col_blocks) {
      const int jn = j + stages - 1;
      stage_block(stage + (jn % stages) * stage_words, &bars[jn % stages], mask, g, n,
                  col_blocks, jn);
    }
    const u64* st = stage + buf * stage_words + block_shift(g, n, col_blocks, j);
    if (warp == 0) {
      // block j's keeps: the greedy set is the one fixed point of
      // K = free & ~OR_{r in K} diag[r] (diag[r] holds only rows after r,
      // so row i's bit is settled once the rows before it are).  Iterate
      // from K = free, lane l holding rows l and l + 32, until K stops
      // changing: as many rounds as the longest suppression chain, plus one.
      const u64 d0 = st[lane * col_blocks + j];
      const u64 d1 = st[(lane + 32) * col_blocks + j];
      const u64 free = ~removed[j];
      u64 bits = free;
      for (;;) {
        const u64 mine = (((bits >> lane) & 1ULL) ? d0 : 0ULL) |
                         (((bits >> (lane + 32)) & 1ULL) ? d1 : 0ULL);
        const u64 sup = ((u64)__reduce_or_sync(0xffffffffu, static_cast<unsigned>(mine >> 32))
                         << 32) |
                        __reduce_or_sync(0xffffffffu, static_cast<unsigned>(mine));
        const u64 next = free & ~sup;
        if (next == bits) break;
        bits = next;
      }
      // stop at the m-th keep: drop the block's last kept rows beyond it
      const int room = m - count;
      while (__popcll(bits) > room) bits &= ~(1ULL << (63 - __clzll(static_cast<long long>(bits))));
      if ((bits >> lane) & 1ULL) kept_rows_s[__popcll(bits & ((1ULL << lane) - 1ULL))] = lane;
      if ((bits >> (lane + 32)) & 1ULL) {
        kept_rows_s[__popcll(bits & ((1ULL << (lane + 32)) - 1ULL))] = lane + 32;
      }
      if (lane == 0) {
        kept[j] = bits;
        count_s = count + __popcll(bits);
      }
    }
    __syncthreads();
    const int block_kept = count_s - count;
    count = count_s;
    // OR the kept rows' words right of the diagonal into removed: warp i
    // takes kept rows i, i + warps, ..., its lanes the words
    if (block_kept > warp) {
      for (int w = j + 1 + lane; w < col_blocks; w += 32) {
        u64 acc = 0ULL;
        for (int i = warp; i < block_kept; i += warps) acc |= st[kept_rows_s[i] * col_blocks + w];
        if (acc) atomicOr(&removed[w], acc);
      }
    }
  }
  // the blocks staged ahead of a scan that stopped early must land before
  // the block exits
  const int staged = stages == 1 ? j : min(col_blocks, j + stages - 1);
  for (int jj = j; jj < staged; ++jj) mbar_wait(&bars[jj % stages], (jj / stages) & 1);
  __syncthreads();

  if (t == 0) {
    int s = 0;
    for (int w = 0; w < col_blocks; ++w) {
      first_slot[w] = s;
      s += __popcll(kept[w]);
    }
    first_slot[col_blocks] = s;
  }
  __syncthreads();
  const int* go = order + (size_t)g * n;
  int* oi = out_idx + (size_t)g * m;
  uint8_t* ov = out_valid + (size_t)g * m;
  for (int i = t; i < n; i += blockDim.x) {
    const int w = i / kBoxesPerBlock, r = i % kBoxesPerBlock;
    const u64 k = kept[w];
    if ((k >> r) & 1ULL) {
      const int s = first_slot[w] + __popcll(k & ((1ULL << r) - 1ULL));
      oi[s] = go[i];
      ov[s] = 1;
    }
  }
  for (int s = first_slot[col_blocks] + t; s < m; s += blockDim.x) {
    oi[s] = 0;
    ov[s] = 0;
  }
}

// The scan's dynamic shared memory for `stages` staged row blocks.
size_t scan_smem_bytes(int col_blocks, int stages) {
  return ((size_t)stages * ((size_t)kBoxesPerBlock * col_blocks + 2) + 2 * col_blocks +
          (col_blocks + 2) / 2) * sizeof(u64);
}

// The keep scan over the G problems' masks (both NMS entries): three
// staging buffers where they fit, else two, else one.  The mask holds 2
// words of padding past its G x N x col_blocks.
int launch_scan(const void* mask, const void* valid, const void* order, int g, int n,
                int col_blocks, int m, void* out_idx, void* out_valid, cudaStream_t s) {
  int stages = kMaxStages;
  while (stages > 1 && scan_smem_bytes(col_blocks, stages) > kScanSmemLimit) --stages;
  const size_t smem = scan_smem_bytes(col_blocks, stages);
  if (smem > kScanSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<g, kScanThreads, smem, s>>>(
      static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(order), n, col_blocks, m, stages, static_cast<int*>(out_idx),
      static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes: (G, N, 4) float32, score-sorted, 16-byte aligned.
// valid: (G, N) uint8 of the sorted lanes.  order: (G, N) int32 sort order.
// mask: scratch of G * N * ceil(N / 64) + 2 64-bit words, 16-byte aligned.
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
