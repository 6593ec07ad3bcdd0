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
// <= 1e-9 or the intersection is empty.
//
// Input is G problems of N boxes with raw scores and an optional validity
// byte a lane.  Output is the first M = min(N, max_out) kept lanes in score
// order (descending, ties to the lower lane, invalid lanes last: the JAX
// code's stable argsort), padded with index 0 and valid 0.
//
// What bounds it on the card: not bytes or FLOPs (the proposal problem is
// 8 x 2048 boxes, 4 MB of mask), but launch count and latency.  One call is
// three launches into one workspace (`workspace`):
//   1. nms_sort_kernel: a cluster of 8 blocks a problem.  Each block sorts
//      an eighth of the problem's 64-bit keys (the score's order bits, the
//      lane below them: stable by construction) in shared memory with a
//      bitonic network, its short steps in registers by shuffles; then each
//      key's place is the count of keys below it in all eight chunks, by
//      binary searches in the other blocks' shared memory (Hopper's
//      distributed shared memory).  It writes the sorted boxes, their
//      validity bytes and the sort order.  (One block a problem would keep
//      all but G of the 132 SMs idle.)
//   2. nms_mask_kernel (rotated: nms_rotated_mask_kernel): one block per
//      (problem, row block, column block >= row block) tile of 64 x 64
//      pairs, the upper triangle of tiles enumerated without empty blocks;
//      bit j of row i's word is set when column j > row i and the pair
//      overlaps past the threshold.  Axis-aligned: two threads a row, each
//      walking every other column in registers, the row's bits OR-ed by a
//      shuffle: a pair costs its IoU and the exact test (a lane a pair, with
//      a vote and a store a row, cost twice as many instructions).
//      Rotated: a lane a pair for the cheap bounding-circle test; the pairs
//      whose circles meet are queued a warp at a time, so that the clip runs
//      on full warps however few pairs meet.
//   3. nms_scan_kernel: one block of 256 threads per problem.  The
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
// Axis-aligned arithmetic: inter, union and the areas use the
// round-to-nearest intrinsics, so that nvcc cannot contract a multiply-add
// into an FMA and they equal the plain PyTorch version's bit for bit.  The
// test RN(inter / union) > t (t the float32 threshold) needs no division:
// with s the float32 after t and mid = (t + s) / 2, RN(q) > t exactly when
// q > mid, or q == mid and s has an even significand (ties to even).  mid
// has 25 significant bits and union 24, so mid * union is exact in double,
// as is inter: the test is inter > mid * union (or == with the tie flag) in
// double, the same predicate bit for bit.  The host code of frcnn_nms
// computes mid, the tie flag and the answer for union <= 0 (0 > t) once a
// call (`threshold_test`).
//
// Rotated arithmetic (rot_iou): the JAX package's formulation is a fixed
// 24-slot candidate buffer with an atan2 sort, shaped for vector units.
// Here a lane first tests the pair's bounding circles: centers farther
// apart than the two half-diagonals plus a rounding slack cannot overlap,
// and the clip would find them empty too (every vertex of the last stage
// lies more than the slack outside B's last edge), so the IoU is 0 without
// the clip.  Otherwise the lane clips quad A by B's four edges
// (Sutherland-Hodgman) in registers: a convex polygon of n slots (cyclic,
// repeated vertices allowed) becomes n + 1 slots, each vertex inside the
// half-plane kept in its slot, each vertex outside replaced by the exit
// crossing, and the entry crossing inserted before the first vertex back
// inside (at the end, as a repeat of the last slot, when there is none).
// Every index is a compile-time constant and the data only selects, so the
// 4 -> 5 -> 6 -> 7 -> 8 slots stay in registers; repeated vertices add
// nothing to the shoelace.  Every coordinate is taken relative to A's
// center (translation does not change the area): in voxel units the
// centers reach 400, and cross products of absolute coordinates would
// cancel.  A box is staged as its center, two half-axis vectors (from the
// precise sincosf of its heading), its area l * w (the twin's area) and its
// half-diagonal.  Two identical boxes have bitwise equal corners, so every
// signed distance is exactly 0 and the clip returns the box itself; their
// IoU is 1 within the float32 rounding of the shoelace against l * w, which
// grows as w / l shrinks (chip_smoke.self_iou_limit).  The IoU is not
// bitwise the twin's, so the keeps equal the twin's except where an IoU
// lies within float32 rounding of the threshold.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstring>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kBoxesPerBlock = 64;
constexpr size_t kScanSmemLimit = 232448 - 1024;  // sm_90's 227 KB, less the static part
constexpr int kSortMaxThreads = 1024;
constexpr float kNegInf = -1e30f;  // an invalid lane's score (ops/nms.py NEG_INF)

// ---------------------------------------------------------------- sort

// The lane's 32-bit sort key: ascending keys are descending scores.  Every
// NaN comes first (torch.sort's descending order puts NaN above +inf) and
// -0 and +0 share a key (they compare equal, so the lane decides).
__device__ __forceinline__ unsigned desc_key(float s) {
  if (s != s) return 0u;
  const unsigned u = s == 0.f ? 0u : __float_as_uint(s);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending as unsigned
  return ~ord;
}

__device__ __forceinline__ u64 shfl_xor64(u64 v, int mask) {
  const unsigned lo = __shfl_xor_sync(0xffffffffu, static_cast<unsigned>(v), mask);
  const unsigned hi = __shfl_xor_sync(0xffffffffu, static_cast<unsigned>(v >> 32), mask);
  return ((u64)hi << 32) | lo;
}

// One comparator step on a warp's 32 keys in registers, key = element
// (segment * 32 + lane): the partner is lane ^ partner, and the lane whose
// bit `top` is clear keeps the smaller key.
__device__ __forceinline__ u64 warp_step(u64 key, int lane, int partner, int top) {
  const u64 other = shfl_xor64(key, partner);
  return (lane & top) ? (other > key ? other : key) : (other < key ? other : key);
}

// A cluster of kSortCluster blocks a problem (blockIdx.x / kSortCluster).
// Block b holds the keys of lanes [b * chunk, (b + 1) * chunk), key =
// (desc_key(score), lane), +inf past n, in shared memory, and sorts them
// ascending by a bitonic network (comparators that all put the smaller key
// at the lower index: for each merge size k, i against i ^ (k - 1), then
// i against i ^ j for j = k / 4 .. 1).  Steps whose partner lies within 32
// keys run in registers on 32-key segments, a warp a segment, with
// shuffles: the merge sizes up to 32 in one pass, and for each larger merge
// its last five steps; only the steps across segments go through shared
// memory, a barrier each.  Then each key's place in the problem is the sum
// over the cluster's chunks of the keys below it (its own index in its own
// chunk), found by binary searches in the other blocks' shared memory
// (distributed shared memory): the keys are distinct, so the places are a
// permutation and the order is the stable one.
constexpr int kSortCluster = 8;

__global__ void __cluster_dims__(kSortCluster, 1, 1)
    nms_sort_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ valid,
                    const float* __restrict__ boxes, int n, int e, int chunk,
                    float* __restrict__ sorted_boxes, uint8_t* __restrict__ sorted_valid,
                    int* __restrict__ order) {
  extern __shared__ u64 keys[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.x / kSortCluster;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const float* gs = scores + (size_t)g * n;
  const uint8_t* gv = valid ? valid + (size_t)g * n : nullptr;
  const int base = rank * chunk;
  const int segments = chunk / 32;
  const u64 kPad = ~0ULL;
  // keys, and the merges up to 32 on each segment
  for (int seg = warp; seg < segments; seg += warps) {
    const int i = base + seg * 32 + lane;
    u64 key = kPad;
    if (i < n) {
      const float s = (gv == nullptr || gv[i]) ? gs[i] : kNegInf;
      key = ((u64)desc_key(s) << 32) | (unsigned)i;
    }
    for (int k = 2; k <= 32; k <<= 1) {
      key = warp_step(key, lane, k - 1, k >> 1);
      for (int j = k >> 2; j > 0; j >>= 1) key = warp_step(key, lane, j, j);
    }
    keys[seg * 32 + lane] = key;
  }
  __syncthreads();
  const int pairs = chunk >> 1;
  for (int k = 64; k <= chunk; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      const int partner = j == (k >> 1) ? k - 1 : j;  // i ^ partner; its top bit is j
      const int b = __ffs(j) - 1;
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int lo = ((p >> b) << (b + 1)) | (p & (j - 1));  // bit b clear
        const int hi = lo ^ partner;
        const u64 x = keys[lo], y = keys[hi];
        if (y < x) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncthreads();
    }
    for (int seg = warp; seg < segments; seg += warps) {
      u64 key = keys[seg * 32 + lane];
      for (int j = 16; j > 0; j >>= 1) key = warp_step(key, lane, j, j);
      keys[seg * 32 + lane] = key;
    }
    __syncthreads();
  }
  cluster.sync();  // every chunk sorted
  const u64* chunks[kSortCluster];
#pragma unroll
  for (int r = 0; r < kSortCluster; ++r) chunks[r] = cluster.map_shared_rank(keys, r);
  const float* gb = boxes + (size_t)g * n * e;
  float* ob = sorted_boxes + (size_t)g * n * e;
  for (int p = threadIdx.x; p < chunk; p += blockDim.x) {
    const u64 x = keys[p];
    if (x == kPad) break;  // the pads sort last
    // keys below x in each chunk (a power of two long), by interleaved
    // binary searches
    int below[kSortCluster];
#pragma unroll
    for (int r = 0; r < kSortCluster; ++r) below[r] = 0;
    for (int step = chunk; step > 0; step >>= 1) {
#pragma unroll
      for (int r = 0; r < kSortCluster; ++r) {
        if (below[r] + step <= chunk && chunks[r][below[r] + step - 1] < x) below[r] += step;
      }
    }
    int pos = 0;
#pragma unroll
    for (int r = 0; r < kSortCluster; ++r) pos += below[r];
    const int lane_p = static_cast<int>(x & 0xffffffffu);
    const float s = (gv == nullptr || gv[lane_p]) ? gs[lane_p] : kNegInf;
    order[(size_t)g * n + pos] = lane_p;
    sorted_valid[(size_t)g * n + pos] = s > kNegInf / 2;  // as the twin's sorted_scores > NEG_INF / 2
    for (int c = 0; c < e; ++c) ob[(size_t)pos * e + c] = gb[(size_t)lane_p * e + c];
  }
  cluster.sync();  // no block leaves while another reads its keys
}

// The chunk of a problem of n lanes that one block of the sort's cluster
// holds: a power of two, at least 32.
int sort_chunk(int n) {
  int chunk = 32;
  while (chunk * kSortCluster < n) chunk <<= 1;
  return chunk;
}

int launch_sort(const void* scores, const void* valid, const void* boxes, int g, int n, int e,
                void* sorted_boxes, void* sorted_valid, void* order, cudaStream_t s) {
  const int chunk = sort_chunk(n);
  const size_t smem = (size_t)chunk * sizeof(u64);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);  // n > 32,768
  const int threads = chunk < 64 ? 64 : (chunk > kSortMaxThreads ? kSortMaxThreads : chunk);
  nms_sort_kernel<<<g * kSortCluster, threads, smem, s>>>(
      static_cast<const float*>(scores), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(boxes), n, e, chunk, static_cast<float*>(sorted_boxes),
      static_cast<uint8_t*>(sorted_valid), static_cast<int*>(order));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- tiles

// Tile t of the upper triangle of a c x c grid of 64 x 64 tiles, row-major:
// row block r holds the c - r tiles (r, r) .. (r, c - 1) and starts at
// r * c - r * (r - 1) / 2.
__device__ __forceinline__ void upper_tile(int t, int c, int& rb, int& cb) {
  const float h = c + 0.5f;
  int r = static_cast<int>(h - sqrtf(fmaxf(h * h - 2.f * t, 0.f)));
  r = min(max(r, 0), c - 1);
  while (r > 0 && r * c - r * (r - 1) / 2 > t) --r;
  while (r + 1 < c && (r + 1) * c - (r + 1) * r / 2 <= t) ++r;
  rb = r;
  cb = r + t - (r * c - r * (r - 1) / 2);
}

// ---------------------------------------------------------------- K1 mask

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// The threshold t as the mask kernel tests it: mid = (t + s) / 2 with s the
// float32 after t, whether q == mid counts (s's significand even), and the
// answer when the union is <= 0 (0 > t).
struct Threshold {
  double mid;
  int tie, zero_over;
};

Threshold threshold_test(float t) {
  const float s = std::nextafter(t, INFINITY);
  uint32_t bits;
  std::memcpy(&bits, &s, sizeof bits);
  // t and s have at most 24 significant bits each: their sum is exact in double
  return {(static_cast<double>(t) + static_cast<double>(s)) / 2, (bits & 1u) == 0u, 0.f > t};
}

// inter and union of a pair, the twin's operations in its order.
__device__ __forceinline__ void inter_union(float4 a, float area_a, float4 b, float area_b,
                                            float& inter, float& uni) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  inter = __fmul_rn(iw, ih);
  uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
}

// RN(inter / uni) > t without a division (see the note at the top).
__device__ __forceinline__ bool exact_over(float inter, float uni, const Threshold& th) {
  const double lhs = static_cast<double>(inter);
  const double rhs = __dmul_rn(th.mid, static_cast<double>(uni));
  return uni > 0.f ? (lhs > rhs || (th.tie && lhs == rhs)) : th.zero_over;
}

// Threads a row of the axis-aligned mask's tile.
constexpr int kRowThreads = 2;

// One block a tile of the upper triangle (blockIdx.x; problem blockIdx.y),
// 64 x Q threads (Q = kRowThreads): thread (r, q) takes row r and the
// columns q, q + Q, ..., 64 / Q pairs in sequence with the row box in
// registers and the column boxes staged in shared memory (the Q threads of a
// step read Q neighbouring boxes).  The Q threads of a row are neighbouring
// lanes; their bits are OR-ed by shuffles into the row's word.
__global__ void __launch_bounds__(64 * kRowThreads) nms_mask_kernel(
    const float4* __restrict__ boxes, int n, int col_blocks, Threshold th, u64* __restrict__ mask) {
  constexpr int Q = kRowThreads;
  int rb, cb;
  upper_tile(blockIdx.x, col_blocks, rb, cb);
  const int g = blockIdx.y;
  const int row0 = rb * kBoxesPerBlock, col0 = cb * kBoxesPerBlock;
  const int row_size = min(n - row0, kBoxesPerBlock);
  const int col_size = min(n - col0, kBoxesPerBlock);
  const float4* gb = boxes + (size_t)g * n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  __shared__ float4 cols[kBoxesPerBlock];
  __shared__ float col_area[kBoxesPerBlock];
  if (threadIdx.x < kBoxesPerBlock) {
    const float4 c = threadIdx.x < col_size ? gb[col0 + threadIdx.x] : zero;
    cols[threadIdx.x] = c;
    col_area[threadIdx.x] = box_area(c);
  }
  __syncthreads();
  const int r = threadIdx.x / Q, q = threadIdx.x % Q;
  const float4 a = r < row_size ? gb[row0 + r] : zero;
  const float area_a = box_area(a);
  unsigned lo = 0u, hi = 0u;  // bit j Q (- 32) for column j Q + q
#pragma unroll
  for (int j = 0; j < kBoxesPerBlock / Q; ++j) {
    const int c = j * Q + q;
    float inter, uni;
    inter_union(a, area_a, cols[c], col_area[c], inter, uni);
    const bool over = exact_over(inter, uni, th);
    if (j * Q < 32) {
      lo |= static_cast<unsigned>(over) << (j * Q);
    } else {
      hi |= static_cast<unsigned>(over) << (j * Q - 32);
    }
  }
  u64 bits = (((u64)hi << 32) | lo) << q;
  // the columns that may set a bit: inside the problem, and past the row on
  // the diagonal tile
  u64 live = col_size == kBoxesPerBlock ? ~0ULL : (1ULL << col_size) - 1ULL;
  if (rb == cb) live &= r + 1 < kBoxesPerBlock ? ~0ULL << (r + 1) : 0ULL;
  bits &= live;
#pragma unroll
  for (int m = 1; m < Q; m <<= 1) bits |= shfl_xor64(bits, m);
  if (q == 0 && r < row_size) mask[((size_t)g * n + row0 + r) * col_blocks + cb] = bits;
}

// ---------------------------------------------------------------- K4 mask

// A rotated BEV rectangle [xc, yc, l, w, ry]: center, half-length axis
// u = (l / 2)(cos ry, sin ry), half-width axis v = (w / 2)(-sin ry, cos ry),
// area l * w, half-diagonal r.  Its corners, counter-clockwise as the
// twin's box5_corners: c + u - v, c + u + v, c - u + v, c - u - v.
struct __align__(16) RotBox {
  float cx, cy, ux, uy, vx, vy, area, r;
};

__device__ __forceinline__ RotBox load_rot_box(const float* b) {
  float s, c;
  sincosf(b[4], &s, &c);
  const float hl = 0.5f * b[2], hw = 0.5f * b[3];
  return {b[0], b[1], hl * c, hl * s, -hw * s, hw * c, b[2] * b[3],
          0.5f * sqrtf(b[2] * b[2] + b[3] * b[3])};
}

// Whether the bounding circles of a and b (centers dx, dy apart) are apart
// by more than a rounding slack: then the pair cannot overlap.  The slack,
// 1e-5 of the coordinates' scale, is ~170 float32 ulps of each quantity the
// clip rounds.
__device__ __forceinline__ bool circles_apart(const RotBox& a, const RotBox& b) {
  const float dx = b.cx - a.cx, dy = b.cy - a.cy;
  const float reach = a.r + b.r;
  const float lim = reach + 1e-5f * (fabsf(dx) + fabsf(dy) + reach);
  return dx * dx + dy * dy > lim * lim;
}

// One Sutherland-Hodgman stage in registers: the polygon (px, py) of N
// slots (cyclic, repeats allowed) clipped by the half-plane left of the edge
// from o along e, into N + 1 slots (see the note at the top).  A point p is
// inside when cross(e, p - o) >= 0, taken without FMA contraction so that a
// vertex on the edge's own line tests as exactly 0.
template <int N>
__device__ __forceinline__ void clip_stage(const float (&px)[N], const float (&py)[N], float ox,
                                           float oy, float ex, float ey, float (&qx)[N + 1],
                                           float (&qy)[N + 1]) {
  float d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i] = __fsub_rn(__fmul_rn(ex, __fsub_rn(py[i], oy)), __fmul_rn(ey, __fsub_rn(px[i], ox)));
  }
  // the edges (i - 1 -> i) that leave and that re-enter the half-plane
  float xs = px[0], ys = py[0], xe = px[0], ye = py[0], ds = 1.f, de = 0.f;
  float ixs = px[0], iys = py[0], ixe = px[0], iye = py[0], ids = 1.f, ide = 0.f;
  bool leaves = false, enters = false;
  int at = N;  // where the entry crossing goes
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i + N - 1) % N;
    const bool in_h = d[h] >= 0.f, in_i = d[i] >= 0.f;
    if (in_h && !in_i) {
      leaves = true;
      xs = px[h]; ys = py[h]; ds = d[h];
      xe = px[i]; ye = py[i]; de = d[i];
    }
    if (!in_h && in_i && !enters) {
      enters = true;
      at = i;
      ixs = px[h]; iys = py[h]; ids = d[h];
      ixe = px[i]; iye = py[i]; ide = d[i];
    }
  }
  float ox_ = px[0], oy_ = py[0];  // the exit crossing (any slot when nothing leaves)
  if (leaves) {
    const float t = __fdividef(ds, ds - de);
    ox_ = xs + t * (xe - xs);
    oy_ = ys + t * (ye - ys);
  }
  float base_x[N], base_y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool in_i = d[i] >= 0.f;
    base_x[i] = in_i ? px[i] : ox_;
    base_y[i] = in_i ? py[i] : oy_;
  }
  float nx = base_x[N - 1], ny = base_y[N - 1];  // the entry crossing, else a repeat
  if (enters) {
    const float t = __fdividef(ids, ids - ide);
    nx = ixs + t * (ixe - ixs);
    ny = iys + t * (iye - iys);
  }
#pragma unroll
  for (int j = 0; j <= N; ++j) {
    const float bx = j < N ? base_x[j] : 0.f, by = j < N ? base_y[j] : 0.f;
    const float px_prev = j > 0 ? base_x[j - 1] : 0.f, py_prev = j > 0 ? base_y[j - 1] : 0.f;
    qx[j] = j < at ? bx : (j == at ? nx : px_prev);
    qy[j] = j < at ? by : (j == at ? ny : py_prev);
  }
}

// Area of the intersection of two rotated rectangles: a's quad clipped by
// b's four edges, then the shoelace; everything relative to a's center.
__device__ float rot_intersection(const RotBox& a, const RotBox& b) {
  const float dx = b.cx - a.cx, dy = b.cy - a.cy;
  float bx[4], by[4];
  bx[0] = dx + b.ux - b.vx;  by[0] = dy + b.uy - b.vy;
  bx[1] = dx + b.ux + b.vx;  by[1] = dy + b.uy + b.vy;
  bx[2] = dx - b.ux + b.vx;  by[2] = dy - b.uy + b.vy;
  bx[3] = dx - b.ux - b.vx;  by[3] = dy - b.uy - b.vy;
  float p4x[4] = {a.ux - a.vx, a.ux + a.vx, -a.ux + a.vx, -a.ux - a.vx};
  float p4y[4] = {a.uy - a.vy, a.uy + a.vy, -a.uy + a.vy, -a.uy - a.vy};
  float p5x[5], p5y[5], p6x[6], p6y[6], p7x[7], p7y[7], p8x[8], p8y[8];
  clip_stage<4>(p4x, p4y, bx[0], by[0], bx[1] - bx[0], by[1] - by[0], p5x, p5y);
  clip_stage<5>(p5x, p5y, bx[1], by[1], bx[2] - bx[1], by[2] - by[1], p6x, p6y);
  clip_stage<6>(p6x, p6y, bx[2], by[2], bx[3] - bx[2], by[3] - by[2], p7x, p7y);
  clip_stage<7>(p7x, p7y, bx[3], by[3], bx[0] - bx[3], by[0] - by[3], p8x, p8y);
  float twice = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = (i + 1) & 7;
    // no contraction: a repeated vertex's two terms cancel exactly
    twice = __fadd_rn(twice, __fsub_rn(__fmul_rn(p8x[i], p8y[j]), __fmul_rn(p8x[j], p8y[i])));
  }
  return 0.5f * fabsf(twice);
}

// The IoU of a pair by the clip, whatever its circles.
__device__ __forceinline__ float rot_iou_clipped(const RotBox& a, const RotBox& b) {
  const float inter = rot_intersection(a, b);
  const float uni = a.area + b.area - inter;
  return uni > 1e-9f ? inter / uni : 0.f;
}

__device__ __forceinline__ float rot_iou(const RotBox& a, const RotBox& b) {
  return circles_apart(a, b) ? 0.f : rot_iou_clipped(a, b);
}

// The tile's 64 row boxes and 64 column boxes of a (G, N, 5) set, staged
// once in shared memory by the block's first 128 threads.
__device__ __forceinline__ void stage_rot_boxes(const float* rows, int row_size,
                                                const float* cols, int col_size, RotBox* srow,
                                                RotBox* scol) {
  for (int i = threadIdx.x; i < 2 * kBoxesPerBlock; i += blockDim.x) {
    if (i < kBoxesPerBlock) {
      if (i < row_size) srow[i] = load_rot_box(rows + (size_t)i * 5);
    } else if (i - kBoxesPerBlock < col_size) {
      scol[i - kBoxesPerBlock] = load_rot_box(cols + (size_t)(i - kBoxesPerBlock) * 5);
    }
  }
  __syncthreads();
}

constexpr int kRotMaskThreads = 256;

// nms_mask_kernel for rotated boxes, (G, N, 5) [xc, yc, l, w, ry] float32.
// A warp walks its rows' 64 columns a lane a pair through the circle test
// only, and queues the pairs whose circles meet (row << 6 | column) in
// shared memory; each time 32 are queued, each lane clips one of them, so
// that the clip runs on full warps whatever the share of meeting pairs (a
// half-row whose 32 pairs all meet clips in place, without the queue).
// The bits land in the tile's 64 row words in shared memory (atomicOr),
// written out at the end.
__global__ void __launch_bounds__(kRotMaskThreads) nms_rotated_mask_kernel(
    const float* __restrict__ boxes, int n, int col_blocks, float threshold,
    u64* __restrict__ mask) {
  int rb, cb;
  upper_tile(blockIdx.x, col_blocks, rb, cb);
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int row0 = rb * kBoxesPerBlock, col0 = cb * kBoxesPerBlock;
  const int row_size = min(n - row0, kBoxesPerBlock);
  const int col_size = min(n - col0, kBoxesPerBlock);
  const float* gb = boxes + (size_t)g * n * 5;
  __shared__ RotBox srow[kBoxesPerBlock], scol[kBoxesPerBlock];
  __shared__ u64 words[kBoxesPerBlock];
  __shared__ unsigned queue[kRotMaskThreads / 32][2 * 32];
  if (threadIdx.x < kBoxesPerBlock) words[threadIdx.x] = 0ULL;
  stage_rot_boxes(gb + (size_t)row0 * 5, row_size, gb + (size_t)col0 * 5, col_size, srow, scol);
  unsigned* q = queue[warp];
  int queued = 0;
  const bool diag = rb == cb;
  // clip the queue's first `count` pairs, a lane each
  auto drain = [&](int count) {
    if (lane < count) {
      const unsigned pair = q[lane];
      const int r = pair >> 6, c = pair & 63;
      if (rot_iou_clipped(srow[r], scol[c]) > threshold) atomicOr(&words[r], 1ULL << c);
    }
  };
  for (int r = warp; r < row_size; r += warps) {
    const RotBox a = srow[r];
    const int first = diag ? r + 1 : 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half;
      const bool meet = c >= first && c < col_size && !circles_apart(a, scol[c]);
      const unsigned ballot = __ballot_sync(0xffffffffu, meet);
      if (ballot == 0xffffffffu) {  // every lane meets: clip in place
        const unsigned over = __ballot_sync(0xffffffffu, rot_iou_clipped(a, scol[c]) > threshold);
        if (lane == 0) atomicOr(&words[r], (u64)over << (32 * half));
        continue;
      }
      if (meet) q[queued + __popc(ballot & ((1u << lane) - 1u))] = (r << 6) | c;
      queued += __popc(ballot);
      __syncwarp();
      if (queued >= 32) {
        drain(32);
        __syncwarp();
        if (lane < queued - 32) q[lane] = q[lane + 32];
        queued -= 32;
        __syncwarp();
      }
    }
  }
  drain(queued);
  __syncthreads();
  if (threadIdx.x < row_size) {
    mask[((size_t)g * n + row0 + threadIdx.x) * col_blocks + cb] = words[threadIdx.x];
  }
}

// The (G, N, M) rotated IoU matrix of (G, N, 5) rows vs (G, M, 5) columns:
// one 256-thread block per (problem, row block, column block), the block's
// rows and columns staged in shared memory, one pair a lane.
__global__ void __launch_bounds__(256) rotated_iou_kernel(const float* __restrict__ a,
                                                          const float* __restrict__ b, int n,
                                                          int m, float* __restrict__ out) {
  const int g = blockIdx.z;
  const int row0 = blockIdx.y * kBoxesPerBlock, col0 = blockIdx.x * kBoxesPerBlock;
  const int row_size = min(n - row0, kBoxesPerBlock);
  const int col_size = min(m - col0, kBoxesPerBlock);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  __shared__ RotBox srow[kBoxesPerBlock], scol[kBoxesPerBlock];
  stage_rot_boxes(a + ((size_t)g * n + row0) * 5, row_size, b + ((size_t)g * m + col0) * 5,
                  col_size, srow, scol);
  for (int r = warp; r < row_size; r += warps) {
    const RotBox ra = srow[r];
    float* o = out + ((size_t)g * n + row0 + r) * m + col0;
    if (lane < col_size) o[lane] = rot_iou(ra, scol[lane]);
    if (lane + 32 < col_size) o[lane + 32] = rot_iou(ra, scol[lane + 32]);
  }
}

// ---------------------------------------------------------------- scan

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


// The workspace of one NMS call, 16-byte aligned pieces: the sorted boxes
// (G, N, e) float32, their valid bytes (G, N), the sort order (G, N) int32,
// then the mask, G * N * col_blocks + 2 words (the scan's bulk copies round
// each row block out to 16-byte bounds).
struct Workspace {
  size_t boxes, valid, order, mask, bytes;
};

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

Workspace workspace(int g, int n, int e) {
  const size_t lanes = (size_t)g * n;
  const size_t col_blocks = (n + kBoxesPerBlock - 1) / kBoxesPerBlock;
  Workspace w;
  w.boxes = 0;
  w.valid = align16(lanes * e * sizeof(float));
  w.order = w.valid + align16(lanes);
  w.mask = w.order + align16(lanes * sizeof(int));
  w.bytes = w.mask + (lanes * col_blocks + 2) * sizeof(u64);
  return w;
}

// Sort, then the mask kernel (rotated or axis-aligned), then the scan, all
// on stream s.
int run_nms(const void* scores, const void* valid, const void* boxes, int g, int n, bool rotated,
            float threshold, int m, void* workspace_ptr, void* out_idx, void* out_valid,
            cudaStream_t s) {
  const Workspace w = workspace(g, n, rotated ? 5 : 4);
  char* ws = static_cast<char*>(workspace_ptr);
  const int err = launch_sort(scores, valid, boxes, g, n, rotated ? 5 : 4, ws + w.boxes,
                              ws + w.valid, ws + w.order, s);
  if (err) return err;
  const int col_blocks = (n + kBoxesPerBlock - 1) / kBoxesPerBlock;
  const dim3 grid(col_blocks * (col_blocks + 1) / 2, g);
  u64* mask = reinterpret_cast<u64*>(ws + w.mask);
  if (rotated) {
    nms_rotated_mask_kernel<<<grid, kRotMaskThreads, 0, s>>>(
        reinterpret_cast<const float*>(ws + w.boxes), n, col_blocks, threshold, mask);
  } else {
    nms_mask_kernel<<<grid, 64 * kRowThreads, 0, s>>>(reinterpret_cast<const float4*>(ws + w.boxes),
                                                      n, col_blocks, threshold_test(threshold),
                                                      mask);
  }
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return launch_scan(mask, ws + w.valid, ws + w.order, g, n, col_blocks, m, out_idx, out_valid, s);
}

}  // namespace

// Bytes of the workspace frcnn_nms (e = 4) and frcnn_nms_rotated (e = 5)
// take for G problems of N lanes.
extern "C" long long frcnn_nms_workspace_bytes(int g, int n, int e) {
  return static_cast<long long>(workspace(g, n, e).bytes);
}

// scores: (G, N) float32.  valid: (G, N) bytes (0 = never kept), or null for
// all valid.  boxes: (G, N, 4) float32 x1y1x2y2.  threshold: the float32
// IoU threshold.  workspace: frcnn_nms_workspace_bytes(g, n, 4) bytes,
// 16-byte aligned.
// out_idx: (G, M) int32, out_valid: (G, M) uint8, M = min(N, max_out).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int frcnn_nms(const void* scores, const void* valid, const void* boxes, int g, int n,
                         float threshold, int m, void* workspace, void* out_idx, void* out_valid,
                         void* stream) {
  return run_nms(scores, valid, boxes, g, n, false, threshold, m, workspace, out_idx, out_valid,
                 static_cast<cudaStream_t>(stream));
}

// frcnn_nms for rotated boxes: boxes (G, N, 5) float32 [xc, yc, l, w, ry],
// a threshold >= 0; workspace frcnn_nms_workspace_bytes(g, n, 5) bytes;
// every other argument as frcnn_nms.
extern "C" int frcnn_nms_rotated(const void* scores, const void* valid, const void* boxes, int g,
                                 int n, float threshold, int m, void* workspace, void* out_idx,
                                 void* out_valid, void* stream) {
  return run_nms(scores, valid, boxes, g, n, true, threshold, m, workspace, out_idx, out_valid,
                 static_cast<cudaStream_t>(stream));
}

// The sort kernel alone, for checks: scores, valid and boxes (G, N, e) as
// frcnn_nms takes them; sorted_boxes (G, N, e) float32, sorted_valid (G, N)
// uint8, order (G, N) int32.
extern "C" int frcnn_nms_sort(const void* scores, const void* valid, const void* boxes, int g,
                              int n, int e, void* sorted_boxes, void* sorted_valid, void* order,
                              void* stream) {
  return launch_sort(scores, valid, boxes, g, n, e, sorted_boxes, sorted_valid, order,
                     static_cast<cudaStream_t>(stream));
}

// a: (G, N, 5), b: (G, M, 5) float32 [xc, yc, l, w, ry]; out: (G, N, M)
// float32 rotated IoU, rows of a against columns of b.
extern "C" int frcnn_rotated_iou(const void* a, const void* b, int g, int n, int m, void* out,
                                 void* stream) {
  const dim3 grid((m + kBoxesPerBlock - 1) / kBoxesPerBlock,
                  (n + kBoxesPerBlock - 1) / kBoxesPerBlock, g);
  rotated_iou_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), n, m,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
