// RoI align, single-level and multiscale (FPN), forward and backward, for
// Hopper (sm_90a), plain C ABI (ctypes).  The multiscale kernels are at the
// end of the anonymous namespace.
//
// Replaces: faster_rcnn_pytorch_multimodal_tpu/ops/roi_align.py `roi_align`
// and `roi_align_batched` (with `_sample_coords`), and their gradient with
// respect to the features, which XLA derives by transposing the two einsums
// (ops/roi_align.py:103-118).  The JAX package writes the bilinear sampling
// as two interpolation-matrix einsums because gathers are slow on a TPU; on
// this card the forward is a gather of staged tap cells and the backward a
// gather of output gradients into tiles of the map.
//
// The forward at the serving shapes (B 8, R 300, P 7, C 1024) pools 16 taps
// into each of 8 x 300 x 49 x 1024 outputs.  Loaded tap by tap that is 3.9
// GB of bf16 load requests for 272 MB of maps and output, and the number of
// outputs, not the map, set the time.  But the taps of a RoI's bins repeat:
// a RoI of 16-256 px at stride 16 has 2-17 distinct tap rows and columns,
// against 2 x P x sr = 28 tap positions a side.  So a forward block owns one
// RoI and a slice of channels (one warp, 4 channels a thread), builds the
// RoI's read plan (its distinct tap rows and columns in increasing order,
// and each sample's place among them), and stages the cells of each tap row
// at the distinct tap columns in shared memory with cp.async, up to six
// rows ahead of the one it computes (a ring of 3 x P x sr cells: one row
// of a RoI with more than 1.5 x P x sr distinct columns).  Each staged
// row is interpolated along x at the P x sr x-samples and summed per bin
// column once, then combined along y into the bin row's sums in registers;
// each bin is written once, one coalesced store a warp (bf16 rounded in the
// same pass).  Every tap cell of the RoI is read from L2 once per block.
// The multiscale forward runs the same body (`pool_roi_staged`) on each
// RoI's level.
//
// The backward at the training shapes (B 8, R 256, P 7, C 1024) has
// 8 x 256 x 49 x 16 x 1024 = 1.6e9 float32 channel-taps to add into the
// feature gradient.  Spread as atomics into L2 they set its time (2.4 ms on
// a 32 x 60 map and on a 25 x 22 one alike), so the backward is a gather
// instead: each block owns a tile of 2 x 4 map cells of one frame and a
// slice of channels, 4 channels a thread, and keeps the tile's float32
// sums in registers.  No two threads write one word, so there are no
// atomics, and every cell sums its contributions in one fixed order (RoI,
// bin row, bin column), so the result is the same bit for bit from run to
// run.  A first pass lists each frame's RoIs (by level, for the pyramid)
// with their tap footprints (`axis_span`), so a block culls a RoI whose
// footprint misses its tile with four comparisons.  A bin's weight on cell (y, x) is wy(y) wx(x), the bin
// row's and the bin column's summed tap weights (dense profiles over the
// tile's rows and columns, in shared memory), so a RoI adds
// sum_ph wy_ph (x) (sum_pw g[ph, pw] wx_pw): register FMAs, with shared
// memory touched only for the profiles (sums in shared memory instead, one
// read-modify-write a tap, are bound by shared-memory bandwidth).  The
// tile is written once, in the features' dtype (bf16 rounded in the same
// pass), every cell of it, so the gradient needs no zeroing.  The
// multiscale backward runs the same tile body (`gather_tile`) over the
// tiles of the four levels.
//
// Semantics (the JAX package's, parity waiver 6): torchvision box mapping
// with aligned=False by default (RoI size floored at 1 px on the feature
// map), a FIXED sampling_ratio sr, sample coordinates clamped to
// [0, dim - 1], bilinear taps lo = floor(c), hi = min(lo + 1, dim - 1), and
// the mean over the sr x sr samples of each bin.
//
// Layout: features NHWC (B, H, W, C), rois (B, R, 4) float32 in input
// pixels, output (B, R, P, P, C) in the features' dtype (float32 or
// bfloat16), accumulated in float32.
//
// What bounds them on the card: bytes (the maps, the output or dOut, and
// the gradient, each once).  Sample coordinates use round-to-nearest
// intrinsics so they match the plain PyTorch version bit for bit; only the
// accumulation order differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cmath>

namespace {

// VEC consecutive channels <-> float registers.
template <typename T, int VEC>
struct VecIO;

template <>
struct VecIO<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct VecIO<float, 1> {
  __device__ static void load(const float* p, float (&v)[1]) { v[0] = *p; }
  __device__ static void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

template <>
struct VecIO<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  }
};

template <>
struct VecIO<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[4]) {
    uint2 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint2*>(p) = t;
  }
};

template <>
struct VecIO<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// One bilinear sample axis: clamped coordinate -> (lo, hi, w_lo, w_hi).
struct Taps {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Taps axis_taps(float start, float bin, int s, int sr,
                                          int dim) {
  // start + ((s + 0.5) / sr) * bin, clamped to [0, dim - 1]; a power-of-two
  // sr divides exactly by multiplying with its exact reciprocal
  const float num = __fadd_rn(static_cast<float>(s), 0.5f);
  const float frac = (sr & (sr - 1)) == 0 ? __fmul_rn(num, 1.f / static_cast<float>(sr))
                                          : __fdiv_rn(num, static_cast<float>(sr));
  const float g = __fadd_rn(start, __fmul_rn(frac, bin));
  const float c = fminf(fmaxf(g, 0.f), static_cast<float>(dim - 1));
  Taps t;
  t.lo = static_cast<int>(floorf(c));
  t.hi = min(t.lo + 1, dim - 1);
  t.w_hi = __fsub_rn(c, static_cast<float>(t.lo));
  t.w_lo = __fsub_rn(1.f, t.w_hi);
  return t;
}

// One RoI's box on a map: start corner and bin size (torchvision's mapping:
// aligned=False floors the RoI size at one feature cell).
struct RoIBox {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ RoIBox roi_box(const float* roi, float scale, int p, int aligned) {
  const float offset = aligned ? 0.5f : 0.f;
  const float min_size = aligned ? 0.f : 1.f;
  RoIBox r;
  r.x1 = __fsub_rn(__fmul_rn(roi[0], scale), offset);
  r.y1 = __fsub_rn(__fmul_rn(roi[1], scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], scale), offset);
  r.bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, r.x1), min_size), static_cast<float>(p));
  r.bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, r.y1), min_size), static_cast<float>(p));
  return r;
}

// -- cp.async: 4-, 8- and 16-byte copies from global to shared memory ------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` (0..6) of this thread's newest groups are
// still in flight.
__device__ __forceinline__ void cp_async_wait_at_most(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// VEC channels of one cell into shared memory: cp.async where the vector is
// 4, 8 or 16 bytes, else (one bf16 channel, 2 bytes) a plain copy.
template <typename T, int VEC>
__device__ __forceinline__ void stage_cell(T* dst, const T* src) {
  constexpr int kBytes = static_cast<int>(sizeof(T)) * VEC;
  if constexpr (kBytes == 4 || kBytes == 8 || kBytes == 16) {
    cp_async<kBytes>(dst, src);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) dst[v] = src[v];
  }
}

// -- the forward --------------------------------------------------------------

constexpr int kFwdThreads = 32;  // a forward block: one warp, VEC channels a thread
constexpr int kFwdVec = 4;       // channels a thread on the vector path (16 B fp32, 8 B bf16)
constexpr int kFwdMaxP = 7;      // bins a side that the forward's registers hold
constexpr int kFwdMaxSamples = 32;  // P x sr at most: one lane a sample builds the plan
constexpr int kFwdCap = 3;          // staged cells: kFwdCap x P x sr
constexpr int kFwdMaxSlots = 7;  // staged tap rows at most: 1 computed, up to 6 in flight

// One sample of one axis in a RoI's read plan: its low and high taps'
// places among the axis's distinct taps (times `stride`: element offsets
// into a staged row on the x axis) and their weights.
struct __align__(16) SamplePlan {
  int lo, hi;
  float w_lo, w_hi;
};

// Builds the plan of one axis with one lane a sample (S <= 32): the
// distinct taps in increasing order into tap[0 .. n - 1] (n <= 2 S), each
// sample's SamplePlan into sp[s]; returns n.  The clamped sample
// coordinate does not decrease with the sample index (see axis_span), so in
// the sequence lo_0, hi_0, lo_1, hi_1, ... a tap is new exactly when it
// exceeds hi of the sample before (and hi_s != lo_s for a high tap), the
// new taps come in increasing order, and a tap that is not new is lo or hi
// of the sample before.  A sample's low tap's place is the count of new
// taps up to it, less one, and less hi_{s-1} where that lies above lo_s;
// its high tap follows it (or is it, clamped at the edge).
__device__ __forceinline__ int build_axis_plan(float start, float bin, int p, int sr, int dim,
                                               int stride, int* tap, SamplePlan* sp) {
  const int lane = threadIdx.x & 31;
  const bool active = lane < p * sr;
  Taps t = {0, 0, 0.f, 0.f};
  if (active) t = axis_taps(start, bin, lane, sr, dim);
  const int prev_hi = __shfl_up_sync(0xffffffffu, t.hi, 1);
  const bool new_lo = active && (lane == 0 || t.lo > prev_hi);
  const bool new_hi = active && t.hi != t.lo && (lane == 0 || t.hi > prev_hi);
  const unsigned los = __ballot_sync(0xffffffffu, new_lo);
  const unsigned his = __ballot_sync(0xffffffffu, new_hi);
  const unsigned below = (1u << lane) - 1u;
  const int before = __popc(los & below) + __popc(his & below);
  if (new_lo) tap[before] = t.lo;
  if (new_hi) tap[before + new_lo] = t.hi;
  if (active) {
    const int il = before + new_lo - 1 - (lane > 0 && prev_hi > t.lo);
    sp[lane] = SamplePlan{il * stride, (il + (t.hi != t.lo)) * stride, t.w_lo, t.w_hi};
  }
  return __popc(los) + __popc(his);
}

// The forward block's dynamic shared memory: the ring of staged tap rows
// (kFwdCap x S cells; kFwdThreads x VEC channels a cell), the x and y
// SamplePlans, then the x and y distinct taps.
size_t fwd_smem_bytes(int p, int sr, int vec, size_t elem) {
  const size_t samples = static_cast<size_t>(p) * sr;
  return kFwdCap * samples * kFwdThreads * vec * elem + 2 * samples * sizeof(SamplePlan) +
         4 * samples * sizeof(int);
}

// Row `y` of the map: this thread's channels of the cells at the nx
// distinct tap columns, into a ring slot.
template <typename T, int VEC>
__device__ __forceinline__ void stage_row(T* ring_slot, const T* fb, int y, const int* xtap, int nx,
                                          int w, int c) {
  const T* src = fb + (size_t)y * w * c;
  for (int j = 0; j < nx; ++j) {
    stage_cell<T, VEC>(ring_slot + j * (kFwdThreads * VEC), src + (size_t)xtap[j] * c);
  }
}

// A staged tap row interpolated at the x-samples and summed per bin column:
// x[pw] = sum over bin pw's samples of (w_lo F[lo] + w_hi F[hi]), two
// chained FMAs a tap pair (written out: `x += a * b + c * d` compiles to a
// multiply, an FMA and an add).  P_ and SR_ are P and sr where fixed at
// compile time (0: read p and sr).
template <typename T, int VEC, int P_, int SR_>
__device__ __forceinline__ void row_bins(const T* ring_slot, const SamplePlan* xs, int p, int sr,
                                         float (&x)[kFwdMaxP][VEC]) {
  const int np = P_ ? P_ : p;
  const int nsr = SR_ ? SR_ : sr;
#pragma unroll
  for (int pw = 0; pw < kFwdMaxP; ++pw) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) x[pw][v] = 0.f;
    if (pw >= np) continue;
#pragma unroll
    for (int ix = 0; ix < (SR_ ? SR_ : 1); ++ix) {
      for (int jx = ix; jx < nsr; jx += (SR_ ? SR_ : 1)) {
        const SamplePlan sp = xs[pw * nsr + jx];
        float lo[VEC], hi[VEC];
        VecIO<T, VEC>::load(ring_slot + sp.lo, lo);
        VecIO<T, VEC>::load(ring_slot + sp.hi, hi);
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[pw][v] = fmaf(sp.w_hi, hi[v], fmaf(sp.w_lo, lo[v], x[pw][v]));
      }
    }
  }
}

// Resident forward blocks an SM is built for: bf16 blocks fit 16 at 128
// registers a thread; float32 blocks, with twice the staging, fit 12 at
// up to 168 registers (capping them at 128 measured slower).
template <typename T>
struct FwdOccupancy {
  static constexpr int kBlocks = sizeof(T) == 2 ? 16 : 12;
};

// The forward's body, shared by the single-level and the multiscale
// forward: one RoI's (P, P) bins of the block's channel slice, VEC
// consecutive channels a thread, from frame map `fb` (h, w, c) into the
// RoI's output `ob` (P, P, c), at the RoI's box on that map.  The warp
// builds the RoI's read plan, a lane a sample; then each thread stages and
// reads only its own channels of each cell, so no barrier follows.  The
// y-samples are walked in order with the two newest computed rows' bin
// sums in registers (a sample's taps are the newest row and the one before
// it, or the newest twice); a row is staged `ahead` rows before it is
// computed.  Every lane of the warp must call it.  P_ and SR_: as in
// row_bins.
template <typename T, int VEC, int P_, int SR_>
__device__ __forceinline__ void pool_roi_staged(const T* __restrict__ fb, int h, int w, int c,
                                                const RoIBox& box, T* __restrict__ ob, int p,
                                                int sr) {
  extern __shared__ float4 fwd_smem[];
  const int samples = p * sr;
  const int cap = kFwdCap * samples;  // staged cells
  T* ring = reinterpret_cast<T*>(fwd_smem);
  SamplePlan* xs = reinterpret_cast<SamplePlan*>(ring + (size_t)cap * kFwdThreads * VEC);
  SamplePlan* ys = xs + samples;
  int* xtap = reinterpret_cast<int*>(ys + samples);
  int* ytap = xtap + 2 * samples;

  const int t = threadIdx.x;
  const int nx = build_axis_plan(box.x1, box.bin_w, p, sr, w, kFwdThreads * VEC, xtap, xs);
  const int ny = build_axis_plan(box.y1, box.bin_h, p, sr, h, 1, ytap, ys);
  __syncwarp();
  const int c0 = (blockIdx.y * kFwdThreads + t) * VEC;
  if (c0 >= c) return;
  const int slots = min(kFwdMaxSlots, cap / nx);  // >= 1
  const int ahead = slots - 1;
  fb += c0;
  ob += c0;
  T* mine = ring + t * VEC;
  const int row_elems = nx * kFwdThreads * VEC;

  for (int k = 0; k < ahead; ++k) {
    if (k < ny) stage_row<T, VEC>(mine + k * row_elems, fb, ytap[k], xtap, nx, w, c);
    cp_async_commit();
  }
  float acc[kFwdMaxP][VEC], prev[kFwdMaxP][VEC], last[kFwdMaxP][VEC];
#pragma unroll
  for (int pw = 0; pw < kFwdMaxP; ++pw) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[pw][v] = prev[pw][v] = last[pw][v] = 0.f;
  }
  // the mean over sr x sr samples: a product where the count is a power of
  // two (exactly the quotient), else the quotient
  const int count = sr * sr;
  const bool count_pow2 = (count & (count - 1)) == 0;
  const float inv_count = 1.f / static_cast<float>(count);
  int have = -1;  // the newest computed row; its bin sums in last, its predecessor's in prev
  for (int sy = 0; sy < samples; ++sy) {
    const SamplePlan sp = ys[sy];
    while (have < sp.hi) {
      ++have;
      if (ahead == 0) {  // a single slot: stage the row now
        stage_row<T, VEC>(mine, fb, ytap[have], xtap, nx, w, c);
        cp_async_commit();
      }
      // one group was committed for each row staged ahead or computed so
      // far: rows 0 .. have are complete when at most ahead - 1 are pending
      cp_async_wait_at_most(max(ahead - 1, 0));
#pragma unroll
      for (int pw = 0; pw < kFwdMaxP; ++pw) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) prev[pw][v] = last[pw][v];
      }
      row_bins<T, VEC, P_, SR_>(mine + (have % slots) * row_elems, xs, p, sr, last);
      if (ahead > 0) {
        const int next = have + ahead;  // into the slot of row have - 1, read already
        if (next < ny) {
          stage_row<T, VEC>(mine + (next % slots) * row_elems, fb, ytap[next], xtap, nx, w, c);
        }
        cp_async_commit();
      }
    }
    if (sp.lo == have) {  // both taps on the newest row (clamped at the edge)
#pragma unroll
      for (int pw = 0; pw < kFwdMaxP; ++pw) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[pw][v] = fmaf(sp.w_hi, last[pw][v], fmaf(sp.w_lo, last[pw][v], acc[pw][v]));
        }
      }
    } else {
#pragma unroll
      for (int pw = 0; pw < kFwdMaxP; ++pw) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[pw][v] = fmaf(sp.w_hi, last[pw][v], fmaf(sp.w_lo, prev[pw][v], acc[pw][v]));
        }
      }
    }
    if (sy % sr == sr - 1) {  // the bin row is complete
      const int ph = sy / sr;
#pragma unroll
      for (int pw = 0; pw < kFwdMaxP; ++pw) {
        if (pw < p) {
          float o[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            o[v] = count_pow2 ? acc[pw][v] * inv_count : __fdiv_rn(acc[pw][v], count);
          }
          VecIO<T, VEC>::store(ob + (size_t)(ph * p + pw) * c, o);
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[pw][v] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

// Forward.  Grid (B x R, channel slices of kFwdThreads x VEC); block: one
// warp, one RoI, VEC consecutive channels a thread (pool_roi_staged).
template <typename T, int VEC, int P_, int SR_>
__global__ void __launch_bounds__(kFwdThreads, FwdOccupancy<T>::kBlocks)
    roi_align_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                         T* __restrict__ out, int r_per_frame, int h, int w, int c, float scale,
                         int p_arg, int sr_arg, int aligned) {
  const int p = P_ ? P_ : p_arg;
  const int sr = SR_ ? SR_ : sr_arg;
  const int br = blockIdx.x;  // b * R + r
  const int b = br / r_per_frame;
  const RoIBox box = roi_box(rois + (size_t)br * 4, scale, p, aligned);
  pool_roi_staged<T, VEC, P_, SR_>(feat + (size_t)b * h * w * c, h, w, c, box,
                                   out + (size_t)br * p * p * c, p, sr);
}

// A RoI's tap footprint on one axis: the rows (or columns) from the low tap
// of sample 0 to the high tap of sample P * sr - 1.  The clamped sample
// coordinate is non-decreasing in the sample index (bin >= 0 and every step
// rounds monotonically), so lo and hi = min(lo + 1, dim - 1) are too, and
// no tap of the RoI lies outside [lo, hi].
__device__ __forceinline__ void axis_span(float start, float bin, int p, int sr, int dim,
                                          int* lo, int* hi) {
  *lo = axis_taps(start, bin, 0, sr, dim).lo;
  *hi = axis_taps(start, bin, p * sr - 1, sr, dim).hi;
}

constexpr int kBwdTileH = 2;  // a single-level backward block owns kBwdTileH x kBwdTileW cells
constexpr int kBwdTileW = 4;
constexpr int kBwdThreads = 128;  // threads of a block, VEC channels each
constexpr int kBwdVec = 4;  // channels a thread owns where C and the pointers allow
constexpr int kBwdSub = 16;  // kept RoIs whose tap profiles are built together
// bins of one bin row whose dOut is loaded together: 4 bf16 vectors or 8
// float32 ones (measured: each the faster for its type)
template <typename T>
struct BwdChunk {
  static constexpr int kBins = sizeof(T) == 2 ? 4 : 8;
};

// Threads of a backward block: the channel vectors in whole warps, at
// most kBwdThreads.
int bwd_threads(int vectors) {
  return vectors < kBwdThreads ? ((vectors + 31) / 32) * 32 : kBwdThreads;
}

// The backward block's dynamic shared memory, in this order: the kept
// RoIs' boxes and indices (threads each: one chunk of the frame's RoIs);
// for kBwdSub kept RoIs, the dense tap profiles of every bin row over the
// tile's rows and of every bin column over its columns (summed weights,
// P x (tile_h + tile_w) floats), and each RoI's range of bins whose
// profile is not zero (ph0, ph1, pw0, pw1).
size_t bwd_smem_bytes(int threads, int p, int tile_h, int tile_w) {
  return (size_t)threads * (sizeof(RoIBox) + sizeof(int)) +
         (size_t)kBwdSub * p * (tile_h + tile_w) * sizeof(float) +
         (size_t)kBwdSub * 4 * sizeof(int);
}

// Bin `bin`'s summed tap weights on one axis over the tile's cells
// t0 .. t0 + N - 1 (zero where no tap lands).  Zero-weight taps (a
// coordinate clamped to the edge, or on a cell) add nothing and are
// skipped.  Returns whether a weight is not zero.
template <int N>
__device__ __forceinline__ bool bin_profile(float start, float bin_size, int bin, int sr, int dim,
                                            int t0, float* out) {
  float wt[N];
#pragma unroll
  for (int i = 0; i < N; ++i) wt[i] = 0.f;
  bool any = false;
  for (int s = 0; s < sr; ++s) {
    const Taps tp = axis_taps(start, bin_size, bin * sr + s, sr, dim);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (tp.w_lo != 0.f && tp.lo == t0 + i) wt[i] = __fadd_rn(wt[i], tp.w_lo);
      if (tp.w_hi != 0.f && tp.hi == t0 + i) wt[i] = __fadd_rn(wt[i], tp.w_hi);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    out[i] = wt[i];
    any |= wt[i] != 0.f;
  }
  return any;
}

constexpr float kCanonicalScale = 224.f;  // the LevelMapper's, at level 4

// The RoI's level index 0..3 (p2..p5) in the multiscale kernels (see the
// multiscale section below).
__device__ __forceinline__ int roi_level(const float* roi) {
  const float area = fmaxf(__fmul_rn(__fsub_rn(roi[2], roi[0]), __fsub_rn(roi[3], roi[1])), 1e-6f);
  const float x = __fadd_rn(__fdiv_rn(__fsqrt_rn(area), kCanonicalScale), 1e-6f);
  return (x >= 0.5f) + (x >= 1.f) + (x >= 2.f);
}

// The pyramid of the multiscale kernels (see the multiscale section below);
// the single-level backward's first pass takes its map as level 0.
constexpr int kLevels = 4;

// The multiscale backward's tiles, measured at the FPN training shapes:
// kMsFineH x kMsTileW cells on p2 and p3 (many cells, few RoIs a cell: fewer
// blocks that find nothing), kMsCoarseH x kMsTileW on p4 and p5 (few cells,
// many RoIs a cell: more blocks to share them).
constexpr int kMsSplit = 2, kMsFineH = 4, kMsCoarseH = 2, kMsTileW = 4;
__host__ __device__ constexpr int ms_tile_h(int lvl) { return lvl < kMsSplit ? kMsFineH : kMsCoarseH; }

// The pyramid, by value in the kernel's parameters.
struct Pyramid {
  const void* feat[kLevels];  // forward: the maps, NHWC
  void* grad[kLevels];        // backward: the maps' gradients, NHWC
  int h[kLevels], w[kLevels];
  float scale[kLevels];       // 1 / stride
  int tiles_x[kLevels];       // backward: tiles a row of the level's map
  int tiles[kLevels];         // backward: tiles of one frame's map
  int first_tile[kLevels];    // backward: the level's first flat tile index
};

// a[i] without indexing the parameter space dynamically (no local copy).
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[kLevels], int i) {
  V v = a[0];
#pragma unroll
  for (int k = 1; k < kLevels; ++k) {
    if (i == k) v = a[k];
  }
  return v;
}

// A RoI's cull data for the backward, on the map it pools from: its box
// and its tap footprint, rows ylo..yhi and columns xlo..xhi (axis_span).
struct RoIFootprint {
  RoIBox box;
  int ylo, yhi, xlo, xhi;
};

// The backwards' scratch, carved from one buffer: each RoI's footprint
// (B x R), and per frame and level the RoIs on it in RoI order (B x L x
// R) and their count (B x L).
struct BwdScratch {
  RoIFootprint* fp;
  int* order;
  int* count;
};

size_t bwd_scratch_bytes(int b, int r, int levels) {
  return (size_t)b * r * sizeof(RoIFootprint) + (size_t)b * levels * (r + 1) * sizeof(int);
}

BwdScratch bwd_scratch(void* base, int b, int r, int levels) {
  BwdScratch sc;
  sc.fp = static_cast<RoIFootprint*>(base);
  sc.order = reinterpret_cast<int*>(sc.fp + (size_t)b * r);
  sc.count = sc.order + (size_t)b * levels * r;
  return sc;
}

// The backwards' first pass: one warp a frame computes each RoI's level
// (roi_level where `levels` is 4, else level 0, the single map), its box
// and footprint on that level's map, and lists the frame's RoIs by level
// in RoI order, so a tile walks only its level's RoIs and culls each by
// four comparisons.
__global__ void roi_bucket_kernel(Pyramid pyr, int levels, const float* __restrict__ rois,
                                  int r_per_frame, int p, int sr, int aligned, BwdScratch sc) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  int* order = sc.order + (size_t)b * levels * r_per_frame;
  int counts[kLevels] = {0, 0, 0, 0};
  for (int base = 0; base < r_per_frame; base += 32) {
    const int r = base + lane;
    int lvl = -1;
    if (r < r_per_frame) {
      const float* roi = rois + ((size_t)b * r_per_frame + r) * 4;
      lvl = levels == kLevels ? roi_level(roi) : 0;
      const int h = pick(pyr.h, lvl), w = pick(pyr.w, lvl);
      RoIFootprint f;
      f.box = roi_box(roi, pick(pyr.scale, lvl), p, aligned);
      axis_span(f.box.y1, f.box.bin_h, p, sr, h, &f.ylo, &f.yhi);
      axis_span(f.box.x1, f.box.bin_w, p, sr, w, &f.xlo, &f.xhi);
      sc.fp[(size_t)b * r_per_frame + r] = f;
    }
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      const unsigned on = __ballot_sync(0xffffffffu, lvl == l);
      if (lvl == l) order[l * r_per_frame + counts[l] + __popc(on & ((1u << lane) - 1u))] = r;
      counts[l] += __popc(on);
    }
  }
  if (lane < levels) sc.count[b * levels + lane] = pick(counts, lane);
}

// The backward's tile body, shared by the single-level and the multiscale
// backward: the gradient of frame b's (h, w, c) map `grad_b` on the tile
// of TH x TW cells at (ty0, tx0), for VEC consecutive
// channels from ch a thread (none where ch >= c), the tile's sums in
// registers.  It walks the n RoIs of `order` (the frame's RoIs on this
// map, from roi_bucket_kernel) and keeps those whose footprint meets the
// tile; a kept RoI adds sum_ph wy_ph (x) (sum_pw g[ph, pw] wx_pw), the bin
// rows' and columns' dense profiles factoring the bilinear weights.  Every
// cell of the tile is written, in T.
template <typename T, int VEC, int TH, int TW>
__device__ __forceinline__ void gather_tile(const T* __restrict__ grad_out,
                                            const RoIFootprint* __restrict__ fp,
                                            const int* __restrict__ order, int n,
                                            T* __restrict__ grad_b, int b, int r_per_frame,
                                            int ty0, int tx0, int ch, int h, int w, int c,
                                            int p, int sr) {
  constexpr int kChunk = BwdChunk<T>::kBins;
  extern __shared__ float4 bwd_smem[];
  __shared__ int warp_kept[32];
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  RoIBox* kept_box = reinterpret_cast<RoIBox*>(bwd_smem);
  int* kept_roi = reinterpret_cast<int*>(kept_box + nt);
  float* prof_y = reinterpret_cast<float*>(kept_roi + nt);  // [kBwdSub][p][TH]
  float* prof_x = prof_y + kBwdSub * p * TH;                // [kBwdSub][p][TW]
  int* range = reinterpret_cast<int*>(prof_x + kBwdSub * p * TW);  // [kBwdSub][4]

  const int ty1 = min(ty0 + TH, h) - 1;
  const int tx1 = min(tx0 + TW, w) - 1;
  const bool has_ch = ch < c;
  const int lane = t & 31, warp = t >> 5;
  const float inv_samples = __fdiv_rn(1.f, static_cast<float>(sr * sr));

  float acc[TH][TW][VEC];
#pragma unroll
  for (int a = 0; a < TH; ++a) {
#pragma unroll
    for (int e = 0; e < TW; ++e) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[a][e][v] = 0.f;
    }
  }

  for (int base = 0; base < n; base += nt) {
    // keep, in RoI order, the chunk's RoIs whose footprint meets the tile
    bool meets = false;
    RoIBox box;
    int r = 0;
    if (base + t < n) {
      r = order[base + t];
      const RoIFootprint f = fp[(size_t)b * r_per_frame + r];
      box = f.box;
      meets = f.ylo <= ty1 && f.yhi >= ty0 && f.xlo <= tx1 && f.xhi >= tx0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, kept = 0;
    for (int k = 0; k < nt / 32; ++k) {
      before += k < warp ? warp_kept[k] : 0;
      kept += warp_kept[k];
    }
    if (meets) {
      const int at = before + __popc(ballot & ((1u << lane) - 1u));
      kept_box[at] = box;
      kept_roi[at] = r;
    }
    __syncthreads();

    for (int sub = 0; sub < kept; sub += kBwdSub) {
      const int ns = min(kBwdSub, kept - sub);
      // the dense profiles of every bin row and column of ns RoIs
      for (int a = t; a < ns * 2 * p; a += nt) {
        const int k = a / (2 * p), q = a - k * 2 * p;
        const RoIBox& bx = kept_box[sub + k];
        if (q < p) {
          bin_profile<TH>(bx.y1, bx.bin_h, q, sr, h, ty0, prof_y + (k * p + q) * TH);
        } else {
          bin_profile<TW>(bx.x1, bx.bin_w, q - p, sr, w, tx0, prof_x + (k * p + q - p) * TW);
        }
      }
      __syncthreads();
      // each RoI's bins with taps in the tile: a contiguous range each way
      for (int k = t; k < ns; k += nt) {
        int ph0 = p, ph1 = -1, pw0 = p, pw1 = -1;
        for (int q = 0; q < p; ++q) {
          bool ny = false, nx = false;
#pragma unroll
          for (int i = 0; i < TH; ++i) ny |= prof_y[(k * p + q) * TH + i] != 0.f;
#pragma unroll
          for (int i = 0; i < TW; ++i) nx |= prof_x[(k * p + q) * TW + i] != 0.f;
          if (ny) { ph0 = min(ph0, q); ph1 = q; }
          if (nx) { pw0 = min(pw0, q); pw1 = q; }
        }
        range[4 * k] = ph0;
        range[4 * k + 1] = ph1;
        range[4 * k + 2] = pw0;
        range[4 * k + 3] = pw1;
      }
      __syncthreads();
      if (has_ch) {
        for (int k = 0; k < ns; ++k) {
          const int ph0 = range[4 * k], ph1 = range[4 * k + 1];
          const int pw0 = range[4 * k + 2], pw1 = range[4 * k + 3];
          if (ph0 > ph1 || pw0 > pw1) continue;
          const T* go = grad_out + ((size_t)b * r_per_frame + kept_roi[sub + k]) * p * p * c + ch;
          for (int ph = ph0; ph <= ph1; ++ph) {
            // row[e] = sum_pw g[ph, pw] wx_pw[e], over this bin row
            float row[TW][VEC];
#pragma unroll
            for (int e = 0; e < TW; ++e) {
#pragma unroll
              for (int v = 0; v < VEC; ++v) row[e][v] = 0.f;
            }
            for (int pwb = pw0; pwb <= pw1; pwb += kChunk) {
              float g[kChunk][VEC];
#pragma unroll
              for (int q = 0; q < kChunk; ++q) {
#pragma unroll
                for (int v = 0; v < VEC; ++v) g[q][v] = 0.f;
                if (pwb + q <= pw1) VecIO<T, VEC>::load(go + (size_t)(ph * p + pwb + q) * c, g[q]);
              }
#pragma unroll
              for (int q = 0; q < kChunk; ++q) {
                if (pwb + q > pw1) break;
                const float* wx = prof_x + (k * p + pwb + q) * TW;
#pragma unroll
                for (int e = 0; e < TW; ++e) {
                  const float we = wx[e];
#pragma unroll
                  for (int v = 0; v < VEC; ++v) row[e][v] += g[q][v] * we;
                }
              }
            }
            const float* wy = prof_y + (k * p + ph) * TH;
#pragma unroll
            for (int a = 0; a < TH; ++a) {
              const float wa = wy[a] * inv_samples;
#pragma unroll
              for (int e = 0; e < TW; ++e) {
#pragma unroll
                for (int v = 0; v < VEC; ++v) acc[a][e][v] += wa * row[e][v];
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (!has_ch) return;
#pragma unroll
  for (int a = 0; a < TH; ++a) {
#pragma unroll
    for (int e = 0; e < TW; ++e) {
      if (ty0 + a < h && tx0 + e < w) {
        VecIO<T, VEC>::store(grad_b + ((size_t)(ty0 + a) * w + tx0 + e) * c + ch, acc[a][e]);
      }
    }
  }
}

// Backward: the gradient with respect to the features (the RoIs get none).
// Grid (tiles of the map, channel slices, frames); block: VEC consecutive
// channels of the slice a thread.  After roi_bucket_kernel (one level).
template <typename T, int VEC>
__global__ void roi_align_bwd_kernel(const T* __restrict__ grad_out, BwdScratch sc,
                                     T* __restrict__ grad_feat, int r_per_frame, int h, int w,
                                     int c, int p, int sr, int tiles_x) {
  const int b = blockIdx.z;
  gather_tile<T, VEC, kBwdTileH, kBwdTileW>(
      grad_out, sc.fp, sc.order + (size_t)b * r_per_frame, sc.count[b],
      grad_feat + (size_t)b * h * w * c, b, r_per_frame, (blockIdx.x / tiles_x) * kBwdTileH,
      (blockIdx.x % tiles_x) * kBwdTileW, (blockIdx.y * blockDim.x + threadIdx.x) * VEC, h, w, c,
      p, sr);
}

constexpr size_t kMaxSmemBytes = 232448;  // a block's shared memory on sm_90

// Lets `kernel` take `smem` bytes of dynamic shared memory: 0 on success.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmemBytes - 256) return static_cast<int>(cudaErrorInvalidValue);
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem)));
}

// A forward kernel's launch: grid (the B x R RoIs, channel slices of
// kFwdThreads x VEC), one warp a block, the staged body's shared memory.
template <typename T, int VEC, typename Kernel, typename... Args>
int launch_staged(Kernel kernel, long long rois, int c, int p, int sr, cudaStream_t stream,
                  Args... args) {
  const size_t smem = fwd_smem_bytes(p, sr, VEC, sizeof(T));
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(rois), (c / VEC + kFwdThreads - 1) / kFwdThreads);
  kernel<<<grid, kFwdThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The sizes the staged body takes: P bins a side in registers, P x sr
// samples a side (one lane a sample builds the plan).
bool fwd_sizes_ok(int p, int sr) {
  return p >= 1 && p <= kFwdMaxP && sr >= 1 && p * sr <= kFwdMaxSamples;
}

// The forward: P 7 and sr 2 (the detector's) compiled in, others read at
// run time.
template <typename T, int VEC>
int launch(const void* feat, const void* rois, void* out, int b, int h, int w,
           int c, int r, float scale, int p, int sr, int aligned,
           cudaStream_t stream) {
  if (!fwd_sizes_ok(p, sr)) return static_cast<int>(cudaErrorInvalidValue);
  const T* f = static_cast<const T*>(feat);
  const float* boxes = static_cast<const float*>(rois);
  T* o = static_cast<T*>(out);
  const long long n = (long long)b * r;
  if (p == 7 && sr == 2) {
    return launch_staged<T, VEC>(roi_align_fwd_kernel<T, VEC, 7, 2>, n, c, p, sr, stream, f, boxes,
                                 o, r, h, w, c, scale, p, sr, aligned);
  }
  return launch_staged<T, VEC>(roi_align_fwd_kernel<T, VEC, 0, 0>, n, c, p, sr, stream, f, boxes, o,
                               r, h, w, c, scale, p, sr, aligned);
}

// The backwards' first pass into the scratch at `scratch`.
int launch_bucket(const Pyramid& pyr, int levels, const void* rois, int b, int r, int p, int sr,
                  int aligned, void* scratch, cudaStream_t stream) {
  roi_bucket_kernel<<<b, 32, 0, stream>>>(pyr, levels, static_cast<const float*>(rois), r, p, sr,
                                          aligned, bwd_scratch(scratch, b, r, levels));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_bwd_vec(const void* grad_out, const void* rois, void* grad, void* scratch, int b, int h,
                   int w, int c, int r, float scale, int p, int sr, int aligned,
                   cudaStream_t stream) {
  const int vectors = c / VEC;
  const int threads = bwd_threads(vectors);
  const size_t smem = bwd_smem_bytes(threads, p, kBwdTileH, kBwdTileW);
  int err = allow_smem(roi_align_bwd_kernel<T, VEC>, smem);
  if (err != 0) return err;
  Pyramid one = {};
  one.h[0] = h;
  one.w[0] = w;
  one.scale[0] = scale;
  err = launch_bucket(one, 1, rois, b, r, p, sr, aligned, scratch, stream);
  if (err != 0) return err;
  const int tiles_y = (h + kBwdTileH - 1) / kBwdTileH;
  const int tiles_x = (w + kBwdTileW - 1) / kBwdTileW;
  const dim3 grid(tiles_y * tiles_x, (vectors + threads - 1) / threads, b);
  roi_align_bwd_kernel<T, VEC><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(grad_out), bwd_scratch(scratch, b, r, 1), static_cast<T*>(grad), r, h,
      w, c, p, sr, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// kBwdVec channels a thread where C and the pointers (dOut and the n
// gradients) allow, else one.
template <typename T>
bool bwd_vectorized(int c, const void* grad_out, const void* const* grads, int n) {
  const uintptr_t bytes = kBwdVec * sizeof(T);
  bool ok = c % kBwdVec == 0 && reinterpret_cast<uintptr_t>(grad_out) % bytes == 0;
  for (int i = 0; i < n; ++i) ok = ok && reinterpret_cast<uintptr_t>(grads[i]) % bytes == 0;
  return ok;
}

template <typename T>
int launch_bwd(const void* grad_out, const void* rois, void* grad, void* scratch, int b, int h,
               int w, int c, int r, float scale, int p, int sr, int aligned, cudaStream_t stream) {
  const void* grads[1] = {grad};
  if (bwd_vectorized<T>(c, grad_out, grads, 1)) {
    return launch_bwd_vec<T, kBwdVec>(grad_out, rois, grad, scratch, b, h, w, c, r, scale, p, sr,
                                      aligned, stream);
  }
  return launch_bwd_vec<T, 1>(grad_out, rois, grad, scratch, b, h, w, c, r, scale, p, sr, aligned,
                              stream);
}

// -- Multiscale (FPN) RoI align ----------------------------------------------
//
// Replaces: faster_rcnn_pytorch_multimodal_tpu/ops/roi_align.py
// `multiscale_roi_align` and `multiscale_roi_align_batched` (:153-242), and
// their gradient with respect to the four feature maps.  The JAX package
// pools every RoI from every level and keeps the mapped one by mask; here
// each RoI computes its level (torchvision's LevelMapper) and gathers its
// taps from that level only, so the work is one level's, not four.
//
// The pyramid is the one the detector builds: four maps p2..p5 and the
// LevelMapper's canonical scale 224 at level 4 (the wrapper raises for any
// other).  Level: floor(4 + log2(sqrt(max(area, 1e-6)) / 224 + 1e-6)),
// clipped to 2..5.  floor(4 + log2(x)) >= j exactly when x >= 2^(j - 4), so
// the kernel compares x with 0.5, 1 and 2 instead of taking a log2, and x is
// built with round-to-nearest intrinsics, as the plain twin's float32 ops
// build it: kernel and twin map every RoI to the same level.
//
// What bounds the forward at the FPN serving shapes (B 8, R 300, P 7, C
// 256, bf16): bytes, the 60 MB output (8 x 300 x 49 x 256 x 2 B) and the
// tap rows the RoIs hit on their levels.  It is the single-level forward
// on the RoI's level: a block owns one RoI and one slice of kFwdThreads x
// VEC channels, picks the level by `roi_level`, builds the RoI's box with
// that level's scale, and runs `pool_roi_staged` on that level's map, so
// each tap cell of the RoI is read from L2 once per block and each bin is
// written once.
//
// The backward is the single-level backward's tile gather (`gather_tile`),
// level by level: one grid over the 2 x 4 tiles of the four maps of every
// frame (a flat tile index, each level's first tile a prefix sum of the
// tile counts before it).  A block keeps the frame's RoIs that
// `roi_level` maps to its level and whose footprint on that level meets
// its tile, and writes every cell of its tile once, in the maps' dtype:
// no atomics, no zeroed float32 accumulator, no rounding pass, and the
// same result bit for bit from run to run.

// Forward.  Grid (B x R, channel slices of kFwdThreads x VEC); block: one
// warp, one RoI on its level, VEC consecutive channels a thread.
template <typename T, int VEC, int P_, int SR_>
__global__ void __launch_bounds__(kFwdThreads, FwdOccupancy<T>::kBlocks)
    roi_align_ms_fwd_kernel(Pyramid pyr, const float* __restrict__ rois, T* __restrict__ out,
                            int* __restrict__ levels_out, int r_per_frame, int c, int p_arg,
                            int sr_arg) {
  const int p = P_ ? P_ : p_arg;
  const int sr = SR_ ? SR_ : sr_arg;
  const int br = blockIdx.x;  // b * R + r
  const int b = br / r_per_frame;
  const float* roi = rois + (size_t)br * 4;
  const int lvl = roi_level(roi);
  if (threadIdx.x == 0 && blockIdx.y == 0) levels_out[br] = lvl;
  const int h = pick(pyr.h, lvl);
  const int w = pick(pyr.w, lvl);
  const RoIBox box = roi_box(roi, pick(pyr.scale, lvl), p, 0);
  const T* fb = static_cast<const T*>(pick(pyr.feat, lvl)) + (size_t)b * h * w * c;
  pool_roi_staged<T, VEC, P_, SR_>(fb, h, w, c, box, out + (size_t)br * p * p * c, p, sr);
}

// Backward: the maps' gradients.  Grid (the tiles of every level and
// frame, flat; channel slices); block: one tile of one level's map of one
// frame, VEC consecutive channels of the slice a thread.
template <typename T, int VEC>
__global__ void roi_align_ms_bwd_kernel(Pyramid pyr, const T* __restrict__ grad_out, BwdScratch sc,
                                        int r_per_frame, int c, int p, int sr) {
  const int flat = blockIdx.x;
  int lvl = kLevels - 1;  // the coarsest level's tiles, the longest, come first
#pragma unroll
  for (int k = kLevels - 2; k >= 0; --k) lvl -= flat >= pyr.first_tile[k];
  const int h = pick(pyr.h, lvl);
  const int w = pick(pyr.w, lvl);
  const int tiles = pick(pyr.tiles, lvl);
  const int tiles_x = pick(pyr.tiles_x, lvl);
  const int local = flat - pick(pyr.first_tile, lvl);
  const int b = local / tiles;
  const int tile = local - b * tiles;
  const int list = b * kLevels + lvl;
  const int* order = sc.order + (size_t)list * r_per_frame;
  T* grad_b = static_cast<T*>(pick(pyr.grad, lvl)) + (size_t)b * h * w * c;
  const int tx0 = (tile % tiles_x) * kMsTileW;
  const int ch = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (lvl < kMsSplit) {
    gather_tile<T, VEC, kMsFineH, kMsTileW>(grad_out, sc.fp, order, sc.count[list], grad_b, b,
                                            r_per_frame, (tile / tiles_x) * kMsFineH, tx0, ch, h,
                                            w, c, p, sr);
  } else {
    gather_tile<T, VEC, kMsCoarseH, kMsTileW>(grad_out, sc.fp, order, sc.count[list], grad_b, b,
                                              r_per_frame, (tile / tiles_x) * kMsCoarseH, tx0, ch,
                                              h, w, c, p, sr);
  }
}

// The per-level geometry from the host arrays; false on an empty map.
bool make_pyramid(Pyramid* pyr, const int* heights, const int* widths, const float* scales) {
  *pyr = Pyramid{};
  for (int l = 0; l < kLevels; ++l) {
    if (heights[l] < 1 || widths[l] < 1) return false;
    pyr->h[l] = heights[l];
    pyr->w[l] = widths[l];
    pyr->scale[l] = scales[l];
  }
  return true;
}

// The multiscale forward: P 7 and sr 2 compiled in, others read at run time.
template <typename T, int VEC>
int launch_ms_fwd(const Pyramid& pyr, const void* rois, void* out, void* levels_out, int b,
                  int c, int r, int p, int sr, cudaStream_t stream) {
  if (!fwd_sizes_ok(p, sr)) return static_cast<int>(cudaErrorInvalidValue);
  const float* boxes = static_cast<const float*>(rois);
  T* o = static_cast<T*>(out);
  int* lv = static_cast<int*>(levels_out);
  const long long n = (long long)b * r;
  if (p == 7 && sr == 2) {
    return launch_staged<T, VEC>(roi_align_ms_fwd_kernel<T, VEC, 7, 2>, n, c, p, sr, stream, pyr,
                                 boxes, o, lv, r, c, p, sr);
  }
  return launch_staged<T, VEC>(roi_align_ms_fwd_kernel<T, VEC, 0, 0>, n, c, p, sr, stream, pyr,
                               boxes, o, lv, r, c, p, sr);
}

template <typename T, int VEC>
int launch_ms_bwd_vec(Pyramid pyr, const void* grad_out, const void* rois, void* scratch, int b,
                      int c, int r, int p, int sr, cudaStream_t stream) {
  long long total = 0;
  for (int k = 0; k < kLevels; ++k) {
    const int l = kLevels - 1 - k;
    pyr.tiles_x[l] = (pyr.w[l] + kMsTileW - 1) / kMsTileW;
    pyr.tiles[l] = ((pyr.h[l] + ms_tile_h(l) - 1) / ms_tile_h(l)) * pyr.tiles_x[l];
    pyr.first_tile[l] = static_cast<int>(total);
    total += (long long)b * pyr.tiles[l];
  }
  if (total == 0) return 0;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vectors = c / VEC;
  const int threads = bwd_threads(vectors);
  const size_t smem = bwd_smem_bytes(threads, p, std::max(kMsFineH, kMsCoarseH), kMsTileW);
  int err = allow_smem(roi_align_ms_bwd_kernel<T, VEC>, smem);
  if (err != 0) return err;
  err = launch_bucket(pyr, kLevels, rois, b, r, p, sr, 0, scratch, stream);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(total), (vectors + threads - 1) / threads);
  roi_align_ms_bwd_kernel<T, VEC><<<grid, threads, smem, stream>>>(
      pyr, static_cast<const T*>(grad_out), bwd_scratch(scratch, b, r, kLevels), r, c, p, sr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ms_bwd(const Pyramid& pyr, const void* grad_out, const void* rois, void* scratch, int b,
                  int c, int r, int p, int sr, cudaStream_t stream) {
  if (bwd_vectorized<T>(c, grad_out, pyr.grad, kLevels)) {
    return launch_ms_bwd_vec<T, kBwdVec>(pyr, grad_out, rois, scratch, b, c, r, p, sr, stream);
  }
  return launch_ms_bwd_vec<T, 1>(pyr, grad_out, rois, scratch, b, c, r, p, sr, stream);
}

}  // namespace

// features: (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1), contiguous.
// rois: (B, R, 4) float32.  out: (B, R, P, P, C) in the features' dtype,
// not empty; P at most kFwdMaxP (7), P x sr at most 32.  vectorized != 0
// selects 4-channel vectors (16 bytes float32, 8 bfloat16); the caller sets
// it only when C is a multiple of 16 bytes' channels and every pointer is
// 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int frcnn_roi_align_fwd(const void* features, const void* rois,
                                   void* out, int dtype, int vectorized, int b,
                                   int h, int w, int c, int r,
                                   float spatial_scale, int p, int sr,
                                   int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vectorized
               ? launch<float, kFwdVec>(features, rois, out, b, h, w, c, r, spatial_scale, p, sr, aligned, s)
               : launch<float, 1>(features, rois, out, b, h, w, c, r, spatial_scale, p, sr, aligned, s);
  }
  if (dtype == 1) {
    return vectorized
               ? launch<__nv_bfloat16, kFwdVec>(features, rois, out, b, h, w, c, r, spatial_scale, p, sr, aligned, s)
               : launch<__nv_bfloat16, 1>(features, rois, out, b, h, w, c, r, spatial_scale, p, sr, aligned, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bytes of the scratch buffer the backward entries take: B frames, R
// RoIs a frame, `levels` maps (1 single-level, 4 multiscale).
extern "C" long long frcnn_roi_align_bwd_scratch_bytes(int b, int r, int levels) {
  return static_cast<long long>(bwd_scratch_bytes(b, r, levels));
}

// grad_out: (B, R, P, P, C) in the features' dtype (0 float32, 1 bfloat16).
// grad_features: (B, H, W, C) in the same dtype, not empty; every element
// is written (no zeroing needed), all 0 when R is 0.  scratch: device
// memory of frcnn_roi_align_bwd_scratch_bytes(B, R, 1) bytes, 16-byte
// aligned.  Returns cudaGetLastError() after the launches (0 on success).
extern "C" int frcnn_roi_align_bwd(const void* grad_out, const void* rois, void* grad_features,
                                   void* scratch, int dtype, int b, int h, int w, int c, int r,
                                   float spatial_scale, int p, int sr, int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(grad_out, rois, grad_features, scratch, b, h, w, c, r, spatial_scale,
                             p, sr, aligned, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(grad_out, rois, grad_features, scratch, b, h, w, c, r,
                                     spatial_scale, p, sr, aligned, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Multiscale forward.  features: 4 pointers to (B, H_l, W_l, C) maps,
// p2..p5, float32 (dtype 0) or bfloat16 (dtype 1), contiguous; heights,
// widths, scales (1 / stride): 4 values each, host memory.  rois: (B, R, 4)
// float32.  out: (B, R, P, P, C) in the features' dtype.  levels_out: (B, R)
// int32, each RoI's level index 0..3.  P at most kFwdMaxP (7), P x sr at
// most 32.  vectorized != 0 selects 4-channel vectors, as in
// frcnn_roi_align_fwd (C a multiple of 16 bytes' channels, every map and
// the output 16-byte aligned).  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int frcnn_roi_align_ms_fwd(const void* const* features, const int* heights,
                                      const int* widths, const float* scales, const void* rois,
                                      void* out, void* levels_out, int dtype, int vectorized,
                                      int b, int c, int r, int p, int sr, void* stream) {
  Pyramid pyr;
  if (!make_pyramid(&pyr, heights, widths, scales)) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < kLevels; ++l) pyr.feat[l] = features[l];
  if (b * r == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vectorized
               ? launch_ms_fwd<float, kFwdVec>(pyr, rois, out, levels_out, b, c, r, p, sr, s)
               : launch_ms_fwd<float, 1>(pyr, rois, out, levels_out, b, c, r, p, sr, s);
  }
  if (dtype == 1) {
    return vectorized
               ? launch_ms_fwd<__nv_bfloat16, kFwdVec>(pyr, rois, out, levels_out, b, c, r, p, sr, s)
               : launch_ms_fwd<__nv_bfloat16, 1>(pyr, rois, out, levels_out, b, c, r, p, sr, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Multiscale backward.  grad_out: (B, R, P, P, C) in the features' dtype
// (0 float32, 1 bfloat16).  grads: 4 pointers to the (B, H_l, W_l, C) maps'
// gradients, p2..p5, in the same dtype; every element is written (no
// zeroing needed), all 0 when R is 0.  scratch: device memory of
// frcnn_roi_align_bwd_scratch_bytes(B, R, 4) bytes, 16-byte aligned.
// heights, widths, scales: as in the forward.  Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int frcnn_roi_align_ms_bwd(const void* grad_out, const void* rois,
                                      void* const* grads, void* scratch, const int* heights,
                                      const int* widths, const float* scales, int dtype, int b,
                                      int c, int r, int p, int sr, void* stream) {
  Pyramid pyr;
  if (!make_pyramid(&pyr, heights, widths, scales)) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < kLevels; ++l) pyr.grad[l] = grads[l];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_ms_bwd<float>(pyr, grad_out, rois, scratch, b, c, r, p, sr, s);
  if (dtype == 1) {
    return launch_ms_bwd<__nv_bfloat16>(pyr, grad_out, rois, scratch, b, c, r, p, sr, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
