// RoI align, single-level and multiscale (FPN), forward and backward, for
// Hopper (sm_90a), plain C ABI (ctypes).  The multiscale kernels are at the
// end of the anonymous namespace.
//
// Replaces: faster_rcnn_pytorch_multimodal_tpu/ops/roi_align.py `roi_align`
// and `roi_align_batched` (with `_sample_coords`), and their gradient with
// respect to the features, which XLA derives by transposing the two einsums
// (ops/roi_align.py:103-118).  The JAX package writes the bilinear sampling
// as two interpolation-matrix einsums because gathers are slow on a TPU; on
// this card the forward is a gather and the backward the matching scatter.
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
// run.  A block walks only the RoIs whose tap footprint meets its tile
// (`axis_span`).  A bin's weight on cell (y, x) is wy(y) wx(x), the bin
// row's and the bin column's summed tap weights (dense profiles over the
// tile's rows and columns, in shared memory), so a RoI adds
// sum_ph wy_ph (x) (sum_pw g[ph, pw] wx_pw): register FMAs, with shared
// memory touched only for the profiles (sums in shared memory instead, one
// read-modify-write a tap, are bound by shared-memory bandwidth).  The
// tile is written once, in the features' dtype (bf16 rounded in the same
// pass), every cell of it, so the gradient needs no zeroing.
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
// What bounds the forward on the card: bytes.  At the serving shapes (B 8, R 300,
// P 7, C 1024) the output is 8 x 300 x 49 x 1024 x 4 B = 482 MB in float32,
// against 63 MB of features, so the kernel is a store-bound gather.  The
// design: one block per (b, r, bin), threads across channels with 16-byte
// vector loads and stores (4 float32 or 8 bfloat16 channels a thread), so
// each tap is one coalesced row read of C channels and each output bin is
// one coalesced write.  The taps of neighbouring bins hit the same feature
// rows, which the 50 MB L2 holds.
//
// Sample coordinates use round-to-nearest intrinsics so they match the plain
// PyTorch version bit for bit; only the accumulation order differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kMaxThreads = 256;

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
  // start + ((s + 0.5) / sr) * bin, clamped to [0, dim - 1]
  const float frac = __fdiv_rn(__fadd_rn(static_cast<float>(s), 0.5f),
                               static_cast<float>(sr));
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

// Bin (ph, pw) of VEC channels from c0: the mean over its sr x sr samples of
// the bilinear taps into the (h, w, c) map fb.
template <typename T, int VEC>
__device__ __forceinline__ void pool_bin(const T* fb, int h, int w, int c, int c0,
                                         const RoIBox& box, int ph, int pw, int sr,
                                         float (&acc)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int iy = 0; iy < sr; ++iy) {
    const Taps ty = axis_taps(box.y1, box.bin_h, ph * sr + iy, sr, h);
    for (int ix = 0; ix < sr; ++ix) {
      const Taps tx = axis_taps(box.x1, box.bin_w, pw * sr + ix, sr, w);
      const int ys[2] = {ty.lo, ty.hi};
      const int xs[2] = {tx.lo, tx.hi};
      const float wys[2] = {ty.w_lo, ty.w_hi};
      const float wxs[2] = {tx.w_lo, tx.w_hi};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v[VEC];
          VecIO<T, VEC>::load(fb + ((size_t)ys[a] * w + xs[e]) * c + c0, v);
          const float wt = wys[a] * wxs[e];
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += wt * v[k];
        }
      }
    }
  }
  const float count = static_cast<float>(sr * sr);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = __fdiv_rn(acc[k], count);
}

// The transpose of pool_bin for one channel ch (the multiscale backward):
// spreads g / (sr * sr) over the bin's taps with float32 atomics (RED.ADD, the result is unused) into
// the (h, w, c) float32 map gb.  Taps of neighbouring bins and RoIs overlap,
// so the order of the adds, and the last bits of the sum, change from run
// to run.  Zero-weight taps (a coordinate clamped to the edge) are skipped.
__device__ __forceinline__ void scatter_bin(float* gb, int h, int w, int c, int ch,
                                            const RoIBox& box, int ph, int pw, int sr,
                                            float g) {
  const float gs = __fdiv_rn(g, static_cast<float>(sr * sr));
  for (int iy = 0; iy < sr; ++iy) {
    const Taps ty = axis_taps(box.y1, box.bin_h, ph * sr + iy, sr, h);
    for (int ix = 0; ix < sr; ++ix) {
      const Taps tx = axis_taps(box.x1, box.bin_w, pw * sr + ix, sr, w);
      const int ys[2] = {ty.lo, ty.hi};
      const int xs[2] = {tx.lo, tx.hi};
      const float wys[2] = {ty.w_lo, ty.w_hi};
      const float wxs[2] = {tx.w_lo, tx.w_hi};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float wt = wys[a] * wxs[e];
          if (wt == 0.f) continue;
          atomicAdd(gb + ((size_t)ys[a] * w + xs[e]) * c + ch, wt * gs);
        }
      }
    }
  }
}

template <typename T, int VEC>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feat,
                                     const float* __restrict__ rois,
                                     T* __restrict__ out, int r_per_frame,
                                     int h, int w, int c, float scale, int p,
                                     int sr, int aligned) {
  const int bins = p * p;
  const int br = blockIdx.x / bins;  // b * R + r
  const int bin = blockIdx.x % bins;
  const int b = br / r_per_frame;
  const RoIBox box = roi_box(rois + (size_t)br * 4, scale, p, aligned);
  const T* fb = feat + (size_t)b * h * w * c;
  T* ob = out + ((size_t)br * bins + bin) * c;

  for (int c0 = threadIdx.x * VEC; c0 < c; c0 += blockDim.x * VEC) {
    float acc[VEC];
    pool_bin<T, VEC>(fb, h, w, c, c0, box, bin / p, bin % p, sr, acc);
    VecIO<T, VEC>::store(ob + c0, acc);
  }
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

constexpr int kBwdTileH = 2;  // a backward block owns kBwdTileH x kBwdTileW cells
constexpr int kBwdTileW = 4;
constexpr int kBwdThreads = 128;  // threads of a block, VEC channels each
constexpr int kBwdVec = 4;  // channels a thread owns where C and the pointers allow
constexpr int kBwdSub = 16;  // kept RoIs whose tap profiles are built together
constexpr int kBwdChunk = 8;  // bins of one bin row whose dOut is loaded together

// The backward block's dynamic shared memory, in this order: the kept
// RoIs' boxes and indices (threads each: one chunk of the frame's RoIs);
// for kBwdSub kept RoIs, the dense tap profiles of every bin row over the
// tile's rows and of every bin column over its columns (summed weights,
// P x (kBwdTileH + kBwdTileW) floats), and each RoI's range of bins whose
// profile is not zero (ph0, ph1, pw0, pw1).
size_t bwd_smem_bytes(int threads, int p) {
  return (size_t)threads * (sizeof(RoIBox) + sizeof(int)) +
         (size_t)kBwdSub * p * (kBwdTileH + kBwdTileW) * sizeof(float) +
         (size_t)kBwdSub * 4 * sizeof(int);
}

// Bin `bin`'s summed tap weights on one axis over the tile's cells
// t0 .. t0 + N - 1 (zero where no tap lands).  Zero-weight taps (a
// coordinate clamped to the edge, or on a cell) are skipped, as
// scatter_bin skips them.  Returns whether a weight is not zero.
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

// Backward: the gradient with respect to the features (the RoIs get none).
// Grid (tiles of the map, channel slices, frames); block: VEC consecutive
// channels of the slice a thread, the tile's sums for them in registers.
// A kept RoI adds to the tile sum_ph wy_ph (x) (sum_pw g[ph, pw] wx_pw):
// the bin rows' and columns' dense profiles factor the bilinear weights.
// Every cell of the tile is written.
template <typename T, int VEC>
__global__ void roi_align_bwd_kernel(const T* __restrict__ grad_out,
                                     const float* __restrict__ rois,
                                     T* __restrict__ grad_feat,
                                     int r_per_frame, int h, int w, int c,
                                     float scale, int p, int sr, int aligned,
                                     int tiles_x) {
  constexpr int TH = kBwdTileH, TW = kBwdTileW;
  extern __shared__ float4 bwd_smem[];
  __shared__ int warp_kept[32];
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  RoIBox* kept_box = reinterpret_cast<RoIBox*>(bwd_smem);
  int* kept_roi = reinterpret_cast<int*>(kept_box + nt);
  float* prof_y = reinterpret_cast<float*>(kept_roi + nt);  // [kBwdSub][p][TH]
  float* prof_x = prof_y + kBwdSub * p * TH;                // [kBwdSub][p][TW]
  int* range = reinterpret_cast<int*>(prof_x + kBwdSub * p * TW);  // [kBwdSub][4]

  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int ty1 = min(ty0 + TH, h) - 1;
  const int tx1 = min(tx0 + TW, w) - 1;
  const int ch = (blockIdx.y * nt + t) * VEC;
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

  for (int base = 0; base < r_per_frame; base += nt) {
    // keep, in RoI order, the chunk's RoIs whose footprint meets the tile
    const int r = base + t;
    bool meets = false;
    RoIBox box;
    if (r < r_per_frame) {
      box = roi_box(rois + ((size_t)b * r_per_frame + r) * 4, scale, p, aligned);
      int ylo, yhi, xlo, xhi;
      axis_span(box.y1, box.bin_h, p, sr, h, &ylo, &yhi);
      axis_span(box.x1, box.bin_w, p, sr, w, &xlo, &xhi);
      meets = ylo <= ty1 && yhi >= ty0 && xlo <= tx1 && xhi >= tx0;
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
            for (int pwb = pw0; pwb <= pw1; pwb += kBwdChunk) {
              float g[kBwdChunk][VEC];
#pragma unroll
              for (int q = 0; q < kBwdChunk; ++q) {
#pragma unroll
                for (int v = 0; v < VEC; ++v) g[q][v] = 0.f;
                if (pwb + q <= pw1) VecIO<T, VEC>::load(go + (size_t)(ph * p + pwb + q) * c, g[q]);
              }
#pragma unroll
              for (int q = 0; q < kBwdChunk; ++q) {
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
        VecIO<T, VEC>::store(grad_feat + (((size_t)b * h + ty0 + a) * w + tx0 + e) * c + ch,
                             acc[a][e]);
      }
    }
  }
}

// float32 accumulator -> bfloat16 gradient, round to nearest even.
__global__ void cast_f32_bf16_kernel(const float* __restrict__ src,
                                     __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

int threads_for(int c, int vec) {
  const int vectors = c / vec;
  const int threads = ((vectors + 31) / 32) * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

template <typename T, int VEC>
int launch(const void* feat, const void* rois, void* out, int b, int h, int w,
           int c, int r, float scale, int p, int sr, int aligned,
           cudaStream_t stream) {
  const long long blocks = (long long)b * r * p * p;
  roi_align_fwd_kernel<T, VEC><<<static_cast<unsigned>(blocks), threads_for(c, VEC), 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(rois),
      static_cast<T*>(out), r, h, w, c, scale, p, sr, aligned);
  return static_cast<int>(cudaGetLastError());
}

constexpr size_t kMaxSmemBytes = 232448;  // a block's shared memory on sm_90

template <typename T, int VEC>
int launch_bwd_vec(const void* grad_out, const void* rois, void* grad, int b, int h, int w,
                   int c, int r, float scale, int p, int sr, int aligned, cudaStream_t stream) {
  const int vectors = c / VEC;
  const int threads = vectors < kBwdThreads ? ((vectors + 31) / 32) * 32 : kBwdThreads;
  const size_t smem = bwd_smem_bytes(threads, p);
  if (smem > kMaxSmemBytes - 256) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(roi_align_bwd_kernel<T, VEC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_y = (h + kBwdTileH - 1) / kBwdTileH;
  const int tiles_x = (w + kBwdTileW - 1) / kBwdTileW;
  const dim3 grid(tiles_y * tiles_x, (vectors + threads - 1) / threads, b);
  roi_align_bwd_kernel<T, VEC><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(grad_out), static_cast<const float*>(rois), static_cast<T*>(grad),
      r, h, w, c, scale, p, sr, aligned, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// The backward: kBwdVec channels a thread where C and both pointers allow,
// else one.
template <typename T>
int launch_bwd(const void* grad_out, const void* rois, void* grad, int b, int h, int w, int c,
               int r, float scale, int p, int sr, int aligned, cudaStream_t stream) {
  const uintptr_t bytes = kBwdVec * sizeof(T);
  if (c % kBwdVec == 0 && reinterpret_cast<uintptr_t>(grad_out) % bytes == 0 &&
      reinterpret_cast<uintptr_t>(grad) % bytes == 0) {
    return launch_bwd_vec<T, kBwdVec>(grad_out, rois, grad, b, h, w, c, r, scale, p, sr, aligned,
                                      stream);
  }
  return launch_bwd_vec<T, 1>(grad_out, rois, grad, b, h, w, c, r, scale, p, sr, aligned, stream);
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
// What bounds it at the FPN serving shapes (B 8, R 300, P 7, C 256, bf16):
// bytes, the 60 MB output (8 x 300 x 49 x 256 x 2 B) and the tap rows the
// RoIs hit on their levels.  One block per RoI walks the RoI's 49 bins x
// C / VEC channel vectors, so a warp reads 32 consecutive 16-byte vectors of
// one tap row and writes one coalesced bin (at C = 256 bf16 one bin is one warp; the
// single-level layout would give a 32-thread block).  The backward gives a
// thread one channel, so a warp's 32 float32 atomics hit one 128-byte line
// of the mapped level's accumulator (the single-level backward's tile
// gather is not carried over to it yet).

constexpr int kLevels = 4;
constexpr float kCanonicalScale = 224.f;

// The pyramid, by value in the kernel's parameters.
struct Pyramid {
  const void* feat[kLevels];  // forward: the maps, NHWC
  float* grad[kLevels];       // backward: float32 accumulators, NHWC
  int h[kLevels], w[kLevels];
  float scale[kLevels];       // 1 / stride
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

// The RoI's level index 0..3 (p2..p5).
__device__ __forceinline__ int roi_level(const float* roi) {
  const float area = fmaxf(__fmul_rn(__fsub_rn(roi[2], roi[0]), __fsub_rn(roi[3], roi[1])), 1e-6f);
  const float x = __fadd_rn(__fdiv_rn(__fsqrt_rn(area), kCanonicalScale), 1e-6f);
  return (x >= 0.5f) + (x >= 1.f) + (x >= 2.f);
}

template <typename T, int VEC>
__global__ void roi_align_ms_fwd_kernel(Pyramid pyr, const float* __restrict__ rois,
                                        T* __restrict__ out, int* __restrict__ levels_out,
                                        int r_per_frame, int c, int p, int sr) {
  const int br = blockIdx.x;  // b * R + r
  const int b = br / r_per_frame;
  const float* roi = rois + (size_t)br * 4;
  const int lvl = roi_level(roi);
  if (threadIdx.x == 0) levels_out[br] = lvl;
  const int h = pick(pyr.h, lvl);
  const int w = pick(pyr.w, lvl);
  const RoIBox box = roi_box(roi, pick(pyr.scale, lvl), p, 0);
  const T* fb = static_cast<const T*>(pick(pyr.feat, lvl)) + (size_t)b * h * w * c;
  const int nvec = c / VEC;
  T* ob = out + (size_t)br * p * p * c;

  for (int item = threadIdx.x; item < p * p * nvec; item += blockDim.x) {
    const int bin = item / nvec;
    const int c0 = (item - bin * nvec) * VEC;
    float acc[VEC];
    pool_bin<T, VEC>(fb, h, w, c, c0, box, bin / p, bin % p, sr, acc);
    VecIO<T, VEC>::store(ob + (size_t)bin * c + c0, acc);
  }
}

// Backward: scatter_bin into the RoI's level's accumulator, one channel a
// thread.
template <typename T>
__global__ void roi_align_ms_bwd_kernel(Pyramid pyr, const T* __restrict__ grad_out,
                                        const float* __restrict__ rois, int r_per_frame,
                                        int c, int p, int sr) {
  const int br = blockIdx.x;
  const int b = br / r_per_frame;
  const float* roi = rois + (size_t)br * 4;
  const int lvl = roi_level(roi);
  const int h = pick(pyr.h, lvl);
  const int w = pick(pyr.w, lvl);
  const RoIBox box = roi_box(roi, pick(pyr.scale, lvl), p, 0);
  float* gb = pick(pyr.grad, lvl) + (size_t)b * h * w * c;
  const T* go = grad_out + (size_t)br * p * p * c;

  for (int item = threadIdx.x; item < p * p * c; item += blockDim.x) {
    const int bin = item / c;
    float g[1];
    VecIO<T, 1>::load(go + item, g);
    scatter_bin(gb, h, w, c, item - bin * c, box, bin / p, bin % p, sr, g[0]);
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

template <typename T, int VEC>
int launch_ms_fwd(const Pyramid& pyr, const void* rois, void* out, void* levels_out, int b,
                  int c, int r, int p, int sr, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(b * r);
  roi_align_ms_fwd_kernel<T, VEC><<<blocks, threads_for(p * p * c, VEC), 0, stream>>>(
      pyr, static_cast<const float*>(rois), static_cast<T*>(out), static_cast<int*>(levels_out),
      r, c, p, sr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ms_bwd(const Pyramid& pyr, const void* grad_out, const void* rois, int b, int c,
                  int r, int p, int sr, cudaStream_t stream) {
  roi_align_ms_bwd_kernel<T><<<static_cast<unsigned>(b * r), threads_for(p * p * c, 1), 0, stream>>>(
      pyr, static_cast<const T*>(grad_out), static_cast<const float*>(rois), r, c, p, sr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// features: (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1), contiguous.
// rois: (B, R, 4) float32.  out: (B, R, P, P, C) in the features' dtype,
// not empty.  vectorized != 0 selects 16-byte channel vectors; the caller sets it only
// when C is a multiple of the vector width and every pointer is 16-byte
// aligned.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int frcnn_roi_align_fwd(const void* features, const void* rois,
                                   void* out, int dtype, int vectorized, int b,
                                   int h, int w, int c, int r,
                                   float spatial_scale, int p, int sr,
                                   int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vectorized
               ? launch<float, 4>(features, rois, out, b, h, w, c, r, spatial_scale, p, sr, aligned, s)
               : launch<float, 1>(features, rois, out, b, h, w, c, r, spatial_scale, p, sr, aligned, s);
  }
  if (dtype == 1) {
    return vectorized
               ? launch<__nv_bfloat16, 8>(features, rois, out, b, h, w, c, r, spatial_scale, p, sr, aligned, s)
               : launch<__nv_bfloat16, 1>(features, rois, out, b, h, w, c, r, spatial_scale, p, sr, aligned, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// grad_out: (B, R, P, P, C) in the features' dtype (0 float32, 1 bfloat16).
// grad_features: (B, H, W, C) in the same dtype, not empty; every element
// is written (no zeroing needed), all 0 when R is 0.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int frcnn_roi_align_bwd(const void* grad_out, const void* rois, void* grad_features,
                                   int dtype, int b, int h, int w, int c, int r,
                                   float spatial_scale, int p, int sr, int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(grad_out, rois, grad_features, b, h, w, c, r, spatial_scale, p, sr,
                             aligned, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(grad_out, rois, grad_features, b, h, w, c, r, spatial_scale,
                                     p, sr, aligned, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Multiscale forward.  features: 4 pointers to (B, H_l, W_l, C) maps,
// p2..p5, float32 (dtype 0) or bfloat16 (dtype 1), contiguous; heights,
// widths, scales (1 / stride): 4 values each, host memory.  rois: (B, R, 4)
// float32.  out: (B, R, P, P, C) in the features' dtype.  levels_out: (B, R)
// int32, each RoI's level index 0..3.  vectorized != 0 selects 16-byte
// channel vectors (C a multiple of the vector width, every map and the
// output 16-byte aligned).  Returns cudaGetLastError() after the launch (0
// on success).
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
    return vectorized ? launch_ms_fwd<float, 4>(pyr, rois, out, levels_out, b, c, r, p, sr, s)
                      : launch_ms_fwd<float, 1>(pyr, rois, out, levels_out, b, c, r, p, sr, s);
  }
  if (dtype == 1) {
    return vectorized
               ? launch_ms_fwd<__nv_bfloat16, 8>(pyr, rois, out, levels_out, b, c, r, p, sr, s)
               : launch_ms_fwd<__nv_bfloat16, 1>(pyr, rois, out, levels_out, b, c, r, p, sr, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Multiscale backward.  grad_out: (B, R, P, P, C) in the features' dtype.
// accum: one float32 buffer of `total` elements, zeroed by the caller,
// holding the 4 levels' (B, H_l, W_l, C) accumulators at element offsets
// offsets[l]; the kernel adds the feature gradients into it.  grad: a
// bfloat16 buffer of the same layout, written from accum when dtype is 1 and
// ignored when it is 0 (the accumulators are then the gradients).  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int frcnn_roi_align_ms_bwd(const void* grad_out, const void* rois, void* accum,
                                      const long long* offsets, void* grad, long long total,
                                      const int* heights, const int* widths, const float* scales,
                                      int dtype, int b, int c, int r, int p, int sr, void* stream) {
  Pyramid pyr;
  if (!make_pyramid(&pyr, heights, widths, scales)) return static_cast<int>(cudaErrorInvalidValue);
  float* acc = static_cast<float*>(accum);
  for (int l = 0; l < kLevels; ++l) pyr.grad[l] = acc + offsets[l];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b * r > 0) {
    const int err = dtype == 0 ? launch_ms_bwd<float>(pyr, grad_out, rois, b, c, r, p, sr, s)
                               : launch_ms_bwd<__nv_bfloat16>(pyr, grad_out, rois, b, c, r, p, sr, s);
    if (err != 0) return err;
  }
  if (dtype == 0 || total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 16LL) blocks = 65535LL * 16LL;
  cast_f32_bf16_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      acc, static_cast<__nv_bfloat16*>(grad), static_cast<size_t>(total));
  return static_cast<int>(cudaGetLastError());
}
