// Single-level RoI align, forward and backward, for Hopper (sm_90a), plain C
// ABI (ctypes).
//
// Replaces: faster_rcnn_pytorch_multimodal_tpu/ops/roi_align.py `roi_align`
// and `roi_align_batched` (with `_sample_coords`), and their gradient with
// respect to the features, which XLA derives by transposing the two einsums
// (ops/roi_align.py:103-118).  The JAX package writes the bilinear sampling
// as two interpolation-matrix einsums because gathers are slow on a TPU; on
// this card the forward is a gather and the backward the matching scatter.
//
// The backward at the training shapes (B 8, R 256, P 7, C 1024) issues
// 8 x 256 x 49 x 16 x 1024 = 1.6e9 float32 atomic adds into a 63 MB
// accumulator while it reads 206 MB of bf16 dOut, so it is bound by the
// atomics' throughput in L2, not by bytes.  The backward therefore gives
// each thread one channel at a time: a warp's 32 atomics then hit 32
// consecutive floats (one 128-byte line), where 16-byte vector lanes as in
// the forward spread them over 4-8 lines and ran 4x (float32) to 8x
// (bfloat16) slower on the card.  Merging the repeated taps of a bin, vector
// atomics or a gather formulation per feature cell are the next ways to
// cut it.
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
  const int ph = bin / p;
  const int pw = bin % p;

  const float* roi = rois + (size_t)br * 4;
  const float offset = aligned ? 0.5f : 0.f;
  const float min_size = aligned ? 0.f : 1.f;
  const float x1 = __fsub_rn(__fmul_rn(roi[0], scale), offset);
  const float y1 = __fsub_rn(__fmul_rn(roi[1], scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], scale), offset);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), min_size), static_cast<float>(p));
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), min_size), static_cast<float>(p));
  const float count = static_cast<float>(sr * sr);

  const T* fb = feat + (size_t)b * h * w * c;
  T* ob = out + ((size_t)br * bins + bin) * c;

  for (int c0 = threadIdx.x * VEC; c0 < c; c0 += blockDim.x * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int iy = 0; iy < sr; ++iy) {
      const Taps ty = axis_taps(y1, bin_h, ph * sr + iy, sr, h);
      for (int ix = 0; ix < sr; ++ix) {
        const Taps tx = axis_taps(x1, bin_w, pw * sr + ix, sr, w);
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
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fdiv_rn(acc[k], count);
    VecIO<T, VEC>::store(ob + c0, acc);
  }
}

// Backward: the gradient with respect to the features (the RoIs get none).
// Same grid as the forward, one channel a thread; each bin spreads
// dOut / (sr * sr) over the bilinear taps of its sr x sr samples with float32
// atomics (RED.ADD, the result is unused) into grad_feat.  Taps of
// neighbouring bins and RoIs overlap, so the order of the adds, and the last
// bits of the sum, change from run to run.  Zero-weight taps (a coordinate
// clamped to the edge) are skipped.
template <typename T>
__global__ void roi_align_bwd_kernel(const T* __restrict__ grad_out,
                                     const float* __restrict__ rois,
                                     float* __restrict__ grad_feat,
                                     int r_per_frame, int h, int w, int c,
                                     float scale, int p, int sr, int aligned) {
  const int bins = p * p;
  const int br = blockIdx.x / bins;
  const int bin = blockIdx.x % bins;
  const int b = br / r_per_frame;
  const int ph = bin / p;
  const int pw = bin % p;

  const float* roi = rois + (size_t)br * 4;
  const float offset = aligned ? 0.5f : 0.f;
  const float min_size = aligned ? 0.f : 1.f;
  const float x1 = __fsub_rn(__fmul_rn(roi[0], scale), offset);
  const float y1 = __fsub_rn(__fmul_rn(roi[1], scale), offset);
  const float x2 = __fsub_rn(__fmul_rn(roi[2], scale), offset);
  const float y2 = __fsub_rn(__fmul_rn(roi[3], scale), offset);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), min_size), static_cast<float>(p));
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), min_size), static_cast<float>(p));
  const float count = static_cast<float>(sr * sr);

  float* fb = grad_feat + (size_t)b * h * w * c;
  const T* gb = grad_out + ((size_t)br * bins + bin) * c;

  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float g[1];
    VecIO<T, 1>::load(gb + ch, g);
    const float gs = __fdiv_rn(g[0], count);
    for (int iy = 0; iy < sr; ++iy) {
      const Taps ty = axis_taps(y1, bin_h, ph * sr + iy, sr, h);
      for (int ix = 0; ix < sr; ++ix) {
        const Taps tx = axis_taps(x1, bin_w, pw * sr + ix, sr, w);
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
            atomicAdd(fb + ((size_t)ys[a] * w + xs[e]) * c + ch, wt * gs);
          }
        }
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

template <typename T>
int launch_bwd(const void* grad_out, const void* rois, float* grad_accum, int b,
               int h, int w, int c, int r, float scale, int p, int sr,
               int aligned, cudaStream_t stream) {
  const long long blocks = (long long)b * r * p * p;
  roi_align_bwd_kernel<T><<<static_cast<unsigned>(blocks), threads_for(c, 1), 0, stream>>>(
      static_cast<const T*>(grad_out), static_cast<const float*>(rois),
      grad_accum, r, h, w, c, scale, p, sr, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// features: (B, H, W, C) float32 (dtype 0) or bfloat16 (dtype 1), contiguous.
// rois: (B, R, 4) float32.  out: (B, R, P, P, C) in the features' dtype.
// vectorized != 0 selects 16-byte channel vectors; the caller sets it only
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
// grad_accum: (B, H, W, C) float32, zeroed by the caller; the kernel adds
// the feature gradient into it.  grad_features: (B, H, W, C) bfloat16,
// written from grad_accum when dtype is 1 and ignored when it is 0 (the
// accumulator is then the gradient).  Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int frcnn_roi_align_bwd(const void* grad_out, const void* rois,
                                   void* grad_accum, void* grad_features,
                                   int dtype, int b, int h, int w, int c,
                                   int r, float spatial_scale, int p, int sr,
                                   int aligned, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(grad_accum);
  if (dtype == 0) {
    return launch_bwd<float>(grad_out, rois, acc, b, h, w, c, r, spatial_scale, p, sr, aligned, s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_bwd<__nv_bfloat16>(grad_out, rois, acc, b, h, w, c, r, spatial_scale,
                                            p, sr, aligned, s);
  if (err != 0) return err;
  const size_t n = (size_t)b * h * w * c;
  const int threads = 256;
  size_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535u * 16u) blocks = 65535u * 16u;
  if (blocks == 0) blocks = 1;
  cast_f32_bf16_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      acc, static_cast<__nv_bfloat16*>(grad_features), n);
  return static_cast<int>(cudaGetLastError());
}
