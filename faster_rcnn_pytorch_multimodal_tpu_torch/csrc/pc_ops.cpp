// Host-side point-cloud ops (C++), the native runtime component of the
// data pipeline.  The reference relied on third-party native code for this
// layer (spconv's C++/CUDA voxelizer + numpy loops,
// ref lib/roi_data_layer/minibatch.py:237-457); here the on-device
// voxelization is XLA (ops/voxelize.py) and the remaining HOST hot path —
// per-frame range filtering and geometric augmentation over ~200k points —
// is this library, exposed over a C ABI for ctypes.
//
// All functions operate in-place on an interleaved float32 buffer of
// `n` points with `stride` floats per point (x, y, z first), and return
// the new point count when they compact the buffer.
//
// RNG: xorshift128+ seeded per call — deterministic given (seed).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct XorShift128 {
  uint64_t s0, s1;
  explicit XorShift128(uint64_t seed) {
    // splitmix64 to spread the seed
    auto next = [&seed]() {
      seed += 0x9E3779B97f4A7C15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      return z ^ (z >> 31);
    };
    s0 = next();
    s1 = next();
  }
  uint64_t next() {
    uint64_t x = s0;
    const uint64_t y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  // standard normal (Box-Muller, both outputs of the pair used: one
  // log/sqrt/sincos amortizes over two samples)
  double spare = 0.0;
  bool has_spare = false;
  double normal() {
    if (has_spare) {
      has_spare = false;
      return spare;
    }
    double u1 = uniform(), u2 = uniform();
    if (u1 < 1e-300) u1 = 1e-300;
    const double r = std::sqrt(-2.0 * std::log(u1));
    const double a = 2.0 * M_PI * u2;
    spare = r * std::sin(a);
    has_spare = true;
    return r * std::cos(a);
  }
};

}  // namespace

extern "C" {

// Keep points with x/y/z inside [bounds[0],bounds[1]] x [2],[3] x [4],[5].
// Returns the compacted count.
int pc_range_filter(float* pts, int n, int stride, const float* bounds) {
  int out = 0;
  for (int i = 0; i < n; ++i) {
    const float* p = pts + (int64_t)i * stride;
    if (p[0] >= bounds[0] && p[0] <= bounds[1] && p[1] >= bounds[2] &&
        p[1] <= bounds[3] && p[2] >= bounds[4] && p[2] <= bounds[5]) {
      if (out != i)
        std::memmove(pts + (int64_t)out * stride, p, stride * sizeof(float));
      ++out;
    }
  }
  return out;
}

// Per-point gaussian jitter with per-axis sigmas
// (ref minibatch.py:310-321).
void pc_gauss_distort(float* pts, int n, int stride, const float* sigmas,
                      uint64_t seed) {
  XorShift128 rng(seed);
  for (int i = 0; i < n; ++i) {
    float* p = pts + (int64_t)i * stride;
    p[0] += (float)(rng.normal() * sigmas[0]);
    p[1] += (float)(rng.normal() * sigmas[1]);
    p[2] += (float)(rng.normal() * sigmas[2]);
  }
}

// Random dropout keeping each point with probability p_keep
// (ref minibatch.py:323-327).  Returns new count.
int pc_dropout(float* pts, int n, int stride, float p_keep, uint64_t seed) {
  XorShift128 rng(seed);
  int out = 0;
  for (int i = 0; i < n; ++i) {
    if (rng.uniform() < p_keep) {
      if (out != i)
        std::memmove(pts + (int64_t)out * stride, pts + (int64_t)i * stride,
                     stride * sizeof(float));
      ++out;
    }
  }
  return out;
}

// Rotate x/y around +z by angle (ref minibatch.py:695-713).
void pc_rotate_z(float* pts, int n, int stride, float angle) {
  const float c = std::cos(angle), s = std::sin(angle);
  for (int i = 0; i < n; ++i) {
    float* p = pts + (int64_t)i * stride;
    const float x = p[0], y = p[1];
    p[0] = x * c - y * s;
    p[1] = x * s + y * c;
  }
}

// y -> -y (flip across the x axis, ref minibatch.py:379-388).
void pc_flip_y(float* pts, int n, int stride) {
  for (int i = 0; i < n; ++i) pts[(int64_t)i * stride + 1] *= -1.0f;
}

// x -> -x + x_max (ref minibatch.py:390-395).
void pc_flip_x(float* pts, int n, int stride, float x_max) {
  for (int i = 0; i < n; ++i) {
    float* p = pts + (int64_t)i * stride;
    p[0] = -p[0] + x_max;
  }
}

// swap: x' = y - y_min, y' = x - x_range_mean (ref minibatch.py:354-377).
void pc_swap_xy(float* pts, int n, int stride, float y_min,
                float x_range_mean) {
  for (int i = 0; i < n; ++i) {
    float* p = pts + (int64_t)i * stride;
    const float x = p[0], y = p[1];
    p[0] = y - y_min;
    p[1] = x - x_range_mean;
  }
}

// Physics-based rain simulation (ref minibatch.py:397-421): gaussian range
// noise ~ distance, intensity attenuation exp(-2*alpha*R^beta*z), drop
// returns below the max-range noise floor.  Intensity at float index 3.
// Returns new count.
int pc_rain_sim(float* pts, int n, int stride, float rain_rate,
                float max_range, uint64_t seed) {
  XorShift128 rng(seed);
  const double rho = 0.9 / M_PI;
  const double big_r = std::pow((double)rain_rate, 0.6);
  const double p_min = rho / (M_PI * (double)max_range * max_range);
  const double atten_base = 1.0 - std::exp(-(double)rain_rate);
  int out = 0;
  for (int i = 0; i < n; ++i) {
    float* p = pts + (int64_t)i * stride;
    double z = std::sqrt((double)p[0] * p[0] + (double)p[1] * p[1] +
                         (double)p[2] * p[2]);
    const double sigma = 0.02 * z * atten_base * atten_base;
    const double shift = rng.normal() * sigma;
    z += shift;
    const float s3 = (float)(shift / 3.0);
    p[0] += s3;
    p[1] += s3;
    p[2] += s3;
    const double delta = std::exp(-2.0 * 0.01 * big_r * z);
    const double p_n = (rho / (z * z + 1e-12)) * delta;
    if (stride > 3) p[3] = (float)(p[3] * delta);
    if (p_n >= p_min) {
      if (out != i)
        std::memmove(pts + (int64_t)out * stride, p, stride * sizeof(float));
      ++out;
    }
  }
  return out;
}

// Load a KITTI-style .bin (float32 x,y,z,intensity) — thin wrapper so the
// loader can mmap-read + filter in one native call later.
int pc_version() { return 1; }

}  // extern "C"
