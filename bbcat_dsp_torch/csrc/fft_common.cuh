// Shared-memory FFT pieces of the half-window transforms (K1, K3/K4).
//
// A real transform of n = 2m samples runs as one complex m-point FFT of
// the packed pairs z[j] = x[2j] + i x[2j+1]; real_bin unpacks its bins and
// packed_bin packs a half spectrum back for the inverse.  Twiddles come
// from double precision (sincospi or a host table) and the code is built
// without --use_fast_math.
//
// Shared-memory banks shape the layout.  The stage twiddles lie stage by
// stage, tws[half - 1 + j] = exp(-2 pi i j / 2half) for half = 1, 2, ..,
// m/2 (m - 1 entries), so a warp reads consecutive or equal entries in
// every stage.  The bit-reversed order is met through spread(): a warp's
// 32 consecutive indices map to elements whose bit-reversed positions are
// 32 consecutive slots, so the scatter into (forward, decimation in time)
// and the gather out of (inverse, decimation in frequency) bit-reversed
// order touch every bank once.

#pragma once

#include <cuda_runtime.h>

namespace bbcat {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ int bitrev(int i, int logm) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - logm));
}

// The element a thread handles at loop index idx (0 <= idx < m, m >= 32):
// the lane picks the top five bits, so bitrev(spread(idx)) runs through 32
// consecutive slots across a warp.
__device__ __forceinline__ int spread(int idx, int logm) {
  return ((idx & 31) << (logm - 5)) | (idx >> 5);
}

// In-place radix-2 decimation-in-time FFT of m = 2^logm points in shared
// memory: input in bit-reversed order, output in natural order.  The
// inverse uses conjugate twiddles and is left unscaled.  Ends on a barrier.
__device__ inline void fft_dit(float2* buf, const float2* tws, int m,
                               int logm, bool inverse) {
  for (int s = 1; s <= logm; ++s) {
    const int half = 1 << (s - 1);
    for (int b = threadIdx.x; b < m / 2; b += blockDim.x) {
      const int j = b & (half - 1);
      const int i0 = ((b >> (s - 1)) << s) + j;
      float2 w = tws[half - 1 + j];
      if (inverse) w.y = -w.y;
      const float2 u = buf[i0];
      const float2 v = cmul(buf[i0 + half], w);
      buf[i0] = make_float2(u.x + v.x, u.y + v.y);
      buf[i0 + half] = make_float2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }
}

// In-place radix-2 decimation-in-frequency FFT: input in natural order,
// output in bit-reversed order; otherwise as fft_dit.
__device__ inline void fft_dif(float2* buf, const float2* tws, int m,
                               int logm, bool inverse) {
  for (int s = logm; s >= 1; --s) {
    const int half = 1 << (s - 1);
    for (int b = threadIdx.x; b < m / 2; b += blockDim.x) {
      const int j = b & (half - 1);
      const int i0 = ((b >> (s - 1)) << s) + j;
      float2 w = tws[half - 1 + j];
      if (inverse) w.y = -w.y;
      const float2 u = buf[i0];
      const float2 v = buf[i0 + half];
      buf[i0] = make_float2(u.x + v.x, u.y + v.y);
      buf[i0 + half] = cmul(make_float2(u.x - v.x, u.y - v.y), w);
    }
    __syncthreads();
  }
}

// Bin k (0 <= k <= m) of the real 2m-point transform whose packed complex
// transform Z lies in buf: X[k] = E[k] + exp(-2 pi i k / 2m) O[k], E and O
// the transforms of the even and odd samples, from Z[k] and conj(Z[m-k]).
// twk = exp(-2 pi i k / 2m).  DC and Nyquist come out real.
__device__ __forceinline__ float2 real_bin(const float2* buf, int k, int m,
                                           float2 twk) {
  const float2 zk = buf[k & (m - 1)];
  float2 zc = buf[(m - k) & (m - 1)];
  zc.y = -zc.y;
  const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
  const float2 o = make_float2(0.5f * (zk.y - zc.y), -0.5f * (zk.x - zc.x));
  float2 xk = cmul(twk, o);
  xk.x += e.x;
  xk.y += e.y;
  if (k == 0 || k == m) xk.y = 0.0f;
  return xk;
}

// Packed inverse input Z[k] (0 <= k < m) from the half spectrum bins
// a = X[k] and b = X[m-k] of a real 2m-point signal: Z[k] = E[k] + i O[k],
// E = (X[k] + conj X[m-k]) / 2, O = (X[k] - conj X[m-k]) exp(+2 pi i k/2m)
// / 2.  The unscaled inverse m-point FFT of Z holds the samples
// (y[2j], y[2j+1]) as (re, im), times m.  The imaginary parts of DC and
// Nyquist (k == 0) are dropped, as the inverse of a real transform defines
// them.  twk = exp(-2 pi i k / 2m).
__device__ __forceinline__ float2 packed_bin(float2 a, float2 b, int k,
                                             float2 twk) {
  if (k == 0) {
    a.y = 0.0f;
    b.y = 0.0f;
  }
  b.y = -b.y;
  const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y + b.y));
  const float2 o = cmul(make_float2(0.5f * (a.x - b.x), 0.5f * (a.y - b.y)),
                        make_float2(twk.x, -twk.y));
  return make_float2(e.x - o.y, e.y + o.x);
}

}  // namespace bbcat
