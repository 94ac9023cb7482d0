// FFT pieces of the half-window transforms: radix-2 passes in shared
// memory (K3/K4) and a radix-8 transform held in registers (K1).
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

// ---- a transform held in registers (K1) ------------------------------------
//
// T = B/8 threads share one B-point complex transform (B a power of two,
// 32 .. 1024); thread t holds the eight points v[m] = z[t + m T].  The
// stages are Stockham's self-sorting ones, of radix 8 while eight or more
// points remain to be combined and of radix 4 or 2 at the end, so 512 = 8^3
// points take three stages and two exchanges through shared memory where
// the radix-2 passes above take nine barriers.  Input and output are in
// natural order.  tw[m] = exp(-2 pi i m / 2B), m < 2B, computed in double
// precision.  The inverse is the same transform with re and im swapped on
// the way in and out.

__device__ __forceinline__ void bfly(float2& a, float2& b) {
  const float2 t = a;
  a = make_float2(t.x + b.x, t.y + b.y);
  b = make_float2(t.x - b.x, t.y - b.y);
}

__device__ __forceinline__ float2 mul_neg_i(float2 a) {
  return make_float2(a.y, -a.x);
}

// Forward 4-point DFT in place, outputs in natural order.
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c,
                                     float2& d) {
  bfly(a, c);
  bfly(b, d);
  d = mul_neg_i(d);
  bfly(a, b);
  bfly(c, d);
  const float2 t = b;  // a, b, c, d hold X0, X2, X1, X3
  b = c;
  c = t;
}

// The 8/R forward DFTs of radix R over v[u + q (8/R)], q < R, in place and
// in natural order.
template <int R>
__device__ __forceinline__ void dft_regs(float2 (&v)[8]) {
  if constexpr (R == 8) {
    constexpr float h = 0.70710678118654752440f;
    bfly(v[0], v[4]);
    bfly(v[1], v[5]);
    bfly(v[2], v[6]);
    bfly(v[3], v[7]);
    v[5] = make_float2(h * (v[5].x + v[5].y), h * (v[5].y - v[5].x));
    v[6] = mul_neg_i(v[6]);
    v[7] = make_float2(h * (v[7].y - v[7].x), -h * (v[7].x + v[7].y));
    dft4(v[0], v[1], v[2], v[3]);  // the even outputs X0, X2, X4, X6
    dft4(v[4], v[5], v[6], v[7]);  // the odd outputs X1, X3, X5, X7
    const float2 x1 = v[4], x2 = v[1], x3 = v[5], x4 = v[2], x5 = v[6],
                 x6 = v[3];
    v[1] = x1;
    v[2] = x2;
    v[3] = x3;
    v[4] = x4;
    v[5] = x5;
    v[6] = x6;
  } else if constexpr (R == 4) {
    dft4(v[0], v[2], v[4], v[6]);
    dft4(v[1], v[3], v[5], v[7]);
  } else {
    bfly(v[0], v[4]);
    bfly(v[1], v[5]);
    bfly(v[2], v[6]);
    bfly(v[3], v[7]);
  }
}

// Barriers for fft_regs: the whole CTA, or its first N threads (N a
// multiple of 32) where other warps of the CTA do something else.
struct CtaSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
template <int N>
struct FirstThreadsSync {
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
  }
};

// Forward B-point transform of the points in v (thread t of the
// transform's T = B/8), exchanged through buf [B].  Every thread that
// ``sync`` joins must call it.  NS is the number of points already
// combined.
template <int B, int NS = 1, typename Sync>
__device__ __forceinline__ void fft_regs(float2 (&v)[8], float2* buf,
                                         const float2* tw, int t,
                                         const Sync& sync) {
  constexpr int T = B / 8;
  constexpr int R = (B / NS >= 8) ? 8 : B / NS;  // this stage's radix
  constexpr int G = 8 / R;                       // butterflies a thread
  if constexpr (NS > 1) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int k = (t + u * T) & (NS - 1);
#pragma unroll
      for (int q = 1; q < R; ++q)
        v[u + q * G] = cmul(v[u + q * G], tw[q * k * (2 * B / (NS * R))]);
    }
  }
  dft_regs<R>(v);
  if constexpr (NS * R < B) {
    sync();  // buf's earlier readers are done
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int j = t + u * T;
      const int k = j & (NS - 1);
      const int d = (j - k) * R + k;
#pragma unroll
      for (int q = 0; q < R; ++q) buf[d + q * NS] = v[u + q * G];
    }
    sync();
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = buf[t + m * T];
    fft_regs<B, NS * R>(v, buf, tw, t, sync);
  }
}

}  // namespace bbcat
