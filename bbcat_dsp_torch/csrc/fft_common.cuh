// FFT pieces of the half-window transforms: a transform held in
// registers, of radix 8 or 16, which the fused head (K1) and the tail
// transforms (K3/K4) share.
//
// A real transform of n = 2m samples runs as one complex m-point FFT of
// the packed pairs z[j] = x[2j] + i x[2j+1]; real_bin unpacks its bins and
// packed_bin packs a half spectrum back for the inverse.  Twiddles come
// from a host table computed in double precision and the code is built
// without --use_fast_math.

#pragma once

#include <cuda_runtime.h>

namespace bbcat {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
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

// Bins k and m - k (0 <= k < m/2) of the same transform at once, from zk =
// Z[k] and zc = Z[(m - k) mod m]: with E and O as above, X[k] = E + w O
// and X[m-k] = conj(E - w O), w = twk.  At k = 0 these are DC and Nyquist,
// both real, from zk = zc = Z[0].  (The middle bin is conj(Z[m/2]).)
__device__ __forceinline__ void real_bin_pair(float2 zk, float2 zc, int k,
                                              float2 twk, float2& xk,
                                              float2& xmk) {
  zc.y = -zc.y;
  const float2 e = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y + zc.y));
  const float2 o = cmul(
      twk, make_float2(0.5f * (zk.y - zc.y), -0.5f * (zk.x - zc.x)));
  xk = make_float2(e.x + o.x, e.y + o.y);
  xmk = make_float2(e.x - o.x, o.y - e.y);
  if (k == 0) xk.y = xmk.y = 0.0f;
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

// ---- a transform held in registers -----------------------------------------
//
// T = B/NP threads share one B-point complex transform (B a power of two,
// 32 .. 8192); thread t holds the NP = 8 or 16 points v[m] = z[t + m T].
// The stages are Stockham's self-sorting ones, of radix NP while NP or
// more points remain to be combined and of a smaller power of two at the
// end, so 512 = 8^3 points take three stages and two exchanges through
// shared memory, and 4096 = 16^3 as many, where radix-2 passes take a
// barrier a bit of log2 B.  Input and output are in natural order.  The
// inverse is the same transform with re and im swapped on the way in and
// out.
//
// Two halves of the work can be known beforehand.  A half window's upper
// half is zero: kUpperZero makes the first stage a butterfly of its lower
// inputs alone (the caller leaves v[NP/2 ..] unset).  Overlap-save keeps
// only the last half of an inverse, which is v[NP/2 ..] after the last
// stage: a caller that reads nothing else lets the compiler drop the last
// stage's other outputs.

__device__ __forceinline__ void bfly(float2& a, float2& b) {
  const float2 t = a;
  a = make_float2(t.x + b.x, t.y + b.y);
  b = make_float2(t.x - b.x, t.y - b.y);
}

__device__ __forceinline__ float2 mul_neg_i(float2 a) {
  return make_float2(a.y, -a.x);
}

__device__ __forceinline__ void swap2(float2& a, float2& b) {
  const float2 t = a;
  a = b;
  b = t;
}

// Forward 4-point DFT in place, outputs in natural order.
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c,
                                     float2& d) {
  bfly(a, c);
  bfly(b, d);
  d = mul_neg_i(d);
  bfly(a, b);
  bfly(c, d);
  swap2(b, c);  // a, b, c, d held X0, X2, X1, X3
}

// Forward 8-point DFT in place, outputs in natural order.  With
// kUpperZero the inputs a4 .. a7 are taken as zero and not read.
template <bool kUpperZero>
__device__ __forceinline__ void dft8(float2& a0, float2& a1, float2& a2,
                                     float2& a3, float2& a4, float2& a5,
                                     float2& a6, float2& a7) {
  constexpr float h = 0.70710678118654752440f;
  if constexpr (kUpperZero) {
    a4 = a0;
    a5 = a1;
    a6 = a2;
    a7 = a3;
  } else {
    bfly(a0, a4);
    bfly(a1, a5);
    bfly(a2, a6);
    bfly(a3, a7);
  }
  a5 = make_float2(h * (a5.x + a5.y), h * (a5.y - a5.x));
  a6 = mul_neg_i(a6);
  a7 = make_float2(h * (a7.y - a7.x), -h * (a7.x + a7.y));
  dft4(a0, a1, a2, a3);  // the even outputs X0, X2, X4, X6
  dft4(a4, a5, a6, a7);  // the odd outputs X1, X3, X5, X7
  const float2 x1 = a4, x2 = a1, x3 = a5, x4 = a2, x5 = a6, x6 = a3;
  a1 = x1;
  a2 = x2;
  a3 = x3;
  a4 = x4;
  a5 = x5;
  a6 = x6;
}

// Forward 16-point DFT in place, outputs in natural order, as 4 x 4: the
// DFTs Y_i of a[i], a[i+4], a[i+8], a[i+12], the twiddles exp(-2 pi i
// i r / 16) on Y_i[r], and the DFTs over i, whose output s is X[r + 4 s].
// With kUpperZero the inputs a[8 ..] are taken as zero and not read.
template <bool kUpperZero>
__device__ __forceinline__ void dft16(float2 (&a)[16]) {
  constexpr float h = 0.70710678118654752440f;
  constexpr float c = 0.92387953251128675613f;  // cos(pi / 8)
  constexpr float s = 0.38268343236508977173f;  // sin(pi / 8)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kUpperZero) {
      const float2 p = a[i], q = a[i + 4];
      a[i] = make_float2(p.x + q.x, p.y + q.y);
      a[i + 4] = make_float2(p.x + q.y, p.y - q.x);
      a[i + 8] = make_float2(p.x - q.x, p.y - q.y);
      a[i + 12] = make_float2(p.x - q.y, p.y + q.x);
    } else {
      dft4(a[i], a[i + 4], a[i + 8], a[i + 12]);
    }
  }
  // a[i + 4 r] = Y_i[r]; w^k = exp(-2 pi i k / 16) for k = i r
  a[5] = make_float2(c * a[5].x + s * a[5].y, c * a[5].y - s * a[5].x);
  a[9] = make_float2(h * (a[9].x + a[9].y), h * (a[9].y - a[9].x));
  a[13] = make_float2(s * a[13].x + c * a[13].y, s * a[13].y - c * a[13].x);
  a[6] = make_float2(h * (a[6].x + a[6].y), h * (a[6].y - a[6].x));
  a[10] = mul_neg_i(a[10]);
  a[14] = make_float2(h * (a[14].y - a[14].x), -h * (a[14].x + a[14].y));
  a[7] = make_float2(s * a[7].x + c * a[7].y, s * a[7].y - c * a[7].x);
  a[11] = make_float2(h * (a[11].y - a[11].x), -h * (a[11].x + a[11].y));
  a[15] = make_float2(-(c * a[15].x + s * a[15].y), s * a[15].x - c * a[15].y);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    dft4(a[4 * r], a[4 * r + 1], a[4 * r + 2], a[4 * r + 3]);
  // a[4 r + s] = X[r + 4 s]: transpose
  swap2(a[1], a[4]);
  swap2(a[2], a[8]);
  swap2(a[3], a[12]);
  swap2(a[6], a[9]);
  swap2(a[7], a[13]);
  swap2(a[11], a[14]);
}

// The G = NP/R forward DFTs of radix R over v[u + q G], q < R, in place
// and in natural order.
template <int R, int NP, bool kUpperZero>
__device__ __forceinline__ void dft_regs(float2 (&v)[NP]) {
  constexpr int G = NP / R;
  static_assert(R == NP || !kUpperZero, "only a full-radix stage is pruned");
  if constexpr (R == 16) {
    dft16<kUpperZero>(v);
  } else {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if constexpr (R == 8) {
        dft8<kUpperZero>(v[u], v[u + G], v[u + 2 * G], v[u + 3 * G],
                         v[u + 4 * G], v[u + 5 * G], v[u + 6 * G],
                         v[u + 7 * G]);
      } else if constexpr (R == 4) {
        dft4(v[u], v[u + G], v[u + 2 * G], v[u + 3 * G]);
      } else {
        bfly(v[u], v[u + G]);
      }
    }
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

// Where point i of a transform lies in its exchange buffer.  Natural
// order costs the early stages' scattered writes bank conflicts (a thread
// writes its NP outputs NS apart, the next thread NP NS further on: 8-way
// in the first exchange at NP = 8, 16-way at 16); Swizzled<NP> moves a
// point within its aligned group of 16 by the bits above, so that the 16
// lanes of a half warp meet 16 different 8-byte banks in every stage's
// writes and reads.
struct NaturalOrder {
  __device__ __forceinline__ int operator()(int i) const { return i; }
};
template <int NP>
struct Swizzled {
  __device__ __forceinline__ int operator()(int i) const {
    if constexpr (NP == 16) return i ^ ((i >> 4) & 15);
    return i ^ ((i >> 4) & 7) ^ ((i >> 3) & 8);
  }
};

// The radix of the stage that finds NS points combined.
__host__ __device__ constexpr int stage_radix(int B, int NP, int NS) {
  return B / NS >= NP ? NP : B / NS;
}
template <int B, int NP, int NS>
constexpr int kStageRadix = stage_radix(B, NP, NS);

// Twiddles: the factor exp(-2 pi i q k / (NS R)) on input q of butterfly
// k < NS of the stage that finds NS points combined.
//
// PeriodTable: one period tw[m] = exp(-2 pi i m / TWN), m < TWN (TWN a
// multiple of B), in shared memory.
template <int TWN>
struct PeriodTable {
  const float2* tw;
  template <int NS, int R>
  __device__ __forceinline__ float2 get(int q, int k) const {
    return tw[q * k * (TWN / (NS * R))];
  }
};

// StageTables: in device memory, read through the read-only cache; every
// stage NS > 1 has its own table [R - 1][NS], at (q - 1) NS + k, one
// behind the other, so a warp reads consecutive entries in every stage.
template <int B, int NP, int UPTO>
__host__ __device__ constexpr int stage_tables_size() {
  int size = 0;
  for (int ns = NP; ns < UPTO; ns *= NP)
    size += (stage_radix(B, NP, ns) - 1) * ns;
  return size;
}
template <int B, int NP>
struct StageTables {
  const float2* tw;
  template <int NS, int R>
  __device__ __forceinline__ float2 get(int q, int k) const {
    constexpr int at = stage_tables_size<B, NP, NS>();
    return __ldg(tw + at + (q - 1) * NS + k);
  }
};

// Forward B-point transform of the points in v (thread t of the
// transform's T = B/NP), exchanged through buf [B] at the places ``at``
// gives.  Every thread that ``sync`` joins must call it.  NS is the number
// of points already combined.
template <int B, int NP = 8, bool kUpperZero = false, int NS = 1,
          typename Table, typename Sync, typename Order = NaturalOrder>
__device__ __forceinline__ void fft_regs(float2 (&v)[NP], float2* buf,
                                         const Table& tw, int t,
                                         const Sync& sync,
                                         const Order& at = Order()) {
  constexpr int T = B / NP;
  constexpr int R = kStageRadix<B, NP, NS>;  // this stage's radix
  constexpr int G = NP / R;                  // butterflies a thread
  if constexpr (NS > 1) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int k = (t + u * T) & (NS - 1);
#pragma unroll
      for (int q = 1; q < R; ++q)
        v[u + q * G] = cmul(v[u + q * G], tw.template get<NS, R>(q, k));
    }
  }
  dft_regs<R, NP, kUpperZero && NS == 1>(v);
  if constexpr (NS * R < B) {
    sync();  // buf's earlier readers are done
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int j = t + u * T;
      const int k = j & (NS - 1);
      const int d = (j - k) * R + k;
#pragma unroll
      for (int q = 0; q < R; ++q) buf[at(d + q * NS)] = v[u + q * G];
    }
    sync();
#pragma unroll
    for (int m = 0; m < NP; ++m) v[m] = buf[at(t + m * T)];
    fft_regs<B, NP, kUpperZero, NS * R>(v, buf, tw, t, sync, at);
  }
}

}  // namespace bbcat
