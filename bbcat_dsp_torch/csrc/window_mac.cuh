// The partitioned spectral MAC over a tile of consecutive output blocks,
// held in registers (K1's second phase and K7).
//
// For one frequency bin and RT consecutive outputs k = 0 .. RT-1:
//   acc[k] += sum_p x(p - k) * h(p),   p = 0 .. P-1 in that order, float32
// where x(d) is the history entry d blocks before the tile's first output's
// newest window (d may be negative for the later outputs) and h(p) the
// filter's partition p.  Partition p + 1 needs partition p's entries moved
// by one output, so a window of RT entries slides down the history and each
// partition costs one new history entry and one filter bin for RT MACs.
//
// A thread's loop is a chain of loads from L2, each some hundreds of
// nanoseconds, and nothing else: what bounds it is how many loads are in
// flight.  So the partitions go in chunks of U whose 2U loads are all
// started before the chunk's first MAC, and inside a chunk the window's
// positions are compile-time indices into the registers (no moves); the
// window moves by U registers once a chunk.

#pragma once

#include <cuda_runtime.h>

namespace bbcat {

// x(d): history entry at distance d (callers return zero outside their
// history); h(p): filter bin of partition p < P.  kFma: each complex MAC
// as four fused multiply-adds into the sum (two roundings a component, the
// real product's terms added in turn), else as the product's components
// rounded and then added.
template <int RT, int U, bool kFma = false, typename X, typename Hf>
__device__ __forceinline__ void window_mac(float2 (&acc)[RT], int P,
                                           const X& x, const Hf& h) {
  float2 w[RT];  // w[k] = x(p0 - k)
#pragma unroll
  for (int k = 0; k < RT; ++k) w[k] = x(-k);
  for (int p0 = 0; p0 < P; p0 += U) {
    float2 g[U], e[U];  // e[j] = x(p0 + 1 + j) enters at the chunk's step j + 1
#pragma unroll
    for (int u = 0; u < U; ++u)
      g[u] = (p0 + u < P) ? h(p0 + u) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < U; ++j)
      e[j] = (p0 + 1 + j < P) ? x(p0 + 1 + j) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p0 + u < P) {
#pragma unroll
        for (int k = 0; k < RT; ++k) {
          // step u's window: w moved by u, e's first u entries in front
          // (the unused arm's index is clamped to stay inside its array)
          const float2 v = (k >= u) ? w[k >= u ? k - u : 0]
                                    : e[k >= u ? 0 : u - k - 1];
          if constexpr (kFma) {
            acc[k].x = fmaf(v.x, g[u].x, acc[k].x);
            acc[k].x = fmaf(-v.y, g[u].y, acc[k].x);
            acc[k].y = fmaf(v.x, g[u].y, acc[k].y);
            acc[k].y = fmaf(v.y, g[u].x, acc[k].y);
          } else {
            acc[k].x += v.x * g[u].x - v.y * g[u].y;
            acc[k].y += v.x * g[u].y + v.y * g[u].x;
          }
        }
      }
    }
#pragma unroll
    for (int k = RT - 1; k >= 0; --k)
      w[k] = (k >= U) ? w[k >= U ? k - U : 0] : e[k >= U ? 0 : U - k - 1];
  }
}

}  // namespace bbcat
