// Whole-group tail MAC over the xt-slot queue (K2) for Hopper (sm_90a).
//
// Replaces xt_grouped_mac_pallas in the JAX package's ops/pallas/spectral_fir.py.
// For every channel c and standard-layout bin f, with P tail partitions:
//   t[i]   = queue[(slot0 + i) % P]  (i < P),  xt[i - P]  (P <= i < 2P)
//   w[k]   = t[k] + (-1)^f t[k + 1]                      k = 0 .. 2P-2
//   out[j] = sum_p w[P - 1 + j - p] * H[p]              j = 0 .. P-1
// over re/im planes [2, P, C, F].
//
// Bound: memory.  Each (c, f) reads 2P half spectra and P IR bins once and
// writes P outputs (6P floats in, 2P out), against P^2 complex MACs -- at
// the render's P = 6 that is ~1.5 flop per byte, far below the card's
// ratio.  Design: one thread per (c, f); threads of a warp own consecutive
// bins, so every plane read and write is coalesced along f.  The 2P-1
// windows and the P IR bins sit in a shared-memory column private to the
// thread (indexable by a runtime P, unlike registers), so every global
// element is touched once.  The output goes to a fresh tensor; the TPU
// kernel's alias over the queue buffer is a later memory optimisation.

#include <cuda_runtime.h>

namespace {

// Shared bytes per thread: (2P-1) windows + P IR bins, one float2 each.
inline size_t smem_per_thread(int P) {
  return static_cast<size_t>(3 * P - 1) * sizeof(float2);
}

__global__ void xt_grouped_mac_kernel(const float* __restrict__ queue,
                                      const float* __restrict__ xt,
                                      const float* __restrict__ H,
                                      float* __restrict__ out, int P, int C,
                                      int F, int slot0, int ntile) {
  extern __shared__ float2 col[];
  const int T = blockDim.x;
  const int c = blockIdx.x / ntile;
  const int f = (blockIdx.x % ntile) * T + threadIdx.x;
  if (f >= F) return;  // no barrier below: idle threads may leave
  const size_t part = static_cast<size_t>(C) * F;  // partition stride
  const size_t plane = static_cast<size_t>(P) * part;
  const size_t at = static_cast<size_t>(c) * F + f;
  float2* w = col + threadIdx.x;                         // w[k * T]
  float2* h = col + static_cast<size_t>(2 * P - 1) * T + threadIdx.x;
  const float s = (f & 1) ? -1.0f : 1.0f;

  auto half = [&](int i) -> float2 {  // chronological half spectrum i
    const float* src = queue;
    int slot = slot0 + i;
    if (i >= P) {
      src = xt;
      slot = i - P;
    } else if (slot >= P) {
      slot -= P;
    }
    const size_t o = slot * part + at;
    return make_float2(src[o], src[plane + o]);
  };

  float2 a = half(0);
  for (int k = 0; k < 2 * P - 1; ++k) {
    const float2 b = half(k + 1);
    w[static_cast<size_t>(k) * T] = make_float2(a.x + s * b.x, a.y + s * b.y);
    a = b;
  }
  for (int p = 0; p < P; ++p) {
    const size_t o = p * part + at;
    h[static_cast<size_t>(p) * T] = make_float2(H[o], H[plane + o]);
  }
  for (int j = 0; j < P; ++j) {
    float ar = 0.0f, ai = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float2 v = w[static_cast<size_t>(P - 1 + j - p) * T];
      const float2 g = h[static_cast<size_t>(p) * T];
      ar += v.x * g.x - v.y * g.y;
      ai += v.x * g.y + v.y * g.x;
    }
    const size_t o = j * part + at;
    out[o] = ar;
    out[plane + o] = ai;
  }
}

}  // namespace

extern "C" {

// queue, xt, H [2, P, C, F] -> out [2, P, C, F].  The CTA width shrinks
// from 128 to 32 threads as P grows so the per-thread columns fit the
// shared memory; P beyond what 32 threads fit returns an error.
int bbcat_xt_grouped_mac(const float* queue, const float* xt, const float* H,
                         float* out, int P, int C, int F, int slot0,
                         cudaStream_t stream) {
  int T = 128;
  while (T > 32 && T * smem_per_thread(P) > 48 * 1024) T /= 2;
  const size_t smem = T * smem_per_thread(P);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        xt_grouped_mac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int ntile = (F + T - 1) / T;
  const unsigned grid = static_cast<unsigned>(C) * ntile;
  xt_grouped_mac_kernel<<<grid, T, smem, stream>>>(queue, xt, H, out, P, C, F,
                                                  slot0, ntile);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
