// Whole-group tail MAC over the xt-slot queue (K2) for Hopper (sm_90a).
//
// Replaces xt_grouped_mac_pallas in the JAX package's ops/pallas/spectral_fir.py.
// For every channel c and standard-layout bin f, with P tail partitions:
//   t[i]   = queue[(slot0 + i) % P]  (i < P),  xt[i - P]  (P <= i < 2P)
//   w[k]   = t[k] + (-1)^f t[k + 1]                      k = 0 .. 2P-2
//   out[j] = sum_p w[P - 1 + j - p] * H[p]              j = 0 .. P-1
// over re/im planes [2, P, C, F].
//
// Bound: bytes.  Each (c, f) reads 2P half spectra and P IR bins once and
// writes P outputs (6P floats in, 2P out), against P^2 complex MACs -- at
// the render's P = 6 that is ~1.5 flop per byte, far below the card's
// ratio, and nothing is shared between elements, so there is no use for
// shared memory or the tensor cores.  What a design can lose is bytes in
// flight: the memory's rate times its latency is ~2 MB over the card, and
// a thread that waits on one load at a time does not hold its share.
//
// Design.  The plane [C, F] of one partition is contiguous, so the kernel
// walks the N = C F elements flat, one a thread, and needs (c, f) only for
// the sign, f = at % F; no CTA is cut at a row's end.  For the partition
// counts the engines give (P <= kUnrolledParts; the headline's tail has 6)
// the kernel is a template over P: a thread starts all its 6P loads before
// the first use (2P half spectra and P IR bins, two planes each), forms
// the 2P-1 windows in place in registers and stores its P outputs.  At
// P = 6 that is 83 registers and 144 bytes in flight a thread, some 100 KB
// an SM.  The queue is dead after this kernel and streams past the caches
// (__ldcs: 1.2x at the render's shape); xt, H and the output are read
// again by the next kernels and stay cacheable.  Two or four elements a
// thread as float2 or float4 measured the same time as one (the loads in
// flight already cover the latency), so the kernel keeps the one path that
// serves every C F and any alignment.  Larger P (up to 303) takes the
// general kernel, whose windows and IR bins sit in a shared-memory column
// private to the thread, indexable by a runtime P.  The output goes to a
// fresh tensor: the caller still holds the queue.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kUnrolledParts = 8;  // P up to this runs from registers
constexpr int kThreads = 128;      // CTA of the unrolled kernel

// N = C F elements a partition; thread `at` owns element `at` of every
// partition and plane.
template <int P>
__global__ void __launch_bounds__(kThreads)
xt_mac_unrolled_kernel(const float* __restrict__ queue,
                       const float* __restrict__ xt,
                       const float* __restrict__ H, float* __restrict__ out,
                       int N, int F, int slot0) {
  const long long at =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (at >= N) return;
  const size_t plane = static_cast<size_t>(P) * N;

  // every load of the thread, before any use
  float tr[2 * P], ti[2 * P], hr[P], hi[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {  // the queue, oldest slot first
    int slot = slot0 + i;
    if (slot >= P) slot -= P;
    const float* src = queue + static_cast<size_t>(slot) * N + at;
    tr[i] = __ldcs(src);
    ti[i] = __ldcs(src + plane);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float* src = xt + static_cast<size_t>(i) * N + at;
    tr[P + i] = __ldg(src);
    ti[P + i] = __ldg(src + plane);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float* src = H + static_cast<size_t>(p) * N + at;
    hr[p] = __ldg(src);
    hi[p] = __ldg(src + plane);
  }

  const float s = ((at % F) & 1) ? -1.0f : 1.0f;
  // the windows in place: t[k] becomes w[k] while t[k + 1] is still whole
#pragma unroll
  for (int k = 0; k < 2 * P - 1; ++k) {
    tr[k] += s * tr[k + 1];
    ti[k] += s * ti[k + 1];
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float ar = 0.0f, ai = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int k = P - 1 + j - p;
      ar += tr[k] * hr[p] - ti[k] * hi[p];
      ai += tr[k] * hi[p] + ti[k] * hr[p];
    }
    float* dst = out + static_cast<size_t>(j) * N + at;
    dst[0] = ar;
    dst[plane] = ai;
  }
}

// Shared bytes per thread of the general kernel: (2P-1) windows + P IR
// bins, one float2 each.
inline size_t smem_per_thread(int P) {
  return static_cast<size_t>(3 * P - 1) * sizeof(float2);
}

// Any P: one element a thread, the windows and IR bins in a shared column.
__global__ void xt_mac_general_kernel(const float* __restrict__ queue,
                                      const float* __restrict__ xt,
                                      const float* __restrict__ H,
                                      float* __restrict__ out, int P, int N,
                                      int F, int slot0) {
  extern __shared__ float2 col[];
  const int T = blockDim.x;
  const long long at = static_cast<long long>(blockIdx.x) * T + threadIdx.x;
  if (at >= N) return;  // no barrier below: idle threads may leave
  const size_t part = static_cast<size_t>(N);  // partition stride
  const size_t plane = static_cast<size_t>(P) * part;
  float2* w = col + threadIdx.x;                         // w[k * T]
  float2* h = col + static_cast<size_t>(2 * P - 1) * T + threadIdx.x;
  const float s = ((at % F) & 1) ? -1.0f : 1.0f;

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

template <int P>
int launch_unrolled(const float* queue, const float* xt, const float* H,
                    float* out, int N, int F, int slot0, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  xt_mac_unrolled_kernel<P>
      <<<grid, kThreads, 0, stream>>>(queue, xt, H, out, N, F, slot0);
  return static_cast<int>(cudaGetLastError());
}

// The general kernel's CTA shrinks from 128 to 32 threads as P grows so
// the per-thread columns fit the shared memory; P beyond what 32 threads
// fit returns an error.
int launch_general(const float* queue, const float* xt, const float* H,
                   float* out, int P, int N, int F, int slot0,
                   cudaStream_t stream) {
  int T = 128;
  while (T > 32 && T * smem_per_thread(P) > 48 * 1024) T /= 2;
  const size_t smem = T * smem_per_thread(P);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        xt_mac_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((N + T - 1) / T);
  xt_mac_general_kernel<<<grid, T, smem, stream>>>(queue, xt, H, out, P, N, F,
                                                  slot0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most partitions the unrolled kernel serves; chip_smoke.py holds the
// wrapper's XT_UNROLLED_PARTS, which names the path a shape takes, to it.
int bbcat_xt_unrolled_parts() { return kUnrolledParts; }

// queue, xt, H [2, P, C, F] -> out [2, P, C, F]; 0 <= slot0 < P.
int bbcat_xt_grouped_mac(const float* queue, const float* xt, const float* H,
                         float* out, int P, int C, int F, int slot0,
                         cudaStream_t stream) {
  if (P < 1 || C < 1 || F < 1 || slot0 < 0 || slot0 >= P ||
      static_cast<long long>(C) * F > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int N = C * F;
  switch (P) {
#define BBCAT_XT_CASE(p)                                                  \
  case p:                                                                 \
    return launch_unrolled<p>(queue, xt, H, out, N, F, slot0, stream);
    BBCAT_XT_CASE(1)
    BBCAT_XT_CASE(2)
    BBCAT_XT_CASE(3)
    BBCAT_XT_CASE(4)
    BBCAT_XT_CASE(5)
    BBCAT_XT_CASE(6)
    BBCAT_XT_CASE(7)
    BBCAT_XT_CASE(8)
#undef BBCAT_XT_CASE
    default:
      static_assert(kUnrolledParts == 8, "one case per unrolled P");
      return launch_general(queue, xt, H, out, P, N, F, slot0, stream);
  }
}

}  // extern "C"
