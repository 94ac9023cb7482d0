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
// writes P outputs (6P floats in, 2P out), against P^2 complex MACs: at
// most ~1 flop per byte up to P = 16, far below the card's ratio, and
// nothing is shared between elements, so there is no use for shared
// memory or the tensor cores.  At BASELINE config #5's tail (P = 14,
// C = 1024, F = 4097) a launch moves 1879.5 MB, each byte once: 0.561 ms
// at 3.35 TB/s.  What a design can lose is bytes in flight: the memory's
// rate times its latency is some MB over the card, and a thread that
// waits on one load at a time does not hold its share.
//
// Design.  The plane [C, F] of one partition is contiguous, so the kernel
// walks the N = C F elements flat and needs (c, f) only for the sign,
// f = at % F; no CTA is cut at a row's end.  For P <= kUnrolledParts (16:
// the headline's tail has 6, config #5's 14) the kernel is a template over
// P: a thread starts all its 6P loads before the first use (2P half
// spectra and P IR bins, two planes each), forms the 2P-1 windows in place
// in registers and stores its P outputs, each sum in the plain version's
// order (p ascending).  A thread owns kVec = 2 consecutive elements, one
// 8-byte load a plane, where C F is even and every plane is 8-byte
// aligned, else one element.  At P = 14 both take 255 registers and no
// spill (two CTAs of 128 an SM), and the vector path has 672 bytes a
// thread in flight.  At config #5's tail it takes 0.622 ms, 90% of its
// bound; one element a thread reads 0.648 ms, four spill (1.21 ms), CTAs
// of 256 the same 0.624 ms.  The queue is dead after this kernel and
// streams past the caches (__ldcs); xt (the next call's queue) and the
// output (K4's input) stay cacheable, and so does H: streaming it too
// read 0.635 ms at P = 14.  At the render's P = 6, C = 64 the kernel
// reads 0.018 ms against 0.015, as one element a thread did.
//
// Larger P (up to 303) takes the general kernel: one element a thread,
// the windows and IR bins in a shared-memory column private to the
// thread, indexable by a runtime P.  Its loop loads one half spectrum
// ahead of a column store, so few loads are in flight, and its columns
// ((3P - 1) x 8 bytes a thread) leave about 20 warps an SM: it held
// config #5's tail at 0.956 ms, 58% of the bound, before the template
// reached P = 14.  The output goes to a fresh tensor: the caller still
// holds the queue.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kUnrolledParts = 16;  // P up to this runs from registers
constexpr int kThreads = 128;       // CTA of the register kernel
constexpr int kVec = 2;  // elements a register thread owns where it can

// V consecutive floats from p: streamed past the caches (ld.global.cs) or
// through the read-only cache
template <int V, bool kStream>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (V == 2) {
    const float2* q = reinterpret_cast<const float2*>(p);
    const float2 w = kStream ? __ldcs(q) : __ldg(q);
    v[0] = w.x;
    v[1] = w.y;
  } else {
    v[0] = kStream ? __ldcs(p) : __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// N = C F elements a partition; thread `at / V` owns elements at .. at+V-1
// of every partition and plane.
template <int P, int V>
__global__ void __launch_bounds__(kThreads)
xt_mac_unrolled_kernel(const float* __restrict__ queue,
                       const float* __restrict__ xt,
                       const float* __restrict__ H, float* __restrict__ out,
                       long long N, int F, int slot0) {
  const long long at =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (at >= N) return;  // N is a multiple of V: every element is live
  const long long plane = P * N;  // re to im

  // every load of the thread, before any use
  float tr[2 * P][V], ti[2 * P][V], hr[P][V], hi[P][V];
#pragma unroll
  for (int i = 0; i < P; ++i) {  // the queue, oldest slot first
    int slot = slot0 + i;
    if (slot >= P) slot -= P;
    const float* src = queue + slot * N + at;
    load<V, true>(src, tr[i]);
    load<V, true>(src + plane, ti[i]);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float* src = xt + i * N + at;
    load<V, false>(src, tr[P + i]);
    load<V, false>(src + plane, ti[P + i]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float* src = H + p * N + at;
    load<V, false>(src, hr[p]);
    load<V, false>(src + plane, hi[p]);
  }

  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = (((at + v) % F) & 1) ? -1.0f : 1.0f;
  // the windows in place: t[k] becomes w[k] while t[k + 1] is still whole
#pragma unroll
  for (int k = 0; k < 2 * P - 1; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      tr[k][v] += s[v] * tr[k + 1][v];
      ti[k][v] += s[v] * ti[k + 1][v];
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float ar[V], ai[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      ar[v] = ai[v] = 0.0f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int k = P - 1 + j - p;
        ar[v] += tr[k][v] * hr[p][v] - ti[k][v] * hi[p][v];
        ai[v] += tr[k][v] * hi[p][v] + ti[k][v] * hr[p][v];
      }
    }
    float* dst = out + j * N + at;
    store<V>(dst, ar);
    store<V>(dst + plane, ai);
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

inline bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <int P, int V>
int launch_as(const float* queue, const float* xt, const float* H,
              float* out, long long N, int F, int slot0,
              cudaStream_t stream) {
  const long long threads = N / V;
  const unsigned grid =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  xt_mac_unrolled_kernel<P, V>
      <<<grid, kThreads, 0, stream>>>(queue, xt, H, out, N, F, slot0);
  return static_cast<int>(cudaGetLastError());
}

// the vector path where every plane starts on a vector boundary
template <int P>
int launch_unrolled(const float* queue, const float* xt, const float* H,
                    float* out, long long N, int F, int slot0,
                    cudaStream_t stream) {
  constexpr unsigned kBytes = kVec * sizeof(float);
  if (N % kVec == 0 && aligned(queue, kBytes) && aligned(xt, kBytes) &&
      aligned(H, kBytes) && aligned(out, kBytes))
    return launch_as<P, kVec>(queue, xt, H, out, N, F, slot0, stream);
  return launch_as<P, 1>(queue, xt, H, out, N, F, slot0, stream);
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

// The most partitions the register kernel serves; chip_smoke.py holds the
// wrapper's XT_UNROLLED_PARTS, which names the path a shape takes, to it
// (and tests/test_torch_xt_grouped_mac_card.py the wrapper's XT_VEC to
// kVec, by the name of the kernel a launch ran).
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
    BBCAT_XT_CASE(9)
    BBCAT_XT_CASE(10)
    BBCAT_XT_CASE(11)
    BBCAT_XT_CASE(12)
    BBCAT_XT_CASE(13)
    BBCAT_XT_CASE(14)
    BBCAT_XT_CASE(15)
    BBCAT_XT_CASE(16)
#undef BBCAT_XT_CASE
    default:
      static_assert(kUnrolledParts == 16, "one case per register P");
      return launch_general(queue, xt, H, out, P, N, F, slot0, stream);
  }
}

}  // extern "C"
