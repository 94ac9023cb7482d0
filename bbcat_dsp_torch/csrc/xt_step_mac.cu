// Single-step tail MAC over the xt-slot queue (K2s) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's per-super-step tail forms its
// windows with XLA ops and runs its head MAC over them, and the port did
// the same in PyTorch (a roll of the queue, two cats, the window sums, K7
// at R = 1 and a copy of the queue for the slot write), about 7 GB of
// traffic a firing at BASELINE config #5's shape.  This is K2's out[0]
// (xt_grouped_mac.cu) with one new super-block instead of P, followed by
// the step's slot write.  For every channel c and standard-layout bin f,
// with P tail partitions:
//   t[i] = queue[(slot + i) % P]  (i < P),   t[P] = xt
//   w[k] = t[k] + (-1)^f t[k + 1]                      k = 0 .. P-1
//   out  = sum_p w[P - 1 - p] * H[p]                    over re/im planes
// and, where the caller owns the queue, queue[slot] = xt rounded to the
// queue's type, in place.
//
// Bound: bytes.  Each (c, f) reads P + 1 half spectra and P IR bins once
// and writes one output (and one queue entry): P complex MACs against at
// least 16 P bytes, far below the card's ratio.  At P = 14, C = 1024,
// F = 4097 a launch moves 1041 MB (the queue and H 470 MB each; xt, the
// output and the slot 33.6 MB each): 0.31 ms at 3.35 TB/s.  The queue and
// H are 9x the 50 MB L2 and read once, so they stream past it (.cs); xt
// was just written by K3 and the output goes on to K4, so both stay
// cacheable.
//
// Design.  A thread owns kVec = 4 consecutive elements at = c F + f of
// every plane (16-byte loads of float32, 8-byte loads of a narrow queue)
// where C F is a multiple of 4 and the planes are aligned, else one
// element; each element's sign is f = at % F.  p walks 0 .. P-1, the
// order of the plain version's sum: window w[P-1-p] = t[P-1-p] + s
// t[P-p], so the thread keeps only the newer half spectrum (xt first) and
// each partition loads one queue slot, (slot - 1 - p) mod P, and one IR
// bin.  The loads of kAhead partitions start before their MACs (256 bytes
// a thread in flight with float32 vectors).  P is a runtime value and
// nothing lives in shared memory, so any P runs.  At config #5's shape
// the launch takes 0.3447 ms with a float32 queue (90% of its bound) and
// 0.2707 ms with a narrow one (87%); kAhead = 2 or 8, or one element a
// thread, measured 0.3450-0.3485 ms in float32 (168 registers a thread on
// the vector path, 38 on the other, no spills).
//
// In place: the thread that reads queue[slot] at its elements (the last
// partition, p = P - 1) is their only reader, so after its loads it stores
// xt there: no race and no second pass.  The queue's loads and that store
// are volatile asm on the one (not restrict) queue pointer, so the
// compiler keeps them in program order.  The queue may be float32,
// bfloat16 or float16 (the convolvers' dtype): it is widened to float32
// as it is loaded and only the slot written is rounded (to nearest even,
// as PyTorch's conversion does); H, xt, the sums and the output stay
// float32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;    // elements a thread on the vector path
constexpr int kAhead = 4;  // partitions whose loads precede their MACs

// A narrow queue's 16-bit values, widened and rounded
template <typename Q>
struct Bits;
template <>
struct Bits<__nv_bfloat16> {
  static __device__ __forceinline__ float widen(unsigned short u) {
    return __bfloat162float(__ushort_as_bfloat16(u));
  }
  static __device__ __forceinline__ unsigned short round(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <>
struct Bits<__half> {
  static __device__ __forceinline__ float widen(unsigned short u) {
    return __half2float(__ushort_as_half(u));
  }
  static __device__ __forceinline__ unsigned short round(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// V queue values from p, widened to float32, streamed (ld.global.cs)
template <int V, typename Q>
__device__ __forceinline__ void load_queue(const Q* p, float (&v)[V]) {
  if constexpr (std::is_same<Q, float>::value) {
    if constexpr (V == 4) {
      asm volatile("ld.global.cs.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                   : "l"(p));
    } else {
      asm volatile("ld.global.cs.f32 %0, [%1];" : "=f"(v[0]) : "l"(p));
    }
  } else if constexpr (V == 4) {
    unsigned lo, hi;
    asm volatile("ld.global.cs.v2.u32 {%0, %1}, [%2];"
                 : "=r"(lo), "=r"(hi)
                 : "l"(p));
    v[0] = Bits<Q>::widen(static_cast<unsigned short>(lo & 0xffffu));
    v[1] = Bits<Q>::widen(static_cast<unsigned short>(lo >> 16));
    v[2] = Bits<Q>::widen(static_cast<unsigned short>(hi & 0xffffu));
    v[3] = Bits<Q>::widen(static_cast<unsigned short>(hi >> 16));
  } else {
    unsigned short u;
    asm volatile("ld.global.cs.u16 %0, [%1];" : "=h"(u) : "l"(p));
    v[0] = Bits<Q>::widen(u);
  }
}

// V float32 values stored to the queue at p, rounded to its type
template <int V, typename Q>
__device__ __forceinline__ void store_queue(Q* p, const float (&v)[V]) {
  if constexpr (std::is_same<Q, float>::value) {
    if constexpr (V == 4) {
      asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                   "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
                   : "memory");
    } else {
      asm volatile("st.global.cs.f32 [%0], %1;" ::"l"(p), "f"(v[0])
                   : "memory");
    }
  } else if constexpr (V == 4) {
    const unsigned lo = Bits<Q>::round(v[0]) |
                        (static_cast<unsigned>(Bits<Q>::round(v[1])) << 16);
    const unsigned hi = Bits<Q>::round(v[2]) |
                        (static_cast<unsigned>(Bits<Q>::round(v[3])) << 16);
    asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(lo),
                 "r"(hi)
                 : "memory");
  } else {
    asm volatile("st.global.cs.u16 [%0], %1;" ::"l"(p),
                 "h"(Bits<Q>::round(v[0]))
                 : "memory");
  }
}

// V float32 values from p: streamed (H) or through the read-only cache (xt)
template <int V, bool kStream>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 w = kStream ? __ldcs(q) : __ldg(q);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
    v[0] = kStream ? __ldcs(p) : __ldg(p);
  }
}

template <typename Q, int V>
__global__ void __launch_bounds__(kThreads)
xt_step_mac_kernel(Q* queue, const float* __restrict__ xt,
                   const float* __restrict__ H, float* __restrict__ out,
                   int P, long long N, int F, int slot, int retire) {
  static_assert(V == 1 || V == kVec, "one element or a vector");
  const long long at =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (at >= N) return;  // N is a multiple of V: every element is live
  const long long plane = static_cast<long long>(P) * N;  // re to im
  float s[V], xr[V], xi[V], pr[V], pi[V], ar[V], ai[V];
  load_f32<V, false>(xt + at, xr);
  load_f32<V, false>(xt + N + at, xi);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    s[v] = (((at + v) % F) & 1) ? -1.0f : 1.0f;
    pr[v] = xr[v];
    pi[v] = xi[v];
    ar[v] = ai[v] = 0.0f;
  }
  int k = (slot == 0 ? P : slot) - 1;  // slot of t[P - 1 - p], p = 0
  for (int p0 = 0; p0 < P; p0 += kAhead) {
    float qr[kAhead][V], qi[kAhead][V], hr[kAhead][V], hi[kAhead][V];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (p0 + u < P) {
        const Q* q = queue + k * N + at;
        const float* h = H + (p0 + u) * N + at;
        load_queue<V>(q, qr[u]);
        load_queue<V>(q + plane, qi[u]);
        load_f32<V, true>(h, hr[u]);
        load_f32<V, true>(h + plane, hi[u]);
        k = (k == 0 ? P : k) - 1;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (p0 + u < P) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float wr = qr[u][v] + s[v] * pr[v];
          const float wi = qi[u][v] + s[v] * pi[v];
          ar[v] += wr * hr[u][v] - wi * hi[u][v];
          ai[v] += wr * hi[u][v] + wi * hr[u][v];
          pr[v] = qr[u][v];
          pi[v] = qi[u][v];
        }
      }
    }
  }
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(out + at) = make_float4(ar[0], ar[1], ar[2],
                                                       ar[3]);
    *reinterpret_cast<float4*>(out + N + at) =
        make_float4(ai[0], ai[1], ai[2], ai[3]);
  } else {
    out[at] = ar[0];
    out[N + at] = ai[0];
  }
  if (retire) {  // after every load of the slot: it was the last partition
    Q* q = queue + static_cast<long long>(slot) * N + at;
    store_queue<V>(q, xr);
    store_queue<V>(q + plane, xi);
  }
}

inline bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <typename Q, int V>
int launch_as(void* queue, const float* xt, const float* H, float* out,
              int P, long long N, int F, int slot, int retire,
              cudaStream_t stream) {
  const long long threads = N / V;
  const unsigned grid =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  xt_step_mac_kernel<Q, V><<<grid, kThreads, 0, stream>>>(
      static_cast<Q*>(queue), xt, H, out, P, N, F, slot, retire);
  return static_cast<int>(cudaGetLastError());
}

// the vector path where every plane starts on a vector boundary
template <typename Q>
int launch(void* queue, const float* xt, const float* H, float* out, int P,
           long long N, int F, int slot, int retire, cudaStream_t stream) {
  if (N % kVec == 0 && aligned(queue, kVec * sizeof(Q)) &&
      aligned(xt, 16) && aligned(H, 16) && aligned(out, 16))
    return launch_as<Q, kVec>(queue, xt, H, out, P, N, F, slot, retire,
                              stream);
  return launch_as<Q, 1>(queue, xt, H, out, P, N, F, slot, retire, stream);
}

}  // namespace

extern "C" {

// queue [2, P, C, F] of the type by code (0 float32, 1 bfloat16,
// 2 float16), xt [2, C, F], H [2, P, C, F] -> out [2, C, F];
// 0 <= slot < P; retire != 0 also writes xt into queue[:, slot]
int bbcat_xt_step_mac(void* queue, const float* xt, const float* H,
                      float* out, int P, int C, int F, int slot, int qtype,
                      int retire, cudaStream_t stream) {
  if (P < 1 || C < 1 || F < 1 || slot < 0 || slot >= P)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long N = static_cast<long long>(C) * F;
  switch (qtype) {
    case 0:
      return launch<float>(queue, xt, H, out, P, N, F, slot, retire, stream);
    case 1:
      return launch<__nv_bfloat16>(queue, xt, H, out, P, N, F, slot, retire,
                                   stream);
    case 2:
      return launch<__half>(queue, xt, H, out, P, N, F, slot, retire, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
