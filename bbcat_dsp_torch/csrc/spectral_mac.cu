// Spectral MACs of the streaming engines (K7/K8, K9) for Hopper (sm_90a).
//
// Replace, in the JAX package's ops/pallas/:
//   bbcat_head_mac     <- head_mac_tiled_pallas (spectral_fir.py) and
//                         head_mac_pallas (spectral_mac.py): one kernel serves
//                         any C, where the TPU needed an untiled variant for
//                         C < 16 or C % 8 != 0
//   bbcat_rotated_mac  <- rotated_mac_pallas (spectral_fir.py)
// For every channel c and bin f, over re/im planes:
//   head_mac     acc[i] = sum_p xext[P + i - p] * H[p]      i = 0 .. R-1
//   rotated_mac  acc    = sum_p queue[(slot - p) mod P] * H[p]
//
// Bound: memory.  Each output costs one complex MAC (8 flops) per
// partition against at least 16 bytes read, far below the card's ratio:
// the history's first P + R slots, H and the output move once (58.8 MB,
// 17.6 us at 3.35 TB/s, for C = 64, P = 64, R = 48, F = 513).  What a
// thread waits for is L2 latency: its loads are a chain, and one thread
// per (c, f) walking every output tile in turn leaves too few chains in
// flight (two CTAs an SM at C * F = 32832).  Design: one thread per (c, f)
// over the flat C*F axis, so a warp reads 32 consecutive floats of every
// plane, and per tile of outputs, so the grid is (C*F / 128, R tiles); p
// accumulates in the reference's order (p = 0 .. P-1) in float32.  A
// tile's outputs live in registers and a register window slides down the
// history (window_mac.cuh): each partition loads one new history entry and
// its H bin, with the loads of 8 partitions started before their MACs.  The
// tile is 16 outputs where R > 8 (H and the history are then read R/16
// times), 8 for the streaming super-step's R <= 8 and 1 for the single
// block.  The history may be deeper than P + R; the kernel reads only its
// first P + R slots (the crossfade's old-filter block reads the first
// P + 1 of a P + ratio history without a copy).
//
// rotated_mac reads a queue stored in float32, bfloat16 or float16 (the
// convolvers' dtype), each value widened to float32 as it is loaded; H, the
// sums and the output stay float32.  Bound: memory.  At P = 64, C = 64,
// F = 513 the launch moves 33.9 MB with a float32 queue and 25.5 MB with a
// narrow one (16.8 and 8.4 MB of it the queue).  As first ported (one
// thread per (c, f) walking all P partitions, 2-byte loads of a narrow
// queue, two CTAs of 128 an SM) it waited on its chain of loads: the
// narrow queue read 25% fewer bytes and ran 2-9% faster.  So the design
// puts more bytes in flight on every SM:
// * each thread takes kMacVec = 4 consecutive bins (16-byte loads of the
//   float32 planes, 8 bytes of a narrow queue) where C F is a multiple of
//   4 and the planes are aligned, else one bin (BASELINE config #1's
//   C F = 513 and other odd shapes);
// * a CTA of kMacLanes x kMacSplit threads splits the partitions into
//   kMacSplit contiguous groups, one a row of kMacLanes threads, and each
//   thread starts the loads of kMacAhead partitions before their MACs, so
//   its chain is P / kMacSplit partitions long, not P;
// * each group sums its partitions in the reference's order (p ascending)
//   in float32 and the rows' partial sums meet in shared memory, added in
//   group order by one thread an output: the result does not depend on
//   timing.  At the headline's shape the grid is 513 CTAs of 128, about
//   four an SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "window_mac.cuh"

namespace {

constexpr int kThreads = 128;
// partitions whose loads go ahead of their MACs: 8, but 4 for the single
// block, whose threads then take fewer registers (10% faster at F = 4097)
template <int RT>
constexpr int kAheadOf = RT == 1 ? 4 : 8;

// One bin of the re/im planes for window_mac.  Entry d of the history is
// slot P + i0 - d, zero past the tile's live outputs.
struct HistoryAt {
  const float* re;  // slot P + i0
  const float* im;
  long long S;  // from one slot to the next
  int newest;   // slots after P + i0 that may be read: R - 1 - i0
  __device__ __forceinline__ float2 operator()(int d) const {
    const long long o = -static_cast<long long>(d) * S;
    return (-d <= newest) ? make_float2(re[o], im[o])
                          : make_float2(0.0f, 0.0f);
  }
};

struct FilterAt {
  const float* re;  // partition 0
  const float* im;
  long long S;
  __device__ __forceinline__ float2 operator()(int p) const {
    return make_float2(re[p * S], im[p * S]);
  }
};

template <int RT>
__global__ void __launch_bounds__(kThreads)
head_mac_kernel(const float* __restrict__ xext, const float* __restrict__ H,
                float* __restrict__ out, int P, int D, int R, long long S) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (n >= S) return;
  const int i0 = blockIdx.y * RT;
  const float* xr = xext + static_cast<long long>(P + i0) * S + n;
  const HistoryAt hist{xr, xr + static_cast<long long>(D) * S, S, R - 1 - i0};
  const FilterAt filt{H + n, H + static_cast<long long>(P) * S + n, S};
  float2 acc[RT];
#pragma unroll
  for (int k = 0; k < RT; ++k) acc[k] = make_float2(0.0f, 0.0f);
  bbcat::window_mac<RT, kAheadOf<RT>>(acc, P, hist, filt);
  float* yr = out + static_cast<long long>(i0) * S + n;
  float* yi = yr + static_cast<long long>(R) * S;
#pragma unroll
  for (int k = 0; k < RT; ++k) {
    if (i0 + k < R) {
      yr[k * S] = acc[k].x;
      yi[k * S] = acc[k].y;
    }
  }
}

// K9's schedule (see the head of the file); ops/kernels/spectral_mac.py
// names the same numbers (ROTATED_MAC_SCHEDULE), and its CPU model in
// tests/test_torch_kernels.py follows them
constexpr int kMacLanes = 16;  // threads of a CTA along the bins
constexpr int kMacSplit = 8;   // groups of partitions, one a row of lanes
constexpr int kMacAhead = 4;   // partitions whose loads precede their MACs
constexpr int kMacVec = 4;     // bins a thread takes on the vector path

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float2 widen2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ float2 widen2(__half2 v) { return __half22float2(v); }

// V consecutive values from p, widened to float32: one 16-byte load of
// float32 or one 8-byte load of a narrow type where V = 4
template <int V, typename Q>
__device__ __forceinline__ void load_bins(const Q* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = widen(__ldg(p));
  } else if constexpr (sizeof(Q) == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
    using Q2 = typename std::conditional<std::is_same<Q, __half>::value,
                                         __half2, __nv_bfloat162>::type;
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = widen2(*reinterpret_cast<const Q2*>(&w.x));
    const float2 hi = widen2(*reinterpret_cast<const Q2*>(&w.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
}

template <typename Q, int V>
__global__ void __launch_bounds__(kMacLanes * kMacSplit)
rotated_mac_kernel(const Q* __restrict__ queue, const float* __restrict__ H,
                   float* __restrict__ out, int P, int slot, long long S) {
  static_assert(V == 1 || V == 4, "one bin or a vector of four");
  __shared__ float part[2][kMacSplit][V][kMacLanes];
  const int x = threadIdx.x, g = threadIdx.y;
  const long long tile = static_cast<long long>(blockIdx.x) * kMacLanes * V;
  const long long n = tile + static_cast<long long>(x) * V;  // first bin
  const long long plane = static_cast<long long>(P) * S;
  float ar[V], ai[V];
#pragma unroll
  for (int v = 0; v < V; ++v) ar[v] = ai[v] = 0.0f;
  if (n < S) {  // S is a multiple of V: the thread's bins are all live
    const int p_lo = (g * P) / kMacSplit, p_hi = ((g + 1) * P) / kMacSplit;
    int k = slot - p_lo;  // (slot - p) mod P
    if (k < 0) k += P;
    for (int p0 = p_lo; p0 < p_hi; p0 += kMacAhead) {
      float qr[kMacAhead][V], qi[kMacAhead][V];
      float hr[kMacAhead][V], hi[kMacAhead][V];
#pragma unroll
      for (int u = 0; u < kMacAhead; ++u) {
        if (p0 + u < p_hi) {
          const long long q = static_cast<long long>(k) * S + n;
          const long long h = static_cast<long long>(p0 + u) * S + n;
          load_bins<V>(queue + q, qr[u]);
          load_bins<V>(queue + plane + q, qi[u]);
          load_bins<V>(H + h, hr[u]);
          load_bins<V>(H + plane + h, hi[u]);
          k = (k == 0) ? P - 1 : k - 1;
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) qr[u][v] = qi[u][v] = hr[u][v] = hi[u][v] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kMacAhead; ++u) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          ar[v] += qr[u][v] * hr[u][v] - qi[u][v] * hi[u][v];
          ai[v] += qr[u][v] * hi[u][v] + qi[u][v] * hr[u][v];
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    part[0][g][v][x] = ar[v];
    part[1][g][v][x] = ai[v];
  }
  __syncthreads();
  // one thread an output of the tile: the groups' sums in group order
  constexpr int kOuts = 2 * kMacLanes * V;
  for (int o = g * kMacLanes + x; o < kOuts; o += kMacLanes * kMacSplit) {
    const int re_im = o / (kMacLanes * V), j = o % (kMacLanes * V);
    const int lane = j / V, v = j % V;
    float acc = part[re_im][0][v][lane];
#pragma unroll
    for (int gg = 1; gg < kMacSplit; ++gg) acc += part[re_im][gg][v][lane];
    if (tile + j < S) out[re_im * S + tile + j] = acc;
  }
}

template <typename Q, int V>
void launch_rotated_mac_as(const void* queue, const float* H, float* out,
                           int P, int slot, long long S, cudaStream_t stream) {
  const long long per_cta = static_cast<long long>(kMacLanes) * V;
  const dim3 block(kMacLanes, kMacSplit);
  rotated_mac_kernel<Q, V>
      <<<static_cast<unsigned>((S + per_cta - 1) / per_cta), block, 0,
         stream>>>(static_cast<const Q*>(queue), H, out, P, slot, S);
}

inline bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

inline unsigned blocks_for(long long S) {
  return static_cast<unsigned>((S + kThreads - 1) / kThreads);
}

// the vector path where every plane starts on a vector boundary
template <typename Q>
void launch_rotated_mac(const void* queue, const float* H, float* out, int P,
                        int slot, long long S, cudaStream_t stream) {
  if (S % kMacVec == 0 && aligned(queue, kMacVec * sizeof(Q)) &&
      aligned(H, kMacVec * sizeof(float)))
    launch_rotated_mac_as<Q, kMacVec>(queue, H, out, P, slot, S, stream);
  else
    launch_rotated_mac_as<Q, 1>(queue, H, out, P, slot, S, stream);
}

}  // namespace

extern "C" {

// xext [2, D, C, F] (D >= P + R), H [2, P, C, F] -> out [2, R, C, F]
int bbcat_head_mac(const float* xext, const float* H, float* out, int P,
                   int D, int R, int C, int F, cudaStream_t stream) {
  const long long S = static_cast<long long>(C) * F;
  if (P < 1 || R < 1 || D < P + R || S < 1 || R > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = (R == 1) ? 1 : (R <= 8 ? 8 : 16);
  const dim3 grid(blocks_for(S), (R + tile - 1) / tile);
  if (tile == 1)
    head_mac_kernel<1><<<grid, kThreads, 0, stream>>>(xext, H, out, P, D, R, S);
  else if (tile == 8)
    head_mac_kernel<8><<<grid, kThreads, 0, stream>>>(xext, H, out, P, D, R, S);
  else
    head_mac_kernel<16><<<grid, kThreads, 0, stream>>>(xext, H, out, P, D, R,
                                                       S);
  return static_cast<int>(cudaGetLastError());
}

// K9's schedule for its CPU model: lanes, groups, loads ahead, vector
int bbcat_rotated_mac_schedule(int which) {
  const int v[] = {kMacLanes, kMacSplit, kMacAhead, kMacVec};
  return (which >= 0 && which < 4) ? v[which] : -1;
}

// queue, H [2, P, C, F], 0 <= slot < P -> out [2, C, F]; the queue's
// type by code: 0 float32, 1 bfloat16, 2 float16
int bbcat_rotated_mac(const void* queue, const float* H, float* out, int P,
                      int C, int F, int slot, int qtype, cudaStream_t stream) {
  const long long S = static_cast<long long>(C) * F;
  switch (qtype) {
    case 0:
      launch_rotated_mac<float>(queue, H, out, P, slot, S, stream);
      break;
    case 1:
      launch_rotated_mac<__nv_bfloat16>(queue, H, out, P, slot, S, stream);
      break;
    case 2:
      launch_rotated_mac<__half>(queue, H, out, P, slot, S, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
