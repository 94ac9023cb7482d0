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
// convolvers' dtype): a template over the queue's element type, each value
// widened to float32 as it is loaded; H, the sums and the output stay
// float32.  One thread per (c, f), p in the reference's order.  Bound:
// memory.  A narrow queue halves its share of the bytes: at P = 64,
// C = 64, F = 513 the queue is 16.8 MB in float32 and 8.4 MB narrow, of
// 33.9 and 25.5 MB that the launch moves.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename Q>
__global__ void rotated_mac_kernel(const Q* __restrict__ queue,
                                   const float* __restrict__ H,
                                   float* __restrict__ out, int P, int slot,
                                   long long S) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (n >= S) return;
  const long long plane = static_cast<long long>(P) * S;
  float ar = 0.0f, ai = 0.0f;
  int k = slot;  // (slot - p) mod P
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    const long long q = static_cast<long long>(k) * S + n;
    const long long h = static_cast<long long>(p) * S + n;
    const float qr = widen(queue[q]), qi = widen(queue[plane + q]);
    const float gr = H[h], gi = H[plane + h];
    ar += qr * gr - qi * gi;
    ai += qr * gi + qi * gr;
    k = (k == 0) ? P - 1 : k - 1;
  }
  out[n] = ar;
  out[S + n] = ai;
}

inline unsigned blocks_for(long long S) {
  return static_cast<unsigned>((S + kThreads - 1) / kThreads);
}

template <typename Q>
void launch_rotated_mac(const void* queue, const float* H, float* out, int P,
                        int slot, long long S, cudaStream_t stream) {
  rotated_mac_kernel<Q><<<blocks_for(S), kThreads, 0, stream>>>(
      static_cast<const Q*>(queue), H, out, P, slot, S);
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
