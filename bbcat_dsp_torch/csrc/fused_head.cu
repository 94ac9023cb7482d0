// Fused head of the two-level convolver (K1) for Hopper (sm_90a).
//
// Replaces fused_head_pallas in the JAX package's ops/pallas/fused_head.py.
// For each channel, over R small blocks x_i of B samples (n = 2B, F = B+1):
//   Xh_i   = rFFT_n([x_i, 0])                        half-window spectrum
//   W_i    = Xh_{i-1} + (-1)^k Xh_i                   window (shift theorem)
//   acc_i  = sum_p W_{i-p} * H[p]                     P-partition MAC
//   y_i    = last B samples of irFFT_n(acc_i)
// with W_{-1}.. taken from the carried windows and Xh_{-1} from ``prev``;
// the new carry is the last P windows and the last half spectrum.
//
// Bound: memory.  x and y (4CRB bytes each), H and both carries
// (8PCF bytes each) and both half spectra must move once: 25.4 MB at
// C = 64, P = 16, B = 512, R = 48, 7.6 us at 3.35 TB/s, against ~0.4 GFLOP
// (6 us at the card's float32 rate).  Time is not sequential: acc_i is an
// FIR over the block index, so every window depends on the input and the
// incoming carry alone, and all C x R transforms, then all C x R MACs and
// inverses, are independent.  What costs time is latency (the MAC's loads
// from L2, the transforms' exchanges), so the design puts all that work on
// the card at once, in two launches:
//
// 1. windows_kernel: one transform per (channel, block), 4 to a CTA at
//    B = 512.  W_i = Xh_{i-1} + (-1)^k Xh_i is the spectrum of [x_{i-1},
//    x_i], so block i > 0 takes one real n-point transform of its two
//    blocks of samples, as one complex B-point FFT of the packed pairs held
//    in registers (fft_common.cuh: radix 8, two exchanges at B = 512).
//    Block 0 transforms [x_0, 0] and adds ``prev``; one more transform of
//    [x_{R-1}, 0] gives the half spectrum to carry out.  Windows go to a
//    scratch [C, P + R, F] (complex; 16.8 MB at the shape above, inside
//    the 50 MB L2) behind the P carried windows, which the launch's last
//    CTAs copy in; the carry out is written from the same registers.
// 2. mac_inverse_kernel: one CTA per (channel, tile of 4 blocks) of B/2
//    threads, two bins each: the MAC over a register window that slides down the scratch
//    (window_mac.cuh: P + 3 windows and P filter bins read for 4 outputs,
//    in p = 0 .. P-1 order), then the 4 inverse transforms side by side,
//    and the last B samples of each.  The bin that F = B + 1 leaves over would
//    give one thread a third turn through the MAC, so a warp more takes
//    the Nyquist bin k = B, a lane per output, and leaves at the barrier
//    between the MAC and the inverses.
//
// Twiddles come from one table computed in double precision on the host.
// The imaginary parts of the DC and Nyquist bins are zero in every
// transform of real samples and are dropped on the way into the inverse
// (fft_common.cuh), as the inverse of a real transform defines them.
// R = 1 or R < P go the same way: the new carry then keeps P - R of the
// carried windows, moved up by the copying CTAs.

#include <cuda_runtime.h>

#include "fft_common.cuh"
#include "window_mac.cuh"

namespace {

using bbcat::CtaSync;
using bbcat::FirstThreadsSync;
using bbcat::fft_regs;
using bbcat::packed_bin;
using bbcat::PeriodTable;
using bbcat::real_bin;
using bbcat::window_mac;

constexpr int kWindowThreads = 256;  // windows_kernel: 256 / (B/8) transforms
constexpr int kAhead = 4;            // partitions whose loads go ahead
// Output blocks a CTA of phase 2: four, at B/8 threads a block; eight at
// B = 32, so that the blocks' threads fill a warp, and two at B = 1024.
// (At B = 512 on an H100, 4 and 8 take the same time at R = 48 and 4 is
// 7% faster at R = 8 and 1.)
template <int B>
constexpr int kTileOf = B > 512 ? 2 : (B < 64 ? 8 : 4);

// The table tw[m] = exp(-2 pi i m / 2B), m < 2B, into shared memory, by
// the CTA's first ``nthreads`` threads.
__device__ __forceinline__ void load_table(float2* tws, const float2* tw,
                                           int B, int nthreads) {
  for (int m = threadIdx.x; m < 2 * B; m += nthreads) tws[m] = tw[m];
}

template <int B>
__global__ void __launch_bounds__(kWindowThreads)
windows_kernel(const float* __restrict__ x,       // [C, R*B]
               const float* __restrict__ xcarry,  // [2, P, C, F]
               const float* __restrict__ prev,    // [2, C, F]
               const float2* __restrict__ tw,     // [2B]
               float2* __restrict__ win,          // [C, P+R, F] scratch
               float* __restrict__ xcarry_out,    // [2, P, C, F]
               float* __restrict__ prev_out,      // [2, C, F]
               int C, int P, int R, int nfft) {
  constexpr int F = B + 1;
  constexpr int T = B / 8;                 // threads a transform
  constexpr int TPC = kWindowThreads / T;  // transforms a CTA
  const size_t part = static_cast<size_t>(C) * F;  // partition stride
  const size_t plane = static_cast<size_t>(P) * part;

  if (static_cast<int>(blockIdx.x) >= nfft) {
    // the carried windows m = 0 .. P-1 into the scratch; those the new
    // carry keeps (m >= R) move up by R partitions
    const size_t o =
        static_cast<size_t>(blockIdx.x - nfft) * blockDim.x + threadIdx.x;
    if (o < plane) {
      const int p = static_cast<int>(o / part);
      const size_t ck = o - p * part;
      const int c = static_cast<int>(ck / F);
      const int k = static_cast<int>(ck - static_cast<size_t>(c) * F);
      const float2 v = make_float2(xcarry[o], xcarry[plane + o]);
      win[(static_cast<size_t>(c) * (P + R) + p) * F + k] = v;
      if (p >= R) {
        xcarry_out[o - R * part] = v.x;
        xcarry_out[plane + o - R * part] = v.y;
      }
    }
    return;
  }

  __shared__ float2 tws[2 * B];
  __shared__ float2 bufs[TPC * B];

  // a channel's items: j < R is block j's window; j == R (only when
  // R > 1) is the half spectrum of the last block, for the carry
  const int per_channel = R + (R > 1 ? 1 : 0);
  const int slot = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long item = static_cast<long long>(blockIdx.x) * TPC + slot;
  const bool live = item < static_cast<long long>(C) * per_channel;
  const int c = live ? static_cast<int>(item / per_channel) : 0;
  const int j = live ? static_cast<int>(item % per_channel) : 0;
  const bool half = (j == 0 || j == R);  // [x_j, 0], not [x_{j-1}, x_j]
  const int first = (j == R) ? R - 1 : (j == 0 ? 0 : j - 1);
  const float2* xp = reinterpret_cast<const float2*>(
      x + (static_cast<size_t>(c) * R + first) * B);
  float2* buf = bufs + slot * B;

  // z[e] = w[2e] + i w[2e+1] over the window's n samples, e = t + m T
  float2 v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int e = t + m * T;
    v[m] = (half && e >= B / 2) ? make_float2(0.0f, 0.0f) : xp[e];
  }
  load_table(tws, tw, B, kWindowThreads);  // behind the samples' loads; first read after
                           // the transform's first exchange
  fft_regs<B>(v, buf, PeriodTable<2 * B>{tws}, t, CtaSync());
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 8; ++m) buf[t + m * T] = v[m];
  __syncthreads();
  if (!live) return;

  const size_t cf = static_cast<size_t>(c) * F;
  const int q = P + j - R;  // the window's partition in the new carry
#pragma unroll
  for (int m = 0; m <= 8; ++m) {
    if (m == 8 && t != 0) break;  // thread 0 takes the Nyquist bin
    const int k = (m == 8) ? B : t + m * T;
    float2 w = real_bin(buf, k, B, tws[k]);
    if (j == R || R == 1) {
      prev_out[cf + k] = w.x;
      prev_out[part + cf + k] = w.y;
      if (j == R) continue;
    }
    if (j == 0) {
      const float sg = (k & 1) ? -1.0f : 1.0f;
      w = make_float2(prev[cf + k] + sg * w.x, prev[part + cf + k] + sg * w.y);
    }
    win[(static_cast<size_t>(c) * (P + R) + P + j) * F + k] = w;
    if (q >= 0) {
      xcarry_out[q * part + cf + k] = w.x;
      xcarry_out[plane + q * part + cf + k] = w.y;
    }
  }
}

// History of one bin for window_mac: entry d is window P + i0 - d of the
// channel's scratch; windows past the last block's read as zero.
struct WindowAt {
  const float2* base;  // the bin of window P + i0
  int newest;          // windows after P + i0 that exist: R - 1 - i0
  int stride;          // F, from one window to the next
  __device__ __forceinline__ float2 operator()(int d) const {
    return (-d <= newest) ? base[-static_cast<long long>(d) * stride]
                          : make_float2(0.0f, 0.0f);
  }
};

struct FilterAt {
  const float* re;  // the bin of partition 0
  size_t part, plane;
  __device__ __forceinline__ float2 operator()(int p) const {
    return make_float2(re[p * part], re[plane + p * part]);
  }
};

template <int B>
__global__ void __launch_bounds__(kTileOf<B> * (B / 8) + 32)
mac_inverse_kernel(const float2* __restrict__ win,  // [C, P+R, F]
                   const float* __restrict__ H,     // [2, P, C, F]
                   const float2* __restrict__ tw,   // [2B]
                   float* __restrict__ y,           // [C, R*B]
                   int C, int P, int R) {
  constexpr int F = B + 1;
  constexpr int T = B / 8;
  constexpr int RT = kTileOf<B>;
  constexpr int NT = RT * T;  // a multiple of 32: B >= 32
  extern __shared__ float2 smem[];
  float2* tws = smem;           // [2B]
  float2* accs = smem + 2 * B;  // [RT, F] spectra, then the FFTs' buffers
  const int c = blockIdx.x;
  const int i0 = blockIdx.y * RT;
  const size_t part = static_cast<size_t>(C) * F;
  const float2* wc = win + (static_cast<size_t>(c) * (P + R) + P + i0) * F;
  const float* hc = H + static_cast<size_t>(c) * F;
  const size_t plane = static_cast<size_t>(P) * part;

  if (threadIdx.x >= NT) {
    // the last warp: lane r takes the Nyquist bin of output i0 + r, so
    // the bins' threads need no second turn
    const int r = threadIdx.x - NT;
    if (r < RT) {
      float2 acc[1] = {make_float2(0.0f, 0.0f)};
      const WindowAt xw{wc + static_cast<size_t>(r) * F + B, R - 1 - i0 - r,
                        F};
      window_mac<1, kAhead>(acc, P, xw, FilterAt{hc + B, part, plane});
      accs[r * F + B] = acc[0];
    }
    __syncthreads();
    return;
  }
  for (int k = threadIdx.x; k < B; k += NT) {
    float2 acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = make_float2(0.0f, 0.0f);
    window_mac<RT, kAhead>(acc, P, WindowAt{wc + k, R - 1 - i0, F},
                              FilterAt{hc + k, part, plane});
#pragma unroll
    for (int r = 0; r < RT; ++r) accs[r * F + k] = acc[r];
  }
  load_table(tws, tw, B, NT);
  __syncthreads();

  // inverse of block i0 + r by threads r T .. r T + T - 1: the forward
  // transform of the packed spectrum with re and im swapped
  const int r = threadIdx.x / T;
  const int t = threadIdx.x % T;
  float2* buf = accs + r * F;
  float2 v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int k = t + m * T;
    const float2 z = packed_bin(buf[k], buf[B - k], k, tws[k]);
    v[m] = make_float2(z.y, z.x);
  }
  fft_regs<B>(v, buf, PeriodTable<2 * B>{tws}, t, FirstThreadsSync<NT>());
  if (i0 + r >= R) return;
  // z[e] = (y[2e], y[2e+1]) B over the n-window; overlap-save keeps its
  // last B samples, e = B/2 .. B-1: the registers m = 4 .. 7
  float2* yp = reinterpret_cast<float2*>(
      y + (static_cast<size_t>(c) * R + i0 + r) * B);
  const float scale = 1.0f / B;
#pragma unroll
  for (int m = 4; m < 8; ++m)
    yp[t + (m - 4) * T] = make_float2(v[m].y * scale, v[m].x * scale);
}

template <int B>
int launch(const float* x, const float* xcarry, const float* prev,
           const float* H, const float2* tw, float* y, float* xcarry_out,
           float* prev_out, float2* win, int C, int P, int R,
           cudaStream_t stream) {
  constexpr int T = B / 8;
  constexpr int TPC = kWindowThreads / T;
  constexpr int RT = kTileOf<B>;
  const long long items = static_cast<long long>(C) * (R + (R > 1 ? 1 : 0));
  const int nfft = static_cast<int>((items + TPC - 1) / TPC);
  const long long ncopy =
      (static_cast<long long>(P) * C * (B + 1) + kWindowThreads - 1) /
      kWindowThreads;
  if (nfft + ncopy > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  windows_kernel<B><<<static_cast<unsigned>(nfft + ncopy), kWindowThreads, 0,
                      stream>>>(
      x, xcarry, prev, tw, win, xcarry_out, prev_out, C, P, R, nfft);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const size_t smem = (2 * B + static_cast<size_t>(RT) * (B + 1)) *
                      sizeof(float2);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(mac_inverse_kernel<B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(C, (R + RT - 1) / RT);
  mac_inverse_kernel<B><<<grid, RT * T + 32, smem, stream>>>(win, H, tw, y,
                                                                C, P, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Block B a power of two in [32, 1024]; any C, P, R >= 1 (R <= 4 * 65535).
// tw is the [2B] complex table exp(-2 pi i m / 2B); win a scratch of
// C (P + R) (B + 1) complex values.
int bbcat_fused_head(const float* x, const float* xcarry, const float* prev,
                     const float* H, const void* tw, float* y,
                     float* xcarry_out, float* prev_out, void* win, int C,
                     int P, int B, int R, cudaStream_t stream) {
  if (C < 1 || P < 1 || R < 1 || R > 4 * 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* twp = static_cast<const float2*>(tw);
  float2* winp = static_cast<float2*>(win);
  switch (B) {
#define BBCAT_HEAD_CASE(N)                                                  \
  case N:                                                                   \
    return launch<N>(x, xcarry, prev, H, twp, y, xcarry_out, prev_out, winp, \
                     C, P, R, stream)
    BBCAT_HEAD_CASE(32);
    BBCAT_HEAD_CASE(64);
    BBCAT_HEAD_CASE(128);
    BBCAT_HEAD_CASE(256);
    BBCAT_HEAD_CASE(512);
    BBCAT_HEAD_CASE(1024);
#undef BBCAT_HEAD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
