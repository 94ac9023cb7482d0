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
// W_i = Xh_{i-1} + (-1)^k Xh_i is the spectrum of [x_{i-1}, x_i], so block
// i > 0 takes one real n-point transform of its two blocks of samples, as
// one complex B-point FFT of the packed pairs held in registers
// (fft_common.cuh: radix 8, two exchanges at B = 512); block 0 transforms
// [x_0, 0] and adds ``prev``.  acc_i is an FIR over the block index, so
// every window depends on the input and the incoming carry alone.
//
// Two schedules, which the caller picks from the shape and the card
// (ops/kernels/fused_head.py::fused_head_schedule):
//
// The windowed schedule (C = 64, R = 48: the headline render; R = 8: the
// streaming super-step).  Bound: memory, x and y (4CRB bytes each), H and
// both carries (8PCF bytes each) and both half spectra once: 25.7 MB, 7.7
// us at 3.35 TB/s, against 0.38 GFLOP.  What costs time there is latency
// (the MAC's loads from L2, the transforms' exchanges), so the design puts
// all of the call's work on the card at once, in two launches:
// 1. windows_kernel: one transform per (channel, block), 4 to a CTA at
//    B = 512; one more of [x_{R-1}, 0] gives the half spectrum to carry
//    out.  Windows go to a scratch [C, P + R, F] (complex; 16.8 MB at the
//    shape above, inside the 50 MB L2) behind the P carried windows, which
//    the launch's last CTAs copy in; the carry out is written from the
//    same registers.
// 2. mac_inverse_kernel: one CTA per (channel, tile of 4 blocks) of B/2
//    threads, two bins each: the MAC over a register window that slides
//    down the scratch (window_mac.cuh: P + 3 windows and P filter bins read
//    for 4 outputs, in p = 0 .. P-1 order), then the 4 inverse transforms
//    side by side, and the last B samples of each.  The bin that F = B + 1
//    leaves over would give one thread a third turn through the MAC, so a
//    warp more takes the Nyquist bin k = B, a lane per output, and leaves
//    at the barrier between the MAC and the inverses.
// R = 1 or R < P go the same way: the new carry then keeps P - R of the
// carried windows, moved up by the copying CTAs.
//
// The resident schedule (C = 1024, R = 112: BASELINE config #5's render).
// There the scratch is 538 MB, 11x the L2, and the windowed grid runs a
// channel's 28 tiles in 28 waves, each of which reads all of H and the
// windows of every channel again from HBM.  With 7.8 channels an SM the
// card is full without spreading a channel across the grid, so one CTA
// takes one channel and keeps it in shared memory: its filter [P, F]
// (65.7 KB at P = 16, B = 512), read from HBM once, and a ring of windows.
// HBM then moves x, y, H and the carries once (679.9 MB at config #5,
// 0.203 ms at 3.35 TB/s) and no scratch, against 14.23 GFLOP of
// transforms and MAC (0.212 ms at 67 TFLOP/s): the arithmetic, float32 on
// the CUDA cores, bounds it.  What keeps K1 from that bound is latency:
// 230 KB of shared memory leave one CTA an SM, each transform waits at four
// to six barriers of its two warps (B = 512: two exchanges, the bins' pass),
// and done in turn (a tile's transforms, its MAC, its inverses, each phase
// behind a barrier of the whole CTA) the FMA-bound MAC and the
// barrier-bound transforms never run at once: 17 warps, 0.98 ms.
//
// So the CTA is a pipeline of two warp-specialised roles.  The consumer
// (RT = 8 transforms of B/8 threads and the Nyquist warp, 17 warps) runs
// tile n's MAC over the ring (window_mac.cuh, p ascending, each complex
// product as four fused multiply-adds; the Nyquist warp as above) into
// the tile's spectra, then its RT inverses.  The producer (RT/2
// transforms, 8 warps) meanwhile puts tile n + 1's windows into the ring,
// two turns of four, each transform exchanging through the slot it fills
// (the bins' pass reads and writes each pair k, B - k in place), so it
// needs no buffer of its own.  The ring holds P + 2 RT - 1 windows (127.2
// KB): the ones tile n's MAC reads and tile n + 1's.  One barrier of the
// whole CTA a tile (the hand-off) is all the two share; inside each role
// a transform's barriers are its own (named 1 .. 12) and the consumer's
// MAC and inverses meet at one barrier of its 544 threads.  The consumer
// transforms tile 0 while the producer starts on tile 1, and the producer
// transforms the half spectrum of [x_{R-1}, 0] for the carry out beside
// the last tile's MAC.  25 warps an SM; 230 KB of shared memory with the
// stages' twiddles (the bins' twiddles come through the read-only cache).
// At config #5 the consumer alone takes 0.70 ms and the producer alone
// 0.42; the two together 0.82 (26% of the bound), where the three phases
// in turn took 0.98.
//
// Twiddles come from one table computed in double precision on the host.
// The imaginary parts of the DC and Nyquist bins are zero in every
// transform of real samples and are dropped on the way into the inverse
// (fft_common.cuh), as the inverse of a real transform defines them.

#include <cuda_pipeline.h>
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
using bbcat::Swizzled;
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
int launch_windowed(const float* x, const float* xcarry, const float* prev,
                    const float* H, const float2* tw, float* y,
                    float* xcarry_out, float* prev_out, float2* win, int C,
                    int P, int R, cudaStream_t stream) {
  constexpr int T = B / 8;
  constexpr int TPC = kWindowThreads / T;
  constexpr int RT = kTileOf<B>;
  if (win == nullptr || R > RT * 65535)
    return static_cast<int>(cudaErrorInvalidValue);
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

// ---- the resident schedule ---------------------------------------------------

// Output blocks a tile of the resident schedule: eight, two at B = 1024.
__host__ __device__ constexpr int resident_tile(int B) {
  return B > 512 ? 2 : 8;
}

// Transforms the producer runs side by side: half the tile's (two turns a
// tile), and at least a warp's threads (B/8 a transform).
__host__ __device__ constexpr int resident_producers(int B) {
  const int want = resident_tile(B) / 2;
  const int warp = (32 + B / 8 - 1) / (B / 8);
  const int n = want > warp ? want : warp;
  return n < resident_tile(B) ? n : resident_tile(B);
}

// The CTA: the consumer (the tile's transforms and a warp for the Nyquist
// bins) and the producer.
__host__ __device__ constexpr int resident_consumers(int B) {
  return resident_tile(B) * (B / 8) + 32;
}
__host__ __device__ constexpr int resident_threads(int B) {
  return resident_consumers(B) + resident_producers(B) * (B / 8);
}

// Entries of the stages' twiddle tables (fft_common.cuh's StageTables
// layout, 8 points a thread).
__host__ __device__ constexpr int resident_stage_entries(int B) {
  int n = 0;
  for (int ns = 8; ns < B; ns *= 8)
    n += (bbcat::stage_radix(B, 8, ns) - 1) * ns;
  return n;
}

// Its shared memory: the stages' twiddles, the filter [P, F], the ring of
// P + 2 RT - 1 windows and the tile's spectra [RT, F], all complex.
__host__ __device__ constexpr long long resident_smem(int P, int B) {
  return (resident_stage_entries(B) +
          (2LL * P + 3LL * resident_tile(B) - 1) * (B + 1)) *
         8;
}

// The stages' twiddles in shared memory, in fft_common.cuh's StageTables
// layout: stage NS's factors exp(-2 pi i q k / (NS R)) at (q - 1) NS + k,
// so that a warp reads consecutive entries.  (The period table's entries
// q k 2B / (NS R) fall 4 or 8 to a bank.)
template <int B>
struct SharedStageTables {
  const float2* tw;
  template <int NS, int R>
  __device__ __forceinline__ float2 get(int q, int k) const {
    return tw[bbcat::stage_tables_size<B, 8, NS>() + (q - 1) * NS + k];
  }
};

// The stages' twiddles from the period table tw [2B] in device memory, by
// all ``nthreads`` threads of the CTA.
template <int B>
__device__ __forceinline__ void load_stage_tables(float2* stw,
                                                  const float2* tw,
                                                  int nthreads) {
  for (int o = threadIdx.x; o < resident_stage_entries(B); o += nthreads) {
    int ns = 8, at = 0;  // stage ns's table starts at ``at``
    for (;;) {
      const int R = bbcat::stage_radix(B, 8, ns);
      if (o < at + (R - 1) * ns) {
        const int q = 1 + (o - at) / ns;
        const int k = (o - at) % ns;
        stw[o] = tw[q * k * (2 * B / (ns * R))];
        break;
      }
      at += (R - 1) * ns;
      ns *= R;
    }
  }
}

// History of one bin for window_mac from the ring: entry d is the window
// d before the one in slot ``base``; window m lies in slot m mod S.
template <int F>
struct RingAt {
  const float2* bin;  // the bin in slot 0
  int base, slots;
  __device__ __forceinline__ float2 operator()(int d) const {
    int s = base - d;  // -S < s < 2S: -(RT - 1) <= d < P
    s += (s < 0) ? slots : 0;
    s -= (s >= slots) ? slots : 0;
    return bin[s * F];
  }
};

template <int F>
struct SharedFilterAt {
  const float2* bin;  // the bin of partition 0
  __device__ __forceinline__ float2 operator()(int p) const {
    return bin[p * F];
  }
};

// A barrier of one transform's T threads (a multiple of 32 from B = 256
// on) named ``id``; below that, of the N threads of all the transforms
// that share ``id``.
template <int B, int N>
struct TransformSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    if constexpr (B >= 256)
      asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(B / 8) : "memory");
    else
      asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(N) : "memory");
  }
};

// Named barrier ID of N threads (whole warps): a role's, or the CTA's.
template <int ID, int N>
struct NamedSync {
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(N) : "memory");
  }
};

// Thread t's pairs z[e] = (w[2e], w[2e+1]), e = t + m T, of the n-window
// whose first block is block ``first`` of the channel's samples ``xr``:
// with ``half`` its upper half is zero, and an item that is not ``live``
// is zero throughout.
template <int B>
__device__ __forceinline__ void load_pairs(float2 (&v)[8], const float* xr,
                                           int first, bool half, bool live,
                                           int t) {
  constexpr int T = B / 8;
  const float2* xp =
      reinterpret_cast<const float2*>(xr + static_cast<size_t>(first) * B);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int e = t + m * T;
    v[m] = (!live || (half && e >= B / 2)) ? make_float2(0.0f, 0.0f) : xp[e];
  }
}

// The bins of the real n-point transform whose packed transform thread t
// holds in v, to ``put(k, X[k])``: the pairs k, B - k for k = t + m T < B/2
// (k = 0 gives DC and Nyquist) and, by thread 0, the middle bin B/2.  The
// transform goes through buf [B] in natural order; each thread reads and
// puts only its own pairs' places, so ``put`` may write buf in place.
template <int B, typename Sync, typename Put>
__device__ __forceinline__ void put_pairs(const float2 (&v)[8], float2* buf,
                                          const float2* tw, int t,
                                          const Sync& bar, const Put& put) {
  constexpr int T = B / 8;
  bar();  // the transform's last exchange's readers are done
#pragma unroll
  for (int m = 0; m < 8; ++m) buf[t + m * T] = v[m];
  bar();
  float2 zk[4], zc[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = t + m * T;
    zk[m] = buf[k];
    zc[m] = buf[(B - k) & (B - 1)];
  }
  const float2 mid = (t == 0) ? buf[B / 2] : make_float2(0.0f, 0.0f);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int k = t + m * T;
    float2 xk, xmk;
    bbcat::real_bin_pair(zk[m], zc[m], k, __ldg(tw + k), xk, xmk);
    put(k, xk);
    put(B - k, xmk);
  }
  if (t == 0) put(B / 2, make_float2(mid.x, -mid.y));  // conj(Z[B/2])
}

// One CTA a channel, in two roles.  The consumer (the first
// resident_consumers(B) threads) takes tile n's MAC over the ring and its
// inverses; the producer (the rest) meanwhile puts tile n + 1's windows
// into the ring, each transform exchanged through the slot it fills.  The
// ring's P + 2 RT - 1 slots hold tile n's MAC's windows and tile n + 1's
// at once, so one hand-off a tile, a barrier of the whole CTA, keeps the
// two apart.  The consumer transforms tile 0 itself, while the producer
// starts on tile 1; after its last tile the producer transforms the half
// window of the carry out, in the slots of a tile that no MAC reads.
template <int B>
__global__ void __launch_bounds__(resident_threads(B), 1)
resident_kernel(const float* __restrict__ x,       // [C, R*B]
                const float* __restrict__ xcarry,  // [2, P, C, F]
                const float* __restrict__ prev,    // [2, C, F]
                const float* __restrict__ H,       // [2, P, C, F]
                const float2* __restrict__ tw,     // [2B]
                float* __restrict__ y,             // [C, R*B]
                float* __restrict__ xcarry_out,    // [2, P, C, F]
                float* __restrict__ prev_out,      // [2, C, F]
                int C, int P, int R) {
  constexpr int F = B + 1;
  constexpr int T = B / 8;
  constexpr int RT = resident_tile(B);
  constexpr int NPR = resident_producers(B);  // producer transforms
  constexpr int ROUNDS = RT / NPR;
  constexpr int NT = RT * T;                  // the consumer's transforms
  constexpr int NC = resident_consumers(B);   // and its Nyquist warp
  constexpr int NTH = resident_threads(B);
  // named barriers: 1 .. RT the consumer's transforms, RT + 1 .. the
  // producer's (1 and 2 below B = 256), then these two
  static_assert(B < 256 || RT + NPR <= 13, "barrier ids");
  static_assert(NTH <= 1024 && NT % 32 == 0 && (NPR * T) % 32 == 0, "warps");
  const NamedSync<14, NTH> handoff;  // the whole CTA, once a tile
  const NamedSync<15, NC> consumer;  // the consumer alone
  const int S = P + 2 * RT - 1;      // ring slots
  extern __shared__ float2 smem[];
  float2* stw = smem;                                        // stage twiddles
  float2* hs = stw + resident_stage_entries(B);              // [P, F]
  float2* ring = hs + static_cast<size_t>(P) * F;            // [S, F]
  float2* bufs = ring + static_cast<size_t>(S) * F;          // [RT, F]
  const int c = blockIdx.x;
  const size_t part = static_cast<size_t>(C) * F;
  const size_t plane = static_cast<size_t>(P) * part;
  const size_t cf = static_cast<size_t>(c) * F;
  const float* xr = x + static_cast<size_t>(c) * R * B;
  const int tid = threadIdx.x;
  const int ntiles = (R + RT - 1) / RT;

  load_stage_tables<B>(stw, tw, NTH);
  __syncthreads();

  if (tid < NC) {
    const bool fft_thread = tid < NT;
    const int r = tid / T;  // the thread's block in a tile
    const int t = tid % T;
    float2* buf = bufs + r * F;
    const TransformSync<B, NT> bar{B >= 256 ? 1 + r : 1};
    // The filter and the carried windows 1 .. P-1 (window m in slot m; no
    // output reads window 0, nor does the new carry) copy in behind tile
    // 0's transforms, which write slots P .. P + RT - 1.
    for (int o = tid; o < P * F; o += NC) {
      const int p = o / F;
      const size_t g = p * part + cf + (o - p * F);
      __pipeline_memcpy_async(&hs[o].x, H + g, 4);
      __pipeline_memcpy_async(&hs[o].y, H + plane + g, 4);
      if (p > 0) {
        __pipeline_memcpy_async(&ring[o].x, xcarry + g, 4);
        __pipeline_memcpy_async(&ring[o].y, xcarry + plane + g, 4);
      }
    }
    __pipeline_commit();
    if (fft_thread) {
      // window P + r, of block r: [x_0, 0] and ``prev`` for r = 0
      float2 v[8];
      load_pairs<B>(v, xr, r > 0 ? r - 1 : 0, r == 0, r < R, t);
      float2* slot = ring + static_cast<size_t>(P + r) * F;
      fft_regs<B>(v, slot, SharedStageTables<B>{stw}, t, bar, Swizzled<8>());
      put_pairs<B>(v, slot, tw, t, bar, [&](int k, float2 w) {
        if (r == 0) {
          const float sg = (k & 1) ? -1.0f : 1.0f;
          w = make_float2(prev[cf + k] + sg * w.x,
                          prev[part + cf + k] + sg * w.y);
        }
        slot[k] = w;
      });
    }
    __pipeline_wait_prior(0);
    consumer();

    for (int i0 = 0; i0 < R; i0 += RT) {
      if (i0 > 0) handoff();  // the producer has put tile i0's windows
      // the MAC of outputs i0 .. i0 + RT - 1 into bufs
      const int base = (P + i0) % S;  // the slot of window P + i0
      if (fft_thread) {
        for (int k = tid; k < B; k += NT) {
          float2 acc[RT];
#pragma unroll
          for (int q = 0; q < RT; ++q) acc[q] = make_float2(0.0f, 0.0f);
          window_mac<RT, kAhead, true>(acc, P, RingAt<F>{ring + k, base, S},
                                       SharedFilterAt<F>{hs + k});
#pragma unroll
          for (int q = 0; q < RT; ++q) bufs[q * F + k] = acc[q];
        }
      } else if (tid - NT < RT) {
        // lane q: the Nyquist bin of output i0 + q
        const int q = tid - NT;
        float2 acc[1] = {make_float2(0.0f, 0.0f)};
        window_mac<1, kAhead, true>(
            acc, P, RingAt<F>{ring + B, base + q - (base + q >= S ? S : 0), S},
            SharedFilterAt<F>{hs + B});
        bufs[q * F + B] = acc[0];
      }
      consumer();

      if (fft_thread) {
        // the inverse of output i0 + r: the forward transform of the
        // packed spectrum with re and im swapped
        float2 v[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int k = t + m * T;
          const float2 z = packed_bin(buf[k], buf[B - k], k, __ldg(tw + k));
          v[m] = make_float2(z.y, z.x);
        }
        fft_regs<B>(v, buf, SharedStageTables<B>{stw}, t, bar, Swizzled<8>());
        if (i0 + r < R) {
          float2* yp = reinterpret_cast<float2*>(
              y + (static_cast<size_t>(c) * R + i0 + r) * B);
          const float scale = 1.0f / B;
#pragma unroll
          for (int m = 4; m < 8; ++m)
            yp[t + (m - 4) * T] = make_float2(v[m].y * scale, v[m].x * scale);
        }
      }
    }
  } else {
    const int g = (tid - NC) / T;  // the thread's transform
    const int t = (tid - NC) % T;
    const TransformSync<B, NPR * T> bar{B >= 256 ? 1 + RT + g : 2};
    // tile i0 / RT's blocks i0 + h NPR + g, h < ROUNDS, from tile 1 on
    for (int i0 = RT; i0 < R; i0 += RT) {
      for (int h = 0; h < ROUNDS; ++h) {
        const int j = i0 + h * NPR + g;
        float2* slot = ring + static_cast<size_t>((P + j) % S) * F;
        float2 v[8];
        load_pairs<B>(v, xr, j - 1, false, j < R, t);
        fft_regs<B>(v, slot, SharedStageTables<B>{stw}, t, bar,
                    Swizzled<8>());
        put_pairs<B>(v, slot, tw, t, bar,
                     [&](int k, float2 w) { slot[k] = w; });
      }
      handoff();  // tile i0 / RT's windows are in
    }
    // the half window [x_{R-1}, 0] for the carry out (transform g = 0; the
    // others' pairs are zero), in the slot of window P + ntiles RT + g:
    // its window, at most (ntiles - 1) RT, is read by no MAC still to come
    // nor by the carry
    float2* slot = ring + static_cast<size_t>((P + ntiles * RT + g) % S) * F;
    float2 v[8];
    load_pairs<B>(v, xr, R - 1, true, g == 0, t);
    fft_regs<B>(v, slot, SharedStageTables<B>{stw}, t, bar, Swizzled<8>());
    put_pairs<B>(v, slot, tw, t, bar, [&](int k, float2 w) {
      if (g == 0) {
        prev_out[cf + k] = w.x;
        prev_out[part + cf + k] = w.y;
      }
    });
  }

  // the new carry, windows R .. P + R - 1, from the ring
  __syncthreads();
  for (int q = 0, s = R % S; q < P; ++q, s = (s + 1 == S) ? 0 : s + 1) {
    const float2* w = ring + static_cast<size_t>(s) * F;
    for (int k = tid; k < F; k += NTH) {
      xcarry_out[q * part + cf + k] = w[k].x;
      xcarry_out[plane + q * part + cf + k] = w[k].y;
    }
  }
}

template <int B>
int launch_resident(const float* x, const float* xcarry, const float* prev,
                    const float* H, const float2* tw, float* y,
                    float* xcarry_out, float* prev_out, int C, int P, int R,
                    cudaStream_t stream) {
  const long long smem = resident_smem(P, B);
  if (smem > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      resident_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  resident_kernel<B><<<C, resident_threads(B), static_cast<size_t>(smem),
                       stream>>>(x, xcarry, prev, H, tw, y, xcarry_out,
                                 prev_out, C, P, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1 in one schedule (0 windowed, 1 resident).  Block B a power of two in
// [32, 1024]; any C, P, R >= 1 (the windowed one 65535 tiles of R).  tw is
// the [2B] complex table exp(-2 pi i m / 2B); win the windowed schedule's
// scratch of C (P + R) (B + 1) complex values (null for the resident one,
// which needs resident_smem(P, B) bytes of shared memory: where the card
// has less, the launch fails in cudaFuncSetAttribute).
int bbcat_fused_head(const float* x, const float* xcarry, const float* prev,
                     const float* H, const void* tw, float* y,
                     float* xcarry_out, float* prev_out, void* win, int C,
                     int P, int B, int R, int schedule, cudaStream_t stream) {
  if (C < 1 || P < 1 || R < 1 || (schedule != 0 && schedule != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* twp = static_cast<const float2*>(tw);
  float2* winp = static_cast<float2*>(win);
  switch (B) {
#define BBCAT_HEAD_CASE(N)                                                   \
  case N:                                                                    \
    return schedule == 1                                                     \
               ? launch_resident<N>(x, xcarry, prev, H, twp, y, xcarry_out,  \
                                    prev_out, C, P, R, stream)               \
               : launch_windowed<N>(x, xcarry, prev, H, twp, y, xcarry_out,  \
                                    prev_out, winp, C, P, R, stream)
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
