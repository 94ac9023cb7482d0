// Half-window transforms of the tail, standard bin order (K3, K4), for
// Hopper (sm_90a).
//
// Replace perm_rfft_half_pallas and perm_irfft_tail_pallas in the JAX
// package's ops/pallas/perm_fft.py.  Those compute the tail's transforms
// in a permuted bin order that suits the TPU's matrix unit; these compute
// the same transforms in natural bin order, the one layout of the port.
// For every row of h = n/2 samples (F = h + 1 bins):
//   bbcat_rfft_half   Xh = rFFT_n([x, 0])               the half spectrum
//   bbcat_irfft_tail  y  = last h samples of irFFT_n(X)  DC/Nyquist imag dropped
// over re/im planes [2, rows, F].
//
// Bound: bytes.  Each row is read and written once (at the render's 384
// rows of 4096 samples, 6.3 MB one way and 12.6 MB the other) and the
// arithmetic is a fiftieth of what the card does in that time, so what a
// design can lose is time between the two: passes over the row in shared
// memory, barriers, and SMs that wait for a straggling row.
//
// Design.  The real n-point transform runs as one complex h-point FFT of
// the packed sample pairs, held in registers (fft_common.cuh): h/NP
// threads a row, NP = 16 points a thread from h = 1024 on and 8 below,
// Stockham stages of radix NP (a smaller last one), so h = 4096 = 16^3
// meets shared memory in two exchanges, as h = 512 = 8^3 does, where
// radix-2 passes took 12 barriers; the exchange buffer, h complex values a
// row, is swizzled so that no stage's writes or reads meet a bank
// conflict.  What is known beforehand is not computed: the forward
// transform's upper half of the window is zero, so each thread loads half
// its points and the first stage is a butterfly of its lower inputs; of
// the inverse only the tail half is wanted, the upper half of each
// thread's registers after the last stage, and the rest of that stage
// falls away.  Rows go to CTAs by size: one row a CTA from h = 4096 on,
// and below as many rows as fill a warp, then up to 256 threads once there
// are rows enough to give every SM two CTAs, so that 64 rows of h = 512
// still spread over 64 SMs and 3072 fill the card.  At h = 4096 a CTA is
// 256 threads of at most 80 registers and 32 KB, three to an SM: the
// render's 384 rows are on the card at once.  Twiddles come from a host
// table computed in double precision, one table a stage laid out as the
// stage reads it, through the read-only cache.  Rows of samples are
// 8-byte aligned runs and move as float2; the planes' rows are h + 1
// floats, so bins move as scalars, a warp on consecutive addresses.  The
// forward transform's unpacking needs Z[k] and Z[h-k] together and gives
// X[k] and X[h-k] at once, for half an exchange more; the inverse packs
// X[k] and X[h-k] straight from device memory (the second read of a bin
// hits the L1 cache).
//
// No tensor cores: the contract is >= 110 dB against the plain float32
// version (these kernels measure 131 to 140 dB on an H100, float32
// throughout), a TF32 product keeps 10 mantissa bits, so a DFT by matrix
// products (the TPU kernel's route, there with a three-way bf16 split)
// would need the same split here, and arithmetic is not what binds.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

using bbcat::CtaSync;
using bbcat::fft_regs;
using bbcat::packed_bin;
using bbcat::real_bin_pair;
using bbcat::stage_tables_size;
using bbcat::StageTables;
using bbcat::Swizzled;

constexpr int kPackThreads = 256;  // small rows share a CTA of this size
constexpr int kSpreadCtas = 264;   // two CTAs an SM before rows are packed

// Points a thread holds (ops/kernels/half_fft.py lays the twiddles out for
// the same), threads a row, and a CTA's size.
template <int H>
constexpr int kPoints = H >= 1024 ? 16 : 8;
template <int H>
constexpr int kRowThreads = H / kPoints<H>;
template <int H>
constexpr int kMaxThreads =
    kRowThreads<H> > kPackThreads ? kRowThreads<H> : kPackThreads;
// CTAs an SM that the register count must leave room for.  With 16 points
// a thread the compiler takes up to 190 registers if it may; 80 hold the
// transform without a spill and let three CTAs of 256 threads share an SM,
// so that the render's 384 rows of h = 4096 are on the card at once.
template <int H>
constexpr int kMinCtas = (kPoints<H> == 16 && kMaxThreads<H> == 256) ? 3 : 1;

// Rows a CTA: as many as fill a warp, then doubled up to kPackThreads
// while the launch still has kSpreadCtas CTAs.
int rows_per_cta(int M, int T) {
  const int cap = kPackThreads / T > 1 ? kPackThreads / T : 1;
  int r = 32 / T > 1 ? 32 / T : 1;
  while (2 * r <= cap && 2 * r <= M / kSpreadCtas) r *= 2;
  return r;
}

// tw: the stages' twiddle tables (fft_common.cuh: StageTables), then
// exp(-2 pi i k / 2H) for k = 0 .. H, the real transform's
template <int H>
__global__ void __launch_bounds__(kMaxThreads<H>, kMinCtas<H>)
rfft_half_kernel(const float* __restrict__ x,    // [M, H]
                 const float2* __restrict__ tw,  // stage tables, [H + 1]
                 float* __restrict__ out,        // [2, M, H+1]
                 int M) {
  constexpr int NP = kPoints<H>;
  constexpr int T = kRowThreads<H>;
  constexpr int F = H + 1;
  extern __shared__ float2 smem[];
  const int slot = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / T) + slot;
  const bool live = row < M;  // a CTA's last slots may have no row
  float2* buf = smem + slot * H;

  // z[j] = x[2j] + i x[2j+1], j = t + m T; the window's upper half
  // (m >= NP/2) is zero and stays unset
  float2 v[NP];
  const float2* xr = reinterpret_cast<const float2*>(x + row * H);
#pragma unroll
  for (int m = 0; m < NP / 2; ++m)
    v[m] = live ? xr[t + m * T] : make_float2(0.0f, 0.0f);
  fft_regs<H, NP, true>(v, buf, StageTables<H, NP>{tw}, t, CtaSync(),
                         Swizzled<NP>());

  // Bins k < H/2 and H - k come from Z[k], in this thread's lower
  // registers, and Z[H-k], in another thread's upper ones: half an
  // exchange more, in natural order (a warp writes one run and reads
  // another backwards)
  __syncthreads();
#pragma unroll
  for (int m = NP / 2; m < NP; ++m) buf[t + m * T] = v[m];
  __syncthreads();
  if (!live) return;
  float* re = out + row * F;
  float* im = re + static_cast<size_t>(M) * F;
  const float2* twh = tw + stage_tables_size<H, NP, H>();
#pragma unroll
  for (int m = 0; m < NP / 2; ++m) {
    const int k = t + m * T;
    float2 Xk, Xhk;  // k = 0: DC and Nyquist, from Z[0] alone
    real_bin_pair(v[m], k == 0 ? v[0] : buf[H - k], k, __ldg(twh + k), Xk,
                  Xhk);
    re[k] = Xk.x;
    im[k] = Xk.y;
    re[H - k] = Xhk.x;
    im[H - k] = Xhk.y;
  }
  if (t == 0) {  // the middle bin is its own partner: X = conj(Z)
    re[H / 2] = v[NP / 2].x;
    im[H / 2] = -v[NP / 2].y;
  }
}

template <int H>
__global__ void __launch_bounds__(kMaxThreads<H>, kMinCtas<H>)
irfft_tail_kernel(const float* __restrict__ X,    // [2, M, H+1]
                  const float2* __restrict__ tw,  // as for rfft_half
                  float* __restrict__ y,          // [M, H]
                  int M) {
  constexpr int NP = kPoints<H>;
  constexpr int T = kRowThreads<H>;
  constexpr int F = H + 1;
  extern __shared__ float2 smem[];
  const int slot = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / T) + slot;
  const bool live = row < M;
  float2* buf = smem + slot * H;

  // the packed spectrum with re and im swapped: the forward transform of
  // it is the inverse's output, swapped again
  float2 v[NP];
  const float* re = X + row * F;
  const float* im = re + static_cast<size_t>(M) * F;
  const float2* twh = tw + stage_tables_size<H, NP, H>();
#pragma unroll
  for (int m = 0; m < NP; ++m) {
    const int k = t + m * T;
    if (live) {
      const float2 z = packed_bin(make_float2(re[k], im[k]),
                                  make_float2(re[H - k], im[H - k]), k,
                                  __ldg(twh + k));
      v[m] = make_float2(z.y, z.x);
    } else {
      v[m] = make_float2(0.0f, 0.0f);
    }
  }
  fft_regs<H, NP>(v, buf, StageTables<H, NP>{tw}, t, CtaSync(),
                   Swizzled<NP>());
  if (!live) return;
  // z[j] = (y[2j], y[2j+1]) H over the n-window, j = t + m T; overlap-save
  // keeps j >= H/2, the registers m >= NP/2, and nothing reads the others
  float2* yr = reinterpret_cast<float2*>(y + row * H);
  const float scale = 1.0f / H;
#pragma unroll
  for (int m = NP / 2; m < NP; ++m)
    yr[t + (m - NP / 2) * T] = make_float2(v[m].y * scale, v[m].x * scale);
}

template <int H, typename Kernel>
int launch(Kernel kernel, const float* in, const float2* tw, float* out, int M,
           cudaStream_t stream) {
  constexpr int T = kRowThreads<H>;
  const int rpc = rows_per_cta(M, T);
  const size_t smem = static_cast<size_t>(rpc) * H * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(M + rpc - 1) / rpc, rpc * T, smem, stream>>>(in, tw, out, M);
  return static_cast<int>(cudaGetLastError());
}

// What a host that lays out the twiddle table must agree on, for half
// size H: the points a thread holds, each stage's radix in order, and the
// table's length in complex entries.
template <int H>
int plan(int* points, int* radices, int cap, int* nstages, int* table_len) {
  constexpr int NP = kPoints<H>;
  *points = NP;
  *table_len = stage_tables_size<H, NP, H>() + H + 1;
  int n = 0;
  for (int ns = 1; ns < H; ns *= bbcat::stage_radix(H, NP, ns), ++n)
    if (n < cap) radices[n] = bbcat::stage_radix(H, NP, ns);
  *nstages = n;
  return n <= cap ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ``return CALL(h)`` with h as a template argument: every power of two the
// wrappers serve.
#define BBCAT_HALF_SWITCH(h, CALL)                             \
  switch (h) {                                                 \
    case 32: return CALL(32);                                  \
    case 64: return CALL(64);                                  \
    case 128: return CALL(128);                                \
    case 256: return CALL(256);                                \
    case 512: return CALL(512);                                \
    case 1024: return CALL(1024);                              \
    case 2048: return CALL(2048);                              \
    case 4096: return CALL(4096);                              \
    case 8192: return CALL(8192);                              \
    default: return static_cast<int>(cudaErrorInvalidValue);   \
  }

}  // namespace

extern "C" {

// x [M, h] -> out [2, M, h+1]; h a power of two in [32, 8192], tw the
// complex table of rfft_half_kernel.
int bbcat_rfft_half(const float* x, const void* tw, float* out, int M, int h,
                    cudaStream_t stream) {
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
#define BBCAT_RFFT_HALF(H)                                                 \
  launch<H>(rfft_half_kernel<H>, x, static_cast<const float2*>(tw), out, M, \
            stream)
  BBCAT_HALF_SWITCH(h, BBCAT_RFFT_HALF)
#undef BBCAT_RFFT_HALF
}

// X [2, M, h+1] -> y [M, h]; h and tw as for bbcat_rfft_half.
int bbcat_irfft_tail(const float* X, const void* tw, float* y, int M, int h,
                     cudaStream_t stream) {
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
#define BBCAT_IRFFT_TAIL(H)                                                \
  launch<H>(irfft_tail_kernel<H>, X, static_cast<const float2*>(tw), y, M, \
            stream)
  BBCAT_HALF_SWITCH(h, BBCAT_IRFFT_TAIL)
#undef BBCAT_IRFFT_TAIL
}

// The layout the kernels of half size h read their twiddle table in:
// *points a thread, the stages' radices (at most cap are written,
// *nstages counts them) and the table's length in complex entries.  The
// wrapper holds its own layout against this before it makes a table.
int bbcat_half_fft_plan(int h, int* points, int* radices, int cap,
                        int* nstages, int* table_len) {
#define BBCAT_PLAN(H) plan<H>(points, radices, cap, nstages, table_len)
  BBCAT_HALF_SWITCH(h, BBCAT_PLAN)
#undef BBCAT_PLAN
}

}  // extern "C"
