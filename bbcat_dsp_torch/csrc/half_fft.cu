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
// Bound: each row is read and written once, so the memory traffic is
// small (at the render's 384 rows of 4096 samples, 6.3 MB in and 12.6 MB
// out); the cost is the transform's log2(h) stages, each a pass over the
// row in shared memory behind a barrier.  Design: one CTA per row, the
// real n-point transform run as one complex h-point radix-2 FFT of the
// packed sample pairs (fft_common.cuh), the upper half of the input zero:
// decimation in time forward, in frequency inverse, so that neither the
// bit-reversed scatter nor the gather meets a shared-memory bank conflict.
// 16h bytes of shared memory per CTA (64 KB at h = 4096) let three CTAs
// share an SM, so all 384 rows of the render are resident at once.  The
// twiddles come from a host table computed in double precision.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

using bbcat::bitrev;
using bbcat::fft_dif;
using bbcat::fft_dit;
using bbcat::packed_bin;
using bbcat::real_bin;
using bbcat::spread;

constexpr int kThreads = 512;
constexpr int kMinHalf = 32;
constexpr int kMaxHalf = 8192;  // 16h bytes of shared memory <= 227 KB

size_t smem_bytes(int h) { return (2 * static_cast<size_t>(h) - 1) * sizeof(float2); }

// The stage twiddles, tw[h+1 ..], into shared memory.
__device__ __forceinline__ void load_stage_twiddles(float2* tws,
                                                    const float2* tw, int h) {
  for (int t = threadIdx.x; t < h - 1; t += blockDim.x) tws[t] = tw[h + 1 + t];
}

// tw: [2h] = exp(-2 pi i k / 2h) for k = 0 .. h, then the h-1 stage
// twiddles in fft_common.cuh's layout
__global__ void __launch_bounds__(kThreads)
rfft_half_kernel(const float* __restrict__ x,    // [M, h]
                 const float2* __restrict__ tw,  // [2h]
                 float* __restrict__ out,        // [2, M, h+1]
                 int M, int h) {
  extern __shared__ float2 smem[];
  float2* buf = smem;     // [h]   complex FFT work array
  float2* tws = buf + h;  // [h-1] stage twiddles
  const int logh = 31 - __clz(h);
  const int F = h + 1;
  const size_t row = blockIdx.x;
  load_stage_twiddles(tws, tw, h);
  // z[j] = x[2j] + i x[2j+1]; the window's upper half is zero
  const float2* xr = reinterpret_cast<const float2*>(x + row * h);
  for (int t = threadIdx.x; t < h; t += blockDim.x) {
    const int j = spread(t, logh);
    buf[bitrev(j, logh)] = (j < h / 2) ? xr[j] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  fft_dit(buf, tws, h, logh, false);
  float* re = out + row * F;
  float* im = re + static_cast<size_t>(M) * F;
  for (int k = threadIdx.x; k < F; k += blockDim.x) {
    const float2 v = real_bin(buf, k, h, tw[k]);
    re[k] = v.x;
    im[k] = v.y;
  }
}

__global__ void __launch_bounds__(kThreads)
irfft_tail_kernel(const float* __restrict__ X,    // [2, M, h+1]
                  const float2* __restrict__ tw,  // [2h], as for rfft_half
                  float* __restrict__ y,          // [M, h]
                  int M, int h) {
  extern __shared__ float2 smem[];
  float2* buf = smem;
  float2* tws = buf + h;
  const int logh = 31 - __clz(h);
  const int F = h + 1;
  const size_t row = blockIdx.x;
  load_stage_twiddles(tws, tw, h);
  const float* re = X + row * F;
  const float* im = re + static_cast<size_t>(M) * F;
  for (int k = threadIdx.x; k < h; k += blockDim.x)
    buf[k] = packed_bin(make_float2(re[k], im[k]),
                        make_float2(re[h - k], im[h - k]), k, tw[k]);
  __syncthreads();
  fft_dif(buf, tws, h, logh, true);
  // z[j] = (y[2j], y[2j+1]) * h at buf[bitrev(j)]; the tail half is
  // j = h/2 .. h-1
  float2* yr = reinterpret_cast<float2*>(y + row * h);
  const float scale = 1.0f / h;
  for (int t = threadIdx.x; t < h; t += blockDim.x) {
    const int j = spread(t, logh);
    if (j < h / 2) continue;
    const float2 z = buf[bitrev(j, logh)];
    yr[j - h / 2] = make_float2(z.x * scale, z.y * scale);
  }
}

template <typename Kernel>
int launch(Kernel kernel, const float* in, const void* tw, float* out, int M,
           int h, cudaStream_t stream) {
  if (h < kMinHalf || h > kMaxHalf || (h & (h - 1)) || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(h);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<M, kThreads, smem, stream>>>(
      in, static_cast<const float2*>(tw), out, M, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [M, h] -> out [2, M, h+1]; h a power of two in [32, 8192], tw the
// [2h] complex table of rfft_half_kernel.
int bbcat_rfft_half(const float* x, const void* tw, float* out, int M, int h,
                    cudaStream_t stream) {
  return launch(rfft_half_kernel, x, tw, out, M, h, stream);
}

// X [2, M, h+1] -> y [M, h]; h and tw as for bbcat_rfft_half.
int bbcat_irfft_tail(const float* X, const void* tw, float* y, int M, int h,
                     cudaStream_t stream) {
  return launch(irfft_tail_kernel, X, tw, y, M, h, stream);
}

}  // extern "C"
