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
// Bound: the carry makes time sequential within a channel, so a channel's
// R blocks run one after another, and each block's work is latency-bound
// (two B-point FFT passes with a barrier per stage, then P*F complex MACs
// that read H and the window ring from L2).  Design: one CTA per channel
// with a loop over the R blocks.  Each real n-point transform runs as one
// complex B-point radix-2 FFT in shared memory (even/odd packing, upper
// half of the input zero), with twiddles from double-precision sincospi,
// laid out so that no stage meets a shared-memory bank conflict
// (fft_common.cuh).
// The windows go to a ring of P slots in a global scratch buffer that only
// the thread owning a bin ever touches (the MAC and window assembly are
// per bin), so the ring needs no barrier and stays in L2.  The Nyquist
// bin k = B is handled on its own: its imaginary part and the DC bin's
// are zero, as for any real signal.
//
// At C = 64 the grid fills 64 of the card's 132 SMs: occupancy is the
// first lead for a performance change (split the forward FFTs, which have
// no carried dependency, across more CTAs).

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

using bbcat::bitrev;
using bbcat::fft_dif;
using bbcat::fft_dit;
using bbcat::packed_bin;
using bbcat::real_bin;
using bbcat::spread;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_head_kernel(const float* __restrict__ x,      // [C, R*B]
                  const float* __restrict__ xcarry, // [2, P, C, F]
                  const float* __restrict__ prev,   // [2, C, F]
                  const float* __restrict__ H,      // [2, P, C, F]
                  float* __restrict__ y,            // [C, R*B]
                  float* __restrict__ xcarry_out,   // [2, P, C, F]
                  float* __restrict__ prev_out,     // [2, C, F]
                  float2* __restrict__ ring,        // [C, P, F] scratch
                  int C, int P, int B, int R) {
  extern __shared__ float2 smem[];
  const int F = B + 1;
  const int logB = 31 - __clz(B);
  float2* buf = smem;        // [B]   complex FFT work array
  float2* acc = buf + B;     // [F]   MAC output spectrum
  float2* last = acc + F;    // [F]   half spectrum of the previous block
  float2* tws = last + F;    // [B-1] stage twiddles (fft_common.cuh)
  float2* twN = tws + B - 1; // [F]   exp(-2 pi i k / n)

  const int c = blockIdx.x;
  const size_t part = static_cast<size_t>(C) * F;    // partition stride
  const size_t plane = static_cast<size_t>(P) * part;
  const size_t cf = static_cast<size_t>(c) * F;
  float2* ringc = ring + static_cast<size_t>(c) * P * F;

  for (int t = threadIdx.x; t < B - 1; t += blockDim.x) {
    const int half = 1 << (31 - __clz(t + 1));
    double s, co;
    sincospi(-static_cast<double>(t + 1 - half) / half, &s, &co);
    tws[t] = make_float2(static_cast<float>(co), static_cast<float>(s));
  }
  // ring slot q holds window m with m % P == q; the carried windows are
  // m = 0 .. P-1 and block i's window is m = P + i
  for (int k = threadIdx.x; k < F; k += blockDim.x) {
    double s, co;
    sincospi(-static_cast<double>(k) / B, &s, &co);
    twN[k] = make_float2(static_cast<float>(co), static_cast<float>(s));
    last[k] = make_float2(prev[cf + k], prev[part + cf + k]);
    for (int q = 0; q < P; ++q) {
      const size_t o = q * part + cf + k;
      ringc[static_cast<size_t>(q) * F + k] =
          make_float2(xcarry[o], xcarry[plane + o]);
    }
  }
  __syncthreads();

  const float* xc = x + static_cast<size_t>(c) * R * B;
  float* yc = y + static_cast<size_t>(c) * R * B;
  const float scale = 1.0f / B;
  for (int i = 0; i < R; ++i) {
    // forward: z[m] = x[2m] + i x[2m+1]; the window's upper half is zero
    const float2* xi = reinterpret_cast<const float2*>(xc + static_cast<size_t>(i) * B);
    for (int t = threadIdx.x; t < B; t += blockDim.x) {
      const int m = spread(t, logB);
      buf[bitrev(m, logB)] = (m < B / 2) ? xi[m] : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
    fft_dit(buf, tws, B, logB, false);

    const int slot = i % P;
    for (int k = threadIdx.x; k < F; k += blockDim.x) {
      const float2 xh = real_bin(buf, k, B, twN[k]);
      const float sg = (k & 1) ? -1.0f : 1.0f;
      const float2 lp = last[k];
      const float2 w = make_float2(lp.x + sg * xh.x, lp.y + sg * xh.y);
      last[k] = xh;
      ringc[static_cast<size_t>(slot) * F + k] = w;
      float ar = 0.0f, ai = 0.0f;
      int q = slot;
      for (int p = 0; p < P; ++p) {
        const float2 v = (p == 0) ? w : ringc[static_cast<size_t>(q) * F + k];
        const size_t ho = p * part + cf + k;
        const float hr = H[ho], hi = H[plane + ho];
        ar += v.x * hr - v.y * hi;
        ai += v.x * hi + v.y * hr;
        q = (q == 0) ? P - 1 : q - 1;
      }
      acc[k] = make_float2(ar, ai);
    }
    __syncthreads();

    // inverse: z = IFFT_B(Z) holds the output samples (y[2m], y[2m+1]),
    // z[m] at buf[bitrev(m)]
    for (int k = threadIdx.x; k < B; k += blockDim.x)
      buf[k] = packed_bin(acc[k], acc[B - k], k, twN[k]);
    __syncthreads();
    fft_dif(buf, tws, B, logB, true);

    // overlap-save keeps the last B samples of the n-window: z[B/2 .. B-1]
    float2* yi = reinterpret_cast<float2*>(yc + static_cast<size_t>(i) * B);
    for (int t = threadIdx.x; t < B; t += blockDim.x) {
      const int m = spread(t, logB);
      if (m < B / 2) continue;
      const float2 z = buf[bitrev(m, logB)];
      yi[m - B / 2] = make_float2(z.x * scale, z.y * scale);
    }
    __syncthreads();
  }

  // carry out: windows m = R .. R+P-1 (oldest first), the last half spectrum
  for (int k = threadIdx.x; k < F; k += blockDim.x) {
    prev_out[cf + k] = last[k].x;
    prev_out[part + cf + k] = last[k].y;
    for (int q = 0; q < P; ++q) {
      const float2 v = ringc[static_cast<size_t>((R + q) % P) * F + k];
      const size_t o = q * part + cf + k;
      xcarry_out[o] = v.x;
      xcarry_out[plane + o] = v.y;
    }
  }
}

}  // namespace

extern "C" {

// Block B a power of two in [32, 1024]; any C, P, R >= 1.
int bbcat_fused_head(const float* x, const float* xcarry, const float* prev,
                     const float* H, float* y, float* xcarry_out,
                     float* prev_out, void* ring, int C, int P, int B, int R,
                     cudaStream_t stream) {
  if (B < 32 || B > 1024 || (B & (B - 1)) || C < 1 || P < 1 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int F = B + 1;
  const size_t smem = (2 * static_cast<size_t>(B) - 1 + 3 * F) * sizeof(float2);
  fused_head_kernel<<<C, kThreads, smem, stream>>>(
      x, xcarry, prev, H, y, xcarry_out, prev_out,
      static_cast<float2*>(ring), C, P, B, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
