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
// partition against at least 16 bytes read, far below the card's ratio.
// Design: one thread per (c, f) over the flat C*F axis, so a warp reads 32
// consecutive floats of every plane; p accumulates in the reference's order
// (p = 0 .. P-1) in float32.  head_mac walks R in tiles of kTile outputs
// held in registers.  Within a tile, partition p + 1 needs the history
// entries of partition p shifted by one slot, so a register window slides
// down the history: each partition loads one new history entry and its H
// bin, and H is read once per tile.  The history may be deeper than P + R;
// the kernel reads only its first P + R slots (the crossfade's old-filter
// block reads the first P + 1 of a P + ratio history without a copy).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 8;

__global__ void head_mac_kernel(const float* __restrict__ xext,
                                const float* __restrict__ H,
                                float* __restrict__ out, int P, int D, int R,
                                long long S) {
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (n >= S) return;
  const float* xr = xext + n;
  const float* xi = xr + static_cast<long long>(D) * S;
  const float* hr = H + n;
  const float* hi = hr + static_cast<long long>(P) * S;
  float* yr = out + n;
  float* yi = yr + static_cast<long long>(R) * S;

  for (int i0 = 0; i0 < R; i0 += kTile) {
    // w[k] = xext[P + i0 + k - p] at partition p; lanes past R stay dead
    float wr[kTile], wi[kTile], ar[kTile], ai[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const bool live = i0 + k < R;
      const long long o = static_cast<long long>(P + i0 + k) * S;
      wr[k] = live ? xr[o] : 0.0f;
      wi[k] = live ? xi[o] : 0.0f;
      ar[k] = 0.0f;
      ai[k] = 0.0f;
    }
    for (int p = 0; p < P; ++p) {
      const long long h = static_cast<long long>(p) * S;
      const float gr = hr[h], gi = hi[h];
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        ar[k] += wr[k] * gr - wi[k] * gi;
        ai[k] += wr[k] * gi + wi[k] * gr;
      }
      if (p + 1 < P) {
#pragma unroll
        for (int k = kTile - 1; k > 0; --k) {
          wr[k] = wr[k - 1];
          wi[k] = wi[k - 1];
        }
        const long long o = static_cast<long long>(P + i0 - p - 1) * S;
        wr[0] = xr[o];
        wi[0] = xi[o];
      }
    }
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (i0 + k < R) {
        const long long o = static_cast<long long>(i0 + k) * S;
        yr[o] = ar[k];
        yi[o] = ai[k];
      }
    }
  }
}

__global__ void rotated_mac_kernel(const float* __restrict__ queue,
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
    const float qr = queue[q], qi = queue[plane + q];
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

}  // namespace

extern "C" {

// xext [2, D, C, F] (D >= P + R), H [2, P, C, F] -> out [2, R, C, F]
int bbcat_head_mac(const float* xext, const float* H, float* out, int P,
                   int D, int R, int C, int F, cudaStream_t stream) {
  const long long S = static_cast<long long>(C) * F;
  head_mac_kernel<<<blocks_for(S), kThreads, 0, stream>>>(xext, H, out, P, D,
                                                          R, S);
  return static_cast<int>(cudaGetLastError());
}

// queue, H [2, P, C, F], 0 <= slot < P -> out [2, C, F]
int bbcat_rotated_mac(const float* queue, const float* H, float* out, int P,
                      int C, int F, int slot, cudaStream_t stream) {
  const long long S = static_cast<long long>(C) * F;
  rotated_mac_kernel<<<blocks_for(S), kThreads, 0, stream>>>(queue, H, out, P,
                                                             slot, S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
