// Render-group marshalling kernels (K5, K6) for Hopper (sm_90a).
//
// Replace the Pallas kernels of the JAX package's ops/pallas/marshal.py:
//   bbcat_gather_supers  <- gather_supers_pallas  ([C, T] -> [nsup, C, B2])
//   bbcat_delayed_add    <- delayed_add_pallas    (pending-schedule add)
//
// Bound: pure data movement, one read and one write of every element (the
// delayed add reads two operands), no reuse on chip -- the card's memory
// bandwidth is the whole cost.  Design: one CTA per contiguous B2-long row
// of the output, threads walk the row with 16-byte (float4) accesses when
// B2 and the base pointers allow it, so every warp reads and writes whole
// consecutive lines.  No reordering of the adds, so the results are
// bit-identical to the plain PyTorch versions.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// out[j, c, :] = x[c, j*B2 : (j+1)*B2]; one CTA per (j, c) output row.
template <typename V>
__global__ void gather_supers_kernel(const V* __restrict__ x,
                                     V* __restrict__ out, int C, int nsup,
                                     int B2v) {
  const long long row = blockIdx.x;            // j * C + c
  const int j = static_cast<int>(row / C);
  const int c = static_cast<int>(row % C);
  const V* src = x + (static_cast<long long>(c) * nsup + j) * B2v;
  V* dst = out + row * B2v;
  for (int b = threadIdx.x; b < B2v; b += blockDim.x) dst[b] = src[b];
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// y[c, j*B2 + b] = y_head[c, j*B2 + b] + d[c, b], d = pending[j] for j < 2
// else out_tail[j - 2]; one CTA per (c, j) row of the output.
template <typename V>
__global__ void delayed_add_kernel(const V* __restrict__ yh,
                                   const V* __restrict__ pend,
                                   const V* __restrict__ tail,
                                   V* __restrict__ y, int C, int Pt,
                                   int B2v) {
  const long long row = blockIdx.x;            // c * Pt + j
  const int c = static_cast<int>(row / Pt);
  const int j = static_cast<int>(row % Pt);
  const V* d = (j < 2) ? pend + (static_cast<long long>(j) * C + c) * B2v
                       : tail + (static_cast<long long>(j - 2) * C + c) * B2v;
  const V* a = yh + row * B2v;
  V* o = y + row * B2v;
  for (int b = threadIdx.x; b < B2v; b += blockDim.x) o[b] = add(a[b], d[b]);
}

}  // namespace

extern "C" {

const char* bbcat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [C, nsup*B2] -> out [nsup, C, B2]
int bbcat_gather_supers(const float* x, float* out, int C, int nsup, int B2,
                        cudaStream_t stream) {
  const unsigned rows = static_cast<unsigned>(nsup) * C;
  if (B2 % 4 == 0 && aligned16(x) && aligned16(out)) {
    gather_supers_kernel<float4><<<rows, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
        C, nsup, B2 / 4);
  } else {
    gather_supers_kernel<float><<<rows, kThreads, 0, stream>>>(
        x, out, C, nsup, B2);
  }
  return static_cast<int>(cudaGetLastError());
}

// y_head [C, Pt*B2], pending [2, C, B2], out_tail [Pt, C, B2] -> y [C, Pt*B2]
int bbcat_delayed_add(const float* y_head, const float* pending,
                      const float* out_tail, float* y, int C, int Pt, int B2,
                      cudaStream_t stream) {
  const unsigned rows = static_cast<unsigned>(C) * Pt;
  if (B2 % 4 == 0 && aligned16(y_head) &&
      aligned16(pending) && aligned16(out_tail) && aligned16(y)) {
    delayed_add_kernel<float4><<<rows, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(y_head),
        reinterpret_cast<const float4*>(pending),
        reinterpret_cast<const float4*>(out_tail),
        reinterpret_cast<float4*>(y), C, Pt, B2 / 4);
  } else {
    delayed_add_kernel<float><<<rows, kThreads, 0, stream>>>(
        y_head, pending, out_tail, y, C, Pt, B2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
