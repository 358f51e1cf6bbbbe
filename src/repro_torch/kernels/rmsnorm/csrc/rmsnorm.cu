// RMSNorm kernel for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) *
// scale over the last dim of a (rows, D) array; float32 reduction, output
// in x's dtype (float32 or bfloat16), scale float32.
//
// Replaces the TPU kernel rmsnorm_kernel (src/repro/kernels/rmsnorm/kernel.py),
// whose point is one HBM read and one write per row tile.  Here:
//
//   * D <= 1024: one warp per row, eight rows per block; the sum of squares
//     is reduced with warp shuffles;
//   * D > 1024: one 512-thread block per row; warp shuffles, then one
//     float per warp through shared memory;
//   * each thread keeps its slice of the row in registers (element
//     lane + j * threads_per_row, so a warp's loads are contiguous), so x is
//     read once and the same registers are scaled and written.
//
// Bound on the card: bytes (two passes over rows * D elements, about one
// operation per byte).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// TPR threads per row (32: a warp; else the whole block), up to MAXV
// elements per thread.
template <typename T, int TPR, int MAXV>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ out, int rows, int D,
                               float eps) {
  __shared__ float part[32];
  const int lane = threadIdx.x % TPR;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / TPR) +
      threadIdx.x / TPR;
  const bool active = row < rows;
  const T* xr = x + row * D;
  float v[MAXV];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int d = lane + j * TPR;
    v[j] = (active && d < D) ? to_f32(xr[d]) : 0.0f;
    ss = fmaf(v[j], v[j], ss);
  }
  ss = warp_sum(ss);
  if (TPR > 32) {
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) part[warp] = ss;
    __syncthreads();
    if (warp == 0) {
      float t = threadIdx.x < TPR / 32 ? part[threadIdx.x] : 0.0f;
      t = warp_sum(t);
      if (threadIdx.x == 0) part[0] = t;
    }
    __syncthreads();
    ss = part[0];
  }
  if (!active) return;
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  T* orow = out + row * D;
#pragma unroll
  for (int j = 0; j < MAXV; ++j) {
    const int d = lane + j * TPR;
    if (d < D) orow[d] = from_f32<T>(v[j] * inv * __ldg(scale + d));
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* out, int rows, int D,
           float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (D <= 128) {
    rmsnorm_kernel<T, 32, 4><<<(rows + 7) / 8, 256, 0, stream>>>(
        xt, scale, ot, rows, D, eps);
  } else if (D <= 1024) {
    rmsnorm_kernel<T, 32, 32><<<(rows + 7) / 8, 256, 0, stream>>>(
        xt, scale, ot, rows, D, eps);
  } else if (D <= 4096) {
    rmsnorm_kernel<T, 512, 8><<<rows, 512, 0, stream>>>(xt, scale, ot, rows,
                                                         D, eps);
  } else if (D <= 16384) {
    rmsnorm_kernel<T, 512, 32><<<rows, 512, 0, stream>>>(xt, scale, ot, rows,
                                                          D, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the row RMSNorm on `stream`: dtype 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() (0 = launched).
int rmsnorm_launch(const void* x, const float* scale, void* out, int rows,
                   int D, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, out, rows, D, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, out, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
