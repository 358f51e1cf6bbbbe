// Grouped expert matmul kernel for Hopper (sm_90a): out[e] = x[e] @ w[e]
// for x (E, C, D) capacity-packed tokens and w (E, D, N) expert weights,
// float32 or bfloat16, accumulated in float32 and written in x's dtype.
// x may have any expert and row strides (D contiguous; an expert stride of
// 0 repeats one token buffer across the experts); w and out are
// contiguous.  D and N are multiples of 8.
//
// Replaces the TPU kernel moe_gmm_kernel (src/repro/kernels/moe_gmm/
// kernel.py), whose grid (E, C/bc, N/bn, D/bd) carries an f32 VMEM
// accumulator across the contraction axis.  Blocks on this card run in no
// order, so the contraction is a loop inside the block instead.
//
// Bound on the card: bytes.  The model calls it with few tokens per expert
// (C = 1 when decoding, C = 8 in a short prefill), so each weight element
// is used C times: every weight tile must be read once and the reads must
// keep the memory busy.  The design:
//
//   * one block of 256 threads per (expert, 64 output columns, BC token
//     rows), BC = 1, 2, 4 or 8 after C, so a decode step does no work for
//     rows it does not have; Qwen1.5-MoE's 64 experts x 22 or 32 column
//     tiles give 1,408 or 2,048 blocks on 132 SMs;
//   * a thread owns 8 consecutive columns (one 16-byte load of bf16, two of
//     f32) and one of 32 contraction lanes; per 256-row stage it issues
//     its 8 weight loads before any is used, and before the stage's token
//     rows are staged in shared memory as float32 (16-byte loads), so the
//     weight reads are in flight while x is staged;
//   * BC x 8 float32 accumulators per thread, explicit fmaf (the build
//     passes -fmad=false); the 32 lanes' partial sums are reduced with
//     warp shuffles, then across the 8 warps through shared memory;
//   * tails masked on every axis: rows past C and columns past N are
//     neither read nor written, contraction rows past D read as zero.
//
// Large C re-reads each weight tile once per BC rows (from L2 or memory):
// correct, slow for long prefills; tensor-core tiles are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 8;                  // columns per thread
constexpr int BN = 64;                   // columns per block
constexpr int GROUPS = BN / COLS;        // 8 column groups
constexpr int LANES = THREADS / GROUPS;  // 32 contraction lanes
constexpr int DCH = 256;                 // contraction rows per stage
constexpr int DPT = DCH / LANES;         // 8 rows per thread per stage

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 consecutive elements of T held as raw 16-byte words, so that a thread
// can issue its loads before it converts any of them.  The address is
// 16-byte aligned (the wrapper checks pointers and strides).
template <typename T> struct Pack8;

template <> struct Pack8<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { v = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_f32(float* f) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <> struct Pack8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void to_f32(float* f) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

template <typename T, int BC>
__global__ void __launch_bounds__(THREADS)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int C, int D, int N, long long sxe,
               long long sxc, int n_tiles) {
  __shared__ __align__(16) float xs[BC][DCH];
  __shared__ float red[WARPS][BC][BN];
  const int e = blockIdx.y;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int c0 = (blockIdx.x / n_tiles) * BC;
  const int tid = threadIdx.x;
  const int g = tid % GROUPS;              // column group of this thread
  const int lane_d = tid / GROUPS;         // contraction lane, 0..31
  const int n = n0 + g * COLS;
  const bool col_ok = n < N;               // N % 8 == 0: all 8 or none
  const T* xe = x + e * sxe;
  const T* we = w + static_cast<long long>(e) * D * N + n;

  float acc[BC][COLS];
#pragma unroll
  for (int c = 0; c < BC; ++c)
#pragma unroll
    for (int i = 0; i < COLS; ++i) acc[c][i] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += DCH) {
    // this stage's weight rows: every load issued before any is used
    Pack8<T> wp[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = d0 + lane_d + j * LANES;
      if (col_ok && d < D)
        wp[j].load(we + static_cast<long long>(d) * N);
      else
        wp[j].zero();
    }
    __syncthreads();                       // the previous stage is consumed
    for (int i = tid; i < BC * (DCH / 8); i += THREADS) {
      const int c = i / (DCH / 8);
      const int dd = (i % (DCH / 8)) * 8;
      float f[8];
      if (c0 + c < C && d0 + dd < D) {
        Pack8<T> p;
        p.load(xe + (c0 + c) * sxc + d0 + dd);
        p.to_f32(f);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) f[k] = 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(&xs[c][dd]);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      float wf[COLS];
      wp[j].to_f32(wf);
      const int dl = lane_d + j * LANES;
#pragma unroll
      for (int c = 0; c < BC; ++c) {
        const float xv = xs[c][dl];
#pragma unroll
        for (int i = 0; i < COLS; ++i) acc[c][i] = fmaf(xv, wf[i], acc[c][i]);
      }
    }
  }

  // the 4 lanes of a warp that share a column group: lane ^ 8, ^ 16, ^ 24
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int c = 0; c < BC; ++c)
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      float v = acc[c][i];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[c][i] = v;
    }
  if (lane < GROUPS) {
#pragma unroll
    for (int c = 0; c < BC; ++c)
#pragma unroll
      for (int i = 0; i < COLS; ++i) red[warp][c][lane * COLS + i] = acc[c][i];
  }
  __syncthreads();
  for (int i = tid; i < BC * BN; i += THREADS) {
    const int c = i / BN, col = i % BN;
    if (c0 + c >= C || n0 + col >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += red[k][c][col];
    out[(static_cast<long long>(e) * C + c0 + c) * N + n0 + col] =
        from_f32<T>(s);
  }
}

template <typename T, int BC>
int launch_bc(const void* x, const void* w, void* out, int E, int C, int D,
              int N, long long sxe, long long sxc, cudaStream_t stream) {
  const int n_tiles = (N + BN - 1) / BN;
  const long long blocks_x =
      static_cast<long long>(n_tiles) * ((C + BC - 1) / BC);
  if (blocks_x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_x), E);
  moe_gmm_kernel<T, BC><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), C, D, N, sxe, sxc, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int N, long long sxe, long long sxc, cudaStream_t s) {
  if (C == 1) return launch_bc<T, 1>(x, w, out, E, C, D, N, sxe, sxc, s);
  if (C == 2) return launch_bc<T, 2>(x, w, out, E, C, D, N, sxe, sxc, s);
  if (C <= 4) return launch_bc<T, 4>(x, w, out, E, C, D, N, sxe, sxc, s);
  return launch_bc<T, 8>(x, w, out, E, C, D, N, sxe, sxc, s);
}

}  // namespace

extern "C" {

// Launches the grouped matmul on `stream`: dtype 0 = float32, 1 =
// bfloat16; x strides in elements.  Returns cudaGetLastError() (0 =
// launched).
int moe_gmm_launch(const void* x, const void* w, void* out, int E, int C,
                   int D, int N, long long sxe, long long sxc, int dtype,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || D <= 0 || N <= 0 || D % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, w, out, E, C, D, N, sxe, sxc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, E, C, D, N, sxe, sxc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
