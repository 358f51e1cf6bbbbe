// RMSNorm kernel for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) *
// scale over the last dim of a (rows, D) array; float32 reduction, output
// in x's dtype (float32 or bfloat16), scale float32.
//
// Replaces the TPU kernel rmsnorm_kernel (src/repro/kernels/rmsnorm/kernel.py),
// whose point is one HBM read and one write per row tile.
//
// Bound on the card: bytes (one read and one write of rows * D elements,
// about one operation per byte).  What the design does about it:
//
//   * 16-byte accesses: a thread loads and stores VEC elements at once (8
//     bf16 or 4 float32), neighbouring lanes on neighbouring 16-byte
//     vectors, and reads scale as float4.  A row whose length is not a
//     multiple of VEC, or a pointer that is not 16-byte aligned, takes the
//     same kernel with VEC = 1 (one element per access);
//   * threads per row (tpr, a power of two) sized to the row so that each
//     thread holds NV vectors in registers, raw (16 bytes each): a row of
//     up to 128 vectors fits one warp at up to 4 vectors a lane (D = 128
//     bf16: 16 lanes, two rows a warp), a longer one takes 2 vectors a
//     thread over more warps (D = 4,096 bf16: 256 threads a row), which
//     reaches the time of a device copy of the same bytes;
//   * several rows per block (blockDim = tpr * rows per block, 256 threads
//     unless one row needs more): a row inside a warp is reduced with
//     shuffles only; a row over several warps with one barrier, each thread
//     then summing its row's per-warp partials from shared memory;
//   * x is read once, and the same registers are scaled and written.
//
// The launch plan (VEC, NV, tpr, rows per block) is computed by the wrapper
// (kernel.launch_plan) and checked here.
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

// VEC elements of x or out at once: a raw 16-byte (or one-element) load,
// converted to float where it is used, so a thread's registers hold its
// slice of the row in x's own type.
template <typename T, int VEC> struct Io;

template <typename T> struct Io<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ Raw zero() { return from_f32<T>(0.0f); }
  static __device__ __forceinline__ void to_float(const Raw& r, float* f) {
    f[0] = to_f32(r);
  }
  static __device__ __forceinline__ void store(T* p, const float* f) {
    p[0] = from_f32<T>(f[0]);
  }
};

template <> struct Io<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ Raw zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ void to_float(const Raw& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <> struct Io<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ Raw zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ void to_float(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// VEC scale entries (float32; 16-byte aligned when VEC > 1).
template <int VEC>
__device__ __forceinline__ void load_scale(const float* p, float* s) {
  if constexpr (VEC == 1) {
    s[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      s[4 * i] = v.x;
      s[4 * i + 1] = v.y;
      s[4 * i + 2] = v.z;
      s[4 * i + 3] = v.w;
    }
  }
}

// One row per `tpr` threads, blockDim.x / tpr rows per block; thread
// `lane` of a row holds vectors lane, lane + tpr, ... (NV of them).  With
// PREFETCH (a grid of one wave or less, where the kernel's time is its
// latency) the thread reads its scale entries beside x instead of after
// the reduction.
template <typename T, int VEC, int NV, bool PREFETCH>
__global__ void __launch_bounds__(1024)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int rows, int D, int tpr, float eps) {
  using IoT = Io<T, VEC>;
  __shared__ float part[32];
  const int lane = threadIdx.x & (tpr - 1);
  const int rib = threadIdx.x / tpr;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + rib;
  const bool active = row < rows;
  const int dv = D / VEC;
  const T* xr = x + row * D;
  typename IoT::Raw raw[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + j * tpr;
    raw[j] = active && c < dv ? IoT::load(xr + static_cast<long long>(c) * VEC)
                              : IoT::zero();
  }
  float sc[PREFETCH ? NV : 1][VEC];
  if constexpr (PREFETCH) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + j * tpr;
      if (c < dv) load_scale<VEC>(scale + static_cast<long long>(c) * VEC, sc[j]);
    }
  }
  // one sum of squares per vector, then their sum
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float f[VEC];
    IoT::to_float(raw[j], f);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc = fmaf(f[k], f[k], acc);
    ss += acc;
  }
  if (tpr <= 32) {
    // the row's lanes are an aligned group of tpr lanes of one warp
    for (int o = tpr >> 1; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int nw = tpr >> 5, w0 = rib * nw;
    ss = 0.0f;
    for (int i = 0; i < nw; ++i) ss += part[w0 + i];
  }
  if (!active) return;
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  T* orow = out + row * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + j * tpr;
    if (c < dv) {
      float f[VEC], s[VEC], o[VEC];
      IoT::to_float(raw[j], f);
      if constexpr (PREFETCH) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) s[k] = sc[j][k];
      } else {
        load_scale<VEC>(scale + static_cast<long long>(c) * VEC, s);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = f[k] * inv * s[k];
      IoT::store(orow + static_cast<long long>(c) * VEC, o);
    }
  }
}

template <typename T, int VEC, int NV>
void launch_nv(const void* x, const float* scale, void* out, int rows, int D,
               int tpr, int rpb, bool prefetch, float eps,
               cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(rows) + rpb - 1) / rpb);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  // a thread holds its scale entries beside x for up to 16 elements
  // (more would not fit its registers at 1,024 threads a block)
  if constexpr (NV * VEC <= 16) {
    if (prefetch) {
      rmsnorm_kernel<T, VEC, NV, true><<<blocks, tpr * rpb, 0, stream>>>(
          xt, scale, ot, rows, D, tpr, eps);
      return;
    }
  }
  rmsnorm_kernel<T, VEC, NV, false><<<blocks, tpr * rpb, 0, stream>>>(
      xt, scale, ot, rows, D, tpr, eps);
}

template <typename T, int VEC>
int launch(const void* x, const float* scale, void* out, int rows, int D,
           int nv, int tpr, int rpb, bool pf, float eps, cudaStream_t s) {
  switch (nv) {
    case 1: launch_nv<T, VEC, 1>(x, scale, out, rows, D, tpr, rpb, pf, eps, s); break;
    case 2: launch_nv<T, VEC, 2>(x, scale, out, rows, D, tpr, rpb, pf, eps, s); break;
    case 4: launch_nv<T, VEC, 4>(x, scale, out, rows, D, tpr, rpb, pf, eps, s); break;
    default:
      // NV 8 and 16 only on the one-element path (long rows that are not
      // 16-byte aligned: D up to 16,384 over 1,024 threads)
      if constexpr (VEC == 1) {
        if (nv == 8) {
          launch_nv<T, 1, 8>(x, scale, out, rows, D, tpr, rpb, pf, eps, s);
          break;
        }
        if (nv == 16) {
          launch_nv<T, 1, 16>(x, scale, out, rows, D, tpr, rpb, pf, eps, s);
          break;
        }
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// Launches the row RMSNorm on `stream`: dtype 0 = float32, 1 = bfloat16;
// the plan is `vec` elements per access (16 bytes' worth, or 1), `nv`
// vectors per thread, `tpr` threads per row (a power of two), `rpb` rows
// per block, and whether scale is read beside x (`prefetch`).  Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a plan
// that does not cover the row.
int rmsnorm_launch(const void* x, const float* scale, void* out, int rows,
                   int D, float eps, int dtype, int vec, int nv, int tpr,
                   int rpb, int prefetch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = rows > 0 && D > 0 && pow2(tpr) && tpr <= 1024 && rpb > 0 &&
                  tpr * rpb <= 1024 && D % vec == 0 &&
                  static_cast<long long>(vec) * nv * tpr >= D;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool pf = prefetch != 0;
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(x, scale, out, rows, D, nv, tpr, rpb, pf, eps, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(x, scale, out, rows, D, nv, tpr, rpb, pf, eps, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(x, scale, out, rows, D, nv, tpr, rpb, pf,
                                    eps, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(x, scale, out, rows, D, nv, tpr, rpb, pf,
                                    eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
