// Single-token decode attention kernel for Hopper (sm_90a): for each batch
// row and KV head, the G query heads of that KV head attend over the first
// lengths[row] positions of the KV cache, o = softmax(q k^T / sqrt(hd)) v.
// Inputs float32 or bfloat16: q (B, H, hd), caches in the model layout
// (B, Smax, K, hd) with any batch, sequence and head strides (the head dim
// contiguous; the engine's caches are (B, K, Smax, hd) in memory, passed as
// a transposed view), lengths (B * K,) int32; output (B, H, hd) contiguous.
//
// Replaces the TPU kernel decode_attention_kernel
// (src/repro/kernels/decode_attention/kernel.py).  Same algorithm: an
// online-softmax state (m, l, acc) in float32 over sequence blocks, the
// output acc / max(l, 1e-30).  What differs:
//
//   * one block per (batch, KV head) loops over the sequence in 64-position
//     blocks staged in shared memory as float32 (16-byte loads, all of a
//     block's in flight before any is stored); its G query rows share
//     every K/V read;
//   * the loop stops at the row's length, so positions past it are never
//     read (the TPU kernel fetches every block and masks);
//   * scores: one thread per (query row, position); softmax statistics:
//     one warp per query row; the accumulator (G, hd) lives in shared
//     memory, one thread per element;
//   * no split of the sequence across blocks yet: at batch 1 the card runs
//     K blocks.
//
// Bound on the card: bytes (the K/V rows up to each length, read once).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BS = 64;           // sequence positions per block
constexpr int THREADS = 256;

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

// 16 bytes of T from global memory (read-only path) as float32 values;
// the address is 16-byte aligned (the wrapper checks the caches' pointers
// and strides).
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
// float32 values into shared memory, 16-byte aligned
template <int N>
__device__ __forceinline__ void store_shared(float* p, const float* f) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2],
                                                    f[i + 3]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  void* o;
  int K, G, Smax;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const Args a) {
  constexpr int LD = HD + 4;     // padded shared row (floats)
  constexpr int VEC = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int CH = HD / VEC;                   // 16-byte chunks per row
  constexpr int CHUNKS = BS * CH;                // per K or V block
  constexpr int PER = (CHUNKS + THREADS - 1) / THREADS;
  extern __shared__ float4 smem4[];
  const int G = a.G;
  float* sq = reinterpret_cast<float*>(smem4);   // (G, LD)
  float* sk = sq + G * LD;                        // (BS, LD)
  float* sv = sk + BS * LD;                       // (BS, LD)
  float* sp = sv + BS * LD;                       // (G, BS) scores, then p
  float* sacc = sp + G * BS;                      // (G, HD)
  float* sm = sacc + G * HD;                      // (G,) running max
  float* sl = sm + G;                             // (G,) running sum
  float* salpha = sl + G;                         // (G,) this block's rescale
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int row = blockIdx.x, b = row / a.K, kvh = row % a.K;
  const int len = max(0, min(a.lengths[row], a.Smax));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = THREADS >> 5;

  for (int e = tid; e < G * HD; e += blockDim.x) {
    const int g = e / HD, d = e % HD;
    sq[g * LD + d] = to_f32(q[b * a.q_sb + (kvh * G + g) * a.q_sh + d]);
    sacc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    sm[g] = NEG_INF;
    sl[g] = 0.0f;
  }
  for (int s0 = 0; s0 < len; s0 += BS) {
    const int n = min(BS, len - s0);
    __syncthreads();             // the previous block is consumed
    // 16-byte loads, every one of a thread's issued before any is stored,
    // so a block's loads are in flight together; rows past n are zeros
    float fk[PER][VEC], fv[PER][VEC];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * THREADS, j = c / CH, d = (c % CH) * VEC;
      if (c < CHUNKS && j < n) {
        load16(k + b * a.k_sb + (s0 + j) * a.k_ss + kvh * a.k_sh + d, fk[i]);
        load16(v + b * a.v_sb + (s0 + j) * a.v_ss + kvh * a.v_sh + d, fv[i]);
      } else {
#pragma unroll
        for (int t = 0; t < VEC; ++t) fk[i][t] = fv[i][t] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + i * THREADS, j = c / CH, d = (c % CH) * VEC;
      if (c < CHUNKS) {
        store_shared<VEC>(sk + j * LD + d, fk[i]);
        store_shared<VEC>(sv + j * LD + d, fv[i]);
      }
    }
    __syncthreads();
    // scores: thread per (query row g, position j)
    for (int i = tid; i < G * BS; i += blockDim.x) {
      const int g = i / BS, j = i % BS;
      float s = NEG_INF;
      if (j < n) {
        const float4* x4 = reinterpret_cast<const float4*>(sq + g * LD);
        const float4* y4 = reinterpret_cast<const float4*>(sk + j * LD);
        float acc = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 x = x4[d4], y = y4[d4];
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
          acc = fmaf(x.z, y.z, acc);
          acc = fmaf(x.w, y.w, acc);
        }
        s = acc * a.scale;
      }
      sp[i] = s;
    }
    __syncthreads();
    // softmax statistics: warp per query row, two positions per lane
    for (int g = warp; g < G; g += n_warps) {
      float* pr = sp + g * BS;
      const float s_a = pr[lane], s_b = pr[lane + 32];
      const bool ok_a = lane < n, ok_b = lane + 32 < n;
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(ok_a ? s_a : NEG_INF,
                                                      ok_b ? s_b : NEG_INF)));
      const float p_a = ok_a ? expf(s_a - m_new) : 0.0f;
      const float p_b = ok_b ? expf(s_b - m_new) : 0.0f;
      const float alpha = expf(m_old - m_new);
      const float psum = warp_sum(p_a + p_b);
      pr[lane] = p_a;
      pr[lane + 32] = p_b;
      __syncwarp();
      if (lane == 0) {
        sl[g] = sl[g] * alpha + psum;
        sm[g] = m_new;
        salpha[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p v: thread per accumulator element
    for (int e = tid; e < G * HD; e += blockDim.x) {
      const int g = e / HD, d = e % HD;
      const float* pr = sp + g * BS;
      float acc = sacc[e] * salpha[g];
      for (int j = 0; j < n; ++j) acc = fmaf(pr[j], sv[j * LD + d], acc);
      sacc[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += blockDim.x) {
    const int g = e / HD, d = e % HD;
    o[(static_cast<long long>(b) * a.K * G + kvh * G + g) * HD + d] =
        from_f32<T>(sacc[e] / fmaxf(sl[g], 1e-30f));
  }
}

size_t smem_bytes(int G, int hd) {
  return sizeof(float) *
         (static_cast<size_t>(G + 2 * BS) * (hd + 4) + G * BS + G * hd +
          3 * G);
}

template <typename T, int HD>
int launch(const Args& a, int rows, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.G, HD);
  static size_t configured = 0;  // per instantiation
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  decode_attention_kernel<T, HD><<<rows, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int rows, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(a, rows, s);
    case 32: return launch<T, 32>(a, rows, s);
    case 64: return launch<T, 64>(a, rows, s);
    case 128: return launch<T, 128>(a, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs.
size_t decode_attention_smem(int G, int hd) { return smem_bytes(G, hd); }

// Launches the decode attention on `stream`: dtype 0 = float32,
// 1 = bfloat16; strides in elements.  Returns a cudaError_t code
// (0 = launched).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int32_t* lengths, void* o, int B, int Smax,
                            int H, int K, int hd, int dtype, long long q_sb,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, float scale, void* stream) {
  if (K < 1 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, lengths, o, K, H / K, Smax, q_sb, q_sh, k_sb, k_ss,
         k_sh, v_sb, v_ss, v_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, B * K, hd, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, B * K, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
