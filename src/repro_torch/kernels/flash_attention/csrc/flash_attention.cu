// Prefill (flash) attention kernel for Hopper (sm_90a), optionally causal,
// with grouped-query heads: o = softmax(q k^T / sqrt(hd)) v per head, query
// head h reading KV head h / G.  Inputs float32 or bfloat16 in the model
// layout q (B, Sq, H, hd), k/v (B, Skv, K, hd) with any batch, sequence and
// head strides (the head dim contiguous); output (B, Sq, H, hd) contiguous.
// The causal mask is query position >= key position, both from 0.
//
// Replaces the TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py).  Same algorithm: an
// online-softmax state (m, l, acc) in float32 carried across KV tiles, the
// output acc / max(l, 1e-30).  What differs:
//
//   * one block per (query block, KV head, batch) serves all G query heads
//     of that KV head, so each K/V tile is read from memory once per group
//     (the Pallas index map re-reads it for every group row).  The block's
//     R = BQ * G query rows are one thread each; BQ is 64 query positions,
//     halved until R <= 256 so that the float32 accumulators fit the
//     register file;
//   * the query tile and each 32-key K/V tile are staged in shared memory
//     as float32 with rows padded by four floats (conflict-free float4
//     reads), through 16-byte loads all in flight before any is stored;
//     the scores of a tile and the accumulator row live in each thread's
//     registers; a block has 256 threads, R of them query rows;
//   * causal blocks stop at the last KV tile their rows can see;
//   * Sq and Skv need not be multiples of a block: rows past Sq are not
//     written, keys past Skv are masked (their tile rows are zero);
//   * products are scalar float32 fused multiply-adds (fmaf; the build has
//     -fmad=false), no tensor cores yet.
//
// Bound on the card: operations (4 * hd flops per query-key pair); this
// first form runs on the float32 pipes, far from the bf16 tensor-core peak.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BKV = 32;          // keys per K/V tile
constexpr int MAX_ROWS = 256;    // query rows (threads) per block

// 16 bytes of T from global memory (read-only path) as float32 values, and
// float32 values stored as 16 bytes of T; the address is 16-byte aligned
// (the wrapper checks the operands' pointers and strides).
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
__device__ __forceinline__ void store16(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* f) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}
// float32 values into shared memory, 16-byte aligned
template <int N>
__device__ __forceinline__ void store_shared(float* p, const float* f) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2],
                                                    f[i + 3]);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, K, G, BQ, causal;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

// Rows k0 .. k0 + BKV of one KV head into shared memory (float32, rows of
// LD floats): 16-byte loads, all of a thread's issued before any is
// stored; rows at or past n_rows are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           long long row_stride, int k0,
                                           int n_rows) {
  constexpr int LD = HD + 4, VEC = 16 / sizeof(T), CH = HD / VEC;
  constexpr int CHUNKS = BKV * CH;
  constexpr int PER = (CHUNKS + MAX_ROWS - 1) / MAX_ROWS;
  float f[PER][VEC];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * MAX_ROWS, j = c / CH, d = (c % CH) * VEC;
    if (c < CHUNKS && k0 + j < n_rows) {
      load16(src + (k0 + j) * row_stride + d, f[i]);
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) f[i][t] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * MAX_ROWS, j = c / CH, d = (c % CH) * VEC;
    if (c < CHUNKS) store_shared<VEC>(dst + j * LD + d, f[i]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(MAX_ROWS, 1)
flash_attention_kernel(const Args a) {
  constexpr int LD = HD + 4;     // padded shared row (floats)
  constexpr int VEC = 16 / sizeof(T), CH = HD / VEC;
  extern __shared__ float4 smem4[];
  const int BQ = a.BQ, G = a.G;
  const int R = BQ * G;
  float* sq = reinterpret_cast<float*>(smem4);   // (R, LD)
  float* sk = sq + R * LD;                        // (BKV, LD)
  float* sv = sk + BKV * LD;                      // (BKV, LD)
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int b = blockIdx.z, kvh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int r = threadIdx.x;
  const int g = r / BQ, qpos = q0 + r % BQ;
  const bool active = r < R && qpos < a.Sq;

  // query rows r = g * BQ + i: position q0 + i of head kvh * G + g
  for (int c = threadIdx.x; c < R * CH; c += MAX_ROWS) {
    const int rr = c / CH, d = (c % CH) * VEC;
    const int p = q0 + rr % BQ, h = kvh * G + rr / BQ;
    float f[VEC];
    if (p < a.Sq) {
      load16(q + b * a.q_sb + p * a.q_ss + h * a.q_sh + d, f);
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) f[t] = 0.0f;
    }
    store_shared<VEC>(sq + rr * LD + d, f);
  }
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
  float m = NEG_INF, l = 0.0f;

  // the keys this block's rows can see
  const int kv_end = a.causal ? min(a.Skv, min(q0 + BQ, a.Sq)) : a.Skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();             // the previous tile is consumed
    stage_tile<T, HD>(sk, k + b * a.k_sb + kvh * a.k_sh, a.k_ss, k0, a.Skv);
    stage_tile<T, HD>(sv, v + b * a.v_sb + kvh * a.v_sh, a.v_ss, k0, a.Skv);
    __syncthreads();
    if (!active) continue;
    float s[BKV];
#pragma unroll
    for (int j = 0; j < BKV; ++j) s[j] = 0.0f;
    const float4* q4 = reinterpret_cast<const float4*>(sq + r * LD);
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 x = q4[d4];
#pragma unroll
      for (int j = 0; j < BKV; ++j) {
        const float4 y = reinterpret_cast<const float4*>(sk + j * LD)[d4];
        s[j] = fmaf(x.x, y.x, s[j]);
        s[j] = fmaf(x.y, y.y, s[j]);
        s[j] = fmaf(x.z, y.z, s[j]);
        s[j] = fmaf(x.w, y.w, s[j]);
      }
    }
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const int kp = k0 + j;
      const bool ok = kp < a.Skv && (!a.causal || kp <= qpos);
      s[j] = ok ? s[j] * a.scale : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const int kp = k0 + j;
      const bool ok = kp < a.Skv && (!a.causal || kp <= qpos);
      s[j] = ok ? expf(s[j] - m_new) : 0.0f;
      psum += s[j];
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = s[j];
      const float4* v4 = reinterpret_cast<const float4*>(sv + j * LD);
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 y = v4[d4];
        acc[4 * d4 + 0] = fmaf(p, y.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, y.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, y.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, y.w, acc[4 * d4 + 3]);
      }
    }
  }
  if (!active) return;
  const float inv_l = 1.0f / fmaxf(l, 1e-30f);
  T* orow = o + ((static_cast<long long>(b) * a.Sq + qpos) * a.H +
                 kvh * G + g) * HD;
#pragma unroll
  for (int d = 0; d < HD; d += VEC) {
    float f[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) f[t] = acc[d + t] * inv_l;
    store16(orow + d, f);
  }
}

size_t smem_bytes(int R, int hd) {
  return sizeof(float) * static_cast<size_t>(R + 2 * BKV) * (hd + 4);
}

template <typename T, int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int R = a.BQ * a.G;
  const size_t smem = smem_bytes(R, HD);
  static size_t configured = 0;  // per instantiation
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((a.Sq + a.BQ - 1) / a.BQ, a.K, B);
  flash_attention_kernel<T, HD><<<grid, MAX_ROWS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int B, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(a, B, s);
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Query positions per block for group size G (R = BQ * G <= 256 rows).
int flash_attention_block_q(int G) {
  int bq = 64;
  while (bq > 1 && bq * G > MAX_ROWS) bq /= 2;
  return bq;
}

// Dynamic shared memory one block needs.
size_t flash_attention_smem(int G, int hd) {
  return smem_bytes(flash_attention_block_q(G) * G, hd);
}

// Launches the attention on `stream`: dtype 0 = float32, 1 = bfloat16;
// strides in elements.  Returns a cudaError_t code (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Skv, int H, int K,
                           int hd, int dtype, int causal, long long q_sb,
                           long long q_ss, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb,
                           long long v_ss, long long v_sh, float scale,
                           void* stream) {
  if (K < 1 || H % K != 0 || H / K > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  Args a{q, k, v, o, Sq, Skv, H, K, G, flash_attention_block_q(G), causal,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, B, hd, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, B, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
