// Prefill (flash) attention kernels for Hopper (sm_90a), optionally causal,
// with grouped-query heads: o = softmax(q k^T / sqrt(hd)) v per head, query
// head h reading KV head h / G.  Inputs float32 or bfloat16 in the model
// layout q (B, Sq, H, hd), k/v (B, Skv, K, hd) with any batch, sequence and
// head strides (the head dim contiguous); output (B, Sq, H, hd) contiguous.
// The causal mask is query position >= key position, both from 0.
//
// Replaces the TPU kernel flash_attention_kernel
// (src/repro/kernels/flash_attention/kernel.py).  Same algorithm: an
// online-softmax state (m, l, acc) in float32 carried across KV tiles, the
// output acc / max(l, 1e-30).  flash_attention_launch dispatches by dtype.
//
// bfloat16: the tensor-core kernel (flash_attention_tc).  Bound on the card:
// operations (4 * hd flops per visible query-key pair at the 989 TFLOP/s
// bf16 tensor-core peak; S = 2,048 causal at Llama-3's heads is 34.4 GFLOP,
// 0.035 ms).  What the design does about it:
//
//   * one block per (128 query rows, KV head, batch) serves the G query
//     heads of that KV head, so each K/V tile is read once per group.  Its
//     rows are the flattened (position, g) rows of that head group, row
//     position * G + g, 128 a block from any row on: no G (7 for qwen2-7b,
//     6 for internvl2-26b, 1 for MHA) needs to divide the block, and only
//     the last block has rows past Sq * G (zero queries, never written);
//   * two consumer warpgroups of 64 rows each run S = Q K^T as
//     wgmma.mma_async m64n64k16 (bf16 operands, f32 accumulators) from
//     Q and K tiles in swizzled shared memory, and O += P V as m64n{hd}k16
//     with P taken from registers: the S accumulator, rounded to bf16 (as
//     XLA rounds the probabilities before the PV product in the reference),
//     packs into the A fragment pair by pair; V is the MN-major B operand
//     (the transpose bit);
//   * one producer warp streams 64-key K and V tiles by TMA (tensor maps
//     built on the host, passed as __grid_constant__) into a ring of three
//     stages with full / empty mbarriers, so tiles t+1 and t+2 are in flight
//     while tile t is computed.  Rows are 128-byte swizzled (64-byte for
//     hd 32, 32-byte for hd 16): a 128-wide head dim loads as two 64-wide
//     column halves.  TMA fills keys past Skv with zeros;
//   * the online softmax runs in registers on the accumulator layout (a row
//     spread over the four threads of a quad: two shuffles), in base 2 with
//     the scale pre-multiplied by log2(e); only tiles that cross the causal
//     diagonal or Skv are masked, tiles wholly above the diagonal are never
//     loaded, and causal blocks launch longest first;
//   * Q is staged once per block with 16-byte loads into the swizzled
//     layout.
//
// float32: the scalar kernel (flash_attention_kernel), kept for the float32
// models, whose card-against-CPU checks hold tokens to 2e-5 (TF32 tensor
// cores would not): one block per (query block, KV head, batch); the
// block's R = BQ * G query rows are one thread each (BQ 64 query positions,
// halved until R <= 256); the query tile and each 32-key K/V tile (16-key
// at hd 128) staged in shared memory as float32 (rows padded by four
// floats); scalar fmaf products; causal blocks stop at the last KV tile
// their rows can see.
// Bound: operations at the 67 TFLOP/s float32 peak, far from it.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../csrc/hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
// keys per K/V tile: 32, or 16 at hd 128, where a 32-key tile's loads,
// batched beside the 128 accumulators, spill registers
template <int HD> constexpr int BKV = HD >= 128 ? 16 : 32;
constexpr int MAX_ROWS = 256;    // query rows (threads) per block

// 16 bytes of float32 from global memory (read-only path), and stored; the
// address is 16-byte aligned (the wrapper checks the operands' pointers and
// strides).
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void store16(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
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

// Rows k0 .. k0 + BKV<HD> of one KV head into shared memory (float32, rows of
// LD floats): 16-byte loads, all of a thread's issued before any is
// stored; rows at or past n_rows are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           long long row_stride, int k0,
                                           int n_rows) {
  constexpr int LD = HD + 4, VEC = 16 / sizeof(T), CH = HD / VEC;
  constexpr int CHUNKS = BKV<HD> * CH;
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
  float* sv = sk + BKV<HD> * LD;                  // (BKV, LD)
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
  const int n_tiles = (kv_end + BKV<HD> - 1) / BKV<HD>;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV<HD>;
    __syncthreads();             // the previous tile is consumed
    stage_tile<T, HD>(sk, k + b * a.k_sb + kvh * a.k_sh, a.k_ss, k0, a.Skv);
    stage_tile<T, HD>(sv, v + b * a.v_sb + kvh * a.v_sh, a.v_ss, k0, a.Skv);
    __syncthreads();
    if (!active) continue;
    float s[BKV<HD>];
#pragma unroll
    for (int j = 0; j < BKV<HD>; ++j) s[j] = 0.0f;
    const float4* q4 = reinterpret_cast<const float4*>(sq + r * LD);
#pragma unroll
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 x = q4[d4];
#pragma unroll
      for (int j = 0; j < BKV<HD>; ++j) {
        const float4 y = reinterpret_cast<const float4*>(sk + j * LD)[d4];
        s[j] = fmaf(x.x, y.x, s[j]);
        s[j] = fmaf(x.y, y.y, s[j]);
        s[j] = fmaf(x.z, y.z, s[j]);
        s[j] = fmaf(x.w, y.w, s[j]);
      }
    }
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BKV<HD>; ++j) {
      const int kp = k0 + j;
      const bool ok = kp < a.Skv && (!a.causal || kp <= qpos);
      s[j] = ok ? s[j] * a.scale : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < BKV<HD>; ++j) {
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
    for (int j = 0; j < BKV<HD>; ++j) {
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


template <int HD>
size_t smem_bytes(int R) {
  return sizeof(float) * static_cast<size_t>(R + 2 * BKV<HD>) * (HD + 4);
}

// Query positions per block of the scalar kernel (R = BQ * G <= 256 rows).
int block_q(int G) {
  int bq = 64;
  while (bq > 1 && bq * G > MAX_ROWS) bq /= 2;
  return bq;
}

template <int HD>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  const int R = a.BQ * a.G;
  const size_t smem = smem_bytes<HD>(R);
  static size_t configured = 0;  // per instantiation
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<float, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  const dim3 grid((a.Sq + a.BQ - 1) / a.BQ, a.K, B);
  flash_attention_kernel<float, HD><<<grid, MAX_ROWS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// The bfloat16 tensor-core kernel.

namespace tc {

constexpr int ROWS = 128;        // query rows per block: two warpgroups
constexpr int BKV = 64;          // keys per K/V tile
constexpr int STAGES = 3;        // K/V tiles in the ring
constexpr int THREADS = 288;     // two consumer warpgroups + a producer warp
constexpr int PRODUCER_WARP = 8;

template <int HD>
struct Shape {
  // bytes of one swizzled shared row: the head dim in 64-element column
  // halves under the 128-byte swizzle (hd >= 64), else one 64 / 32-byte row
  static constexpr int SW = HD * 2 >= 128 ? 128 : HD * 2;
  static constexpr int CHUNK = SW / 2;               // elements of a row
  static constexpr int NCH = HD / CHUNK;             // column chunks
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int Q_BYTES = ROWS * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;      // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
};

struct TcArgs {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  int B, Sq, Skv, H, K, G, causal, n_rb;
  long long q_sb, q_ss, q_sh;
  float sl2;                     // the softmax scale times log2(e)
};

// The byte offset of a 16-byte unit under the SW-byte swizzle (the
// pattern TMA writes and wgmma reads): bits [7, 7 + log2(SW/16)) of the
// offset are XORed into bits [4, ...), from a 1024-byte-aligned base.
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ ((off >> 3) & ((SW / 16 - 1) << 4));
}

// A (CHUNK x BKV x 1 x 1) box of a 4-d tensor map at (c0, c1, c2, c3) into
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// D (64 x 64, f32) (+)= A (64 x 16, shared) * B (16 x 64, shared),
// both K-major bf16 behind descriptors; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
// D (64 x 16, f32) += A (64 x 16, bf16 registers) * B (16 x 16, shared,
// MN-major bf16: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// D (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, shared,
// MN-major bf16: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, shared,
// MN-major bf16: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, shared,
// MN-major bf16: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 16) wgmma_rs_n16(d, a, b);
  if constexpr (HD == 32) wgmma_rs_n32(d, a, b);
  if constexpr (HD == 64) wgmma_rs_n64(d, a, b);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const TcArgs a) {
  using S = Shape<HD>;
  constexpr int SW = S::SW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms align
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + S::BAR_OFF;        // full[STAGES], empty[..]

  // block -> (row block, KV head, batch); causal row blocks longest first
  const int BK = a.B * a.K;
  int rb = blockIdx.x / BK;
  const int bk = blockIdx.x % BK, b = bk / a.K, kvh = bk % a.K;
  if (a.causal) rb = a.n_rb - 1 - rb;
  const int G = a.G, nrows = a.Sq * G, row0 = rb * ROWS;
  const int p_lo = row0 / G;                        // first position
  const int p_hi = (min(row0 + ROWS, nrows) - 1) / G;
  const int kv_end = a.causal ? min(a.Skv, p_hi + 1) : a.Skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                         // the producer
      mbar_init(bars + 8 * (STAGES + s), 8);              // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES)
          mbar_wait(bars + 8 * (STAGES + s), ((t / STAGES) - 1) & 1);
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, 2 * S::KV_BYTES);
        const uint32_t sk = base + S::Q_BYTES + s * 2 * S::KV_BYTES;
#pragma unroll
        for (int c = 0; c < S::NCH; ++c) {
          tma_load(sk + c * BKV * SW, &kmap, full, c * S::CHUNK, t * BKV,
                   kvh, b);
          tma_load(sk + S::KV_BYTES + c * BKV * SW, &vmap, full,
                   c * S::CHUNK, t * BKV, kvh, b);
        }
      }
    }
    return;
  }

  // consumers: stage the block's query rows (zeros past Sq * G), swizzled
  constexpr int UNITS = HD / 8;                     // 16-byte units a row
  for (int u = threadIdx.x; u < ROWS * UNITS; u += 256) {
    const int r = u / UNITS, j = u % UNITS, fr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (fr < nrows) {
      const int p = fr / G, h = kvh * G + fr % G;
      val = __ldg(reinterpret_cast<const uint4*>(
          a.q + b * a.q_sb + p * a.q_ss + h * a.q_sh + j * 8));
    }
    const int c = j / (SW / 16), jj = j % (SW / 16);
    *reinterpret_cast<uint4*>(
        smem + swizzle<SW>(c * ROWS * SW + r * SW + jj * 16)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 256;\n" ::: "memory");

  const int wg = warp >> 2, quad = lane & 3;
  const int rl = (warp & 3) * 16 + (lane >> 2);     // rows rl and rl + 8
  int prow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) prow[i] = (row0 + wg * 64 + rl + 8 * i) / G;

  float sacc[32];
  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const float sl2 = a.sl2;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, k0 = t * BKV;
    const uint32_t sk = base + S::Q_BYTES + s * 2 * S::KV_BYTES;
    const uint32_t sv = sk + S::KV_BYTES;
    mbar_wait(bars + 8 * s, (t / STAGES) & 1);

    // S = Q K^T over the head dim, 16 at a time
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < S::NCH; ++c) {
#pragma unroll
      for (int kk = 0; kk < SW / 32; ++kk) {
        const uint64_t dq = make_desc(
            base + c * ROWS * SW + wg * 64 * SW + kk * 32, 16, 8 * SW,
            S::LAYOUT);
        const uint64_t dk = make_desc(sk + c * BKV * SW + kk * 32, 16,
                                      8 * SW, S::LAYOUT);
        wgmma_ss_n64(sacc, dq, dk, (c | kk) != 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();

    // mask keys past Skv and, on tiles that cross the diagonal, above it;
    // element 4j + 2i + e is row rl + 8i, key k0 + 8j + 2 quad + e
    const bool edge = k0 + BKV > a.Skv || (a.causal && k0 + BKV - 1 > p_lo);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * j + 2 * quad + e;
            if (kp >= a.Skv || (a.causal && kp > prow[i]))
              sacc[4 * j + 2 * i + e] = -INFINITY;
          }
    }
    // online softmax in base 2, per row
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * i], sacc[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float ms = m_use * sl2;
      alpha[i] = exp2f(fmaf(m[i], sl2, -ms));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(sacc[4 * j + 2 * i + e], sl2, -ms));
          sacc[4 * j + 2 * i + e] = p;
          rs += p;
        }
      l[i] = fmaf(l[i], alpha[i], rs);
      m[i] = m_new;
    }
    // P as bf16 A fragments: keys 16kk .. 16kk + 15 are n-blocks 2kk, 2kk+1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        oacc[4 * j + 2 * i] *= alpha[i];
        oacc[4 * j + 2 * i + 1] *= alpha[i];
      }
    // O += P V, 16 keys at a time; V rows are keys, the head dim contiguous
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<HD>(oacc, pa[kk],
                   make_desc(sv + kk * 16 * SW, BKV * SW, 8 * SW, S::LAYOUT));
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));   // stage free
  }

  // o = acc / max(l, 1e-30); rows past Sq * G are not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.0f / fmaxf(li, 1e-30f);
    const int fr = row0 + wg * 64 + rl + 8 * i;
    if (fr >= nrows) continue;
    const int p = fr / G, h = kvh * G + fr % G;
    __nv_bfloat16* orow =
        a.o + ((static_cast<long long>(b) * a.Sq + p) * a.H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) =
          pack_bf16(oacc[4 * j + 2 * i] * inv, oacc[4 * j + 2 * i + 1] * inv);
  }
}

// The tensor map of a K or V operand (B, S, K, hd) as 4-d (hd, S, K, B)
// with its strides, read in (CHUNK x BKV) boxes under the SW-byte swizzle;
// a dimension of extent 1 gets a stride the encoder accepts (never used)
template <int HD>
int encode_kv(CUtensorMap* map, const void* ptr, int B, int S, int K,
              long long ss, long long sh, long long sb) {
  using Sh = Shape<HD>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long es = 2, fill = HD * es;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                        static_cast<cuuint64_t>(S),
                        static_cast<cuuint64_t>(K),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(S > 1 ? ss * es : fill),
      static_cast<cuuint64_t>(K > 1 ? sh * es : fill),
      static_cast<cuuint64_t>(B > 1 ? sb * es : fill)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(Sh::CHUNK),
                       static_cast<cuuint32_t>(BKV), 1u, 1u};
  cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  const CUtensorMapSwizzle sw = Sh::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : Sh::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int K, int causal, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           float scale, cudaStream_t stream) {
  using Sh = Shape<HD>;
  CUtensorMap kmap, vmap;
  int rc = encode_kv<HD>(&kmap, k, B, Skv, K, k_ss, k_sh, k_sb);
  if (rc == 0) rc = encode_kv<HD>(&vmap, v, B, Skv, K, v_ss, v_sh, v_sb);
  if (rc != 0) return rc;
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Sh::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int G = H / K;
  const long long rows = static_cast<long long>(Sq) * G;
  const int n_rb = static_cast<int>((rows + ROWS - 1) / ROWS);
  TcArgs a{static_cast<const __nv_bfloat16*>(q),
           static_cast<__nv_bfloat16*>(o), B, Sq, Skv, H, K, G, causal, n_rb,
           q_sb, q_ss, q_sh, scale * 1.4426950408889634f};
  const long long blocks = static_cast<long long>(n_rb) * B * K;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_tc<HD><<<static_cast<unsigned>(blocks), THREADS, Sh::SMEM,
                           stream>>>(kmap, vmap, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// Launches the attention on `stream`: dtype 0 = float32 (the scalar
// kernel), 1 = bfloat16 (the tensor-core kernel); strides in elements.
// Returns a cudaError_t code (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Skv, int H, int K,
                           int hd, int dtype, int causal, long long q_sb,
                           long long q_ss, long long q_sh, long long k_sb,
                           long long k_ss, long long k_sh, long long v_sb,
                           long long v_ss, long long v_sh, float scale,
                           void* stream) {
  if (K < 1 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
#define FA_TC(HD)                                                            \
  return tc::launch<HD>(q, k, v, o, B, Sq, Skv, H, K, causal, q_sb, q_ss,    \
                        q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, s)
    switch (hd) {
      case 16: FA_TC(16);
      case 32: FA_TC(32);
      case 64: FA_TC(64);
      case 128: FA_TC(128);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FA_TC
  }
  if (dtype != 0 || G > MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, Sq, Skv, H, K, G, block_q(G), causal,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale};
  switch (hd) {
    case 16: return launch_f32<16>(a, B, s);
    case 32: return launch_f32<32>(a, B, s);
    case 64: return launch_f32<64>(a, B, s);
    case 128: return launch_f32<128>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
