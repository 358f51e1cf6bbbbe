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
// output acc / max(l, 1e-30).
//
// Bound on the card: bytes (the K/V rows up to each length, read once; G
// multiply-adds per element read are far below the card's rate).  What the
// design does about it:
//
//   * the sequence is split: the grid is (n_splits, B * K * group chunks),
//     n_splits = ceil(Smax / split) chosen on the host from Smax (lengths
//     live on the device), so a batch-1 step runs n_splits * K blocks, not
//     K.  A block whose split starts at or past its row's length writes an
//     empty partial (m = -inf, l = 0) and exits;
//   * with more than one split, each block writes its partial (m, l, acc)
//     in float32 to a workspace; the last block of a row to finish (an
//     atomic counter per row, reset by that block) merges the partials in
//     split order 0, 1, ..., so the result does not depend on the order in
//     which blocks finish.  One launch.  With one split (every Smax up to
//     the split, the engine's 192 included) the block writes the output
//     directly: no workspace, no atomics;
//   * inside a block each of four warps walks its own positions with its
//     own online-softmax state, merged across warps once at the end: no
//     block-wide barrier in the loop.  A lane owns one 16-byte slice of the
//     head dim of one position per pass (bf16: 8 values, f32: 4), and streams
//     its own K and V slices through a four-stage ring of cp.async 16-byte
//     copies in shared memory (kept in the cache's dtype), so a lane's loads
//     for the next three iterations are in flight while it computes, and
//     it reads back only what it copied itself (no barrier at all);
//   * q (pre-scaled by scale * log2 e) and the accumulator live in the
//     lanes' registers for the whole split: each lane keeps its head-dim
//     slice of every query row of the group chunk (up to 8 rows, the
//     template's GM).  Scores are warp dot products: the slice products are
//     summed across the lanes of a position by xor shuffles.  Warp dot
//     products, not mma.sync: one code path serves float32 and bfloat16,
//     and at G <= 8 rows the multiply-adds and shuffles stay below the time
//     the bytes take;
//   * positions past the row's length are never read (zero-filled copies).
//
// bf16 scores (`bf16_scores`, bfloat16 inputs only): each q.k dot product
// is rounded to bfloat16 (round to nearest even) before the scale, as the
// reference's decode scores with preferred_element_type=bf16 are; q is then
// not pre-scaled, and the scale (times log2 e) multiplies the rounded
// score.  The probabilities stay float32 either way.
//
// Partial mode (`lse` not null): the launch writes each (batch, head) row's
// float32 partial instead of its output in the model's dtype: o = acc / l
// (the row's own softmax output) and its natural-log log-sum-exp
// lse = ln(sum exp(s)), both from the same merged (m, l, acc) the output
// would be made of, so o carries the float32 output's bits.  A row of
// length 0 (a sequence-sharded cache whose slice holds no valid position)
// gives o = 0 and lse = -inf.  Merging the partials of the slices of a
// sequence split across processes is the caller's (a few floats a row).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PASSES = 4;        // position rows a lane reads per iteration
constexpr int STAGES = 4;        // iterations in the cp.async ring
constexpr int MERGE_LOADS = 8;   // partials a merging thread loads at once

template <typename T, int HD>
struct Shape {
  static constexpr int EPL = 16 / sizeof(T);   // elements of a lane slice
  static constexpr int LPR = HD / EPL;         // lanes per position row
  static constexpr int RPP = 32 / LPR;         // positions per pass
  static constexpr int NPW = RPP * PASSES;     // positions a warp iteration
  static constexpr int NPB = NPW * WARPS;      // positions a block iteration
  // one warp's stage: K then V, PASSES x 32 lanes x 16 bytes each
  static constexpr int STAGE_BYTES = 2 * PASSES * 32 * 16;
  static constexpr int WARP_BYTES = STAGES * STAGE_BYTES;
  static constexpr int SMEM = WARPS * WARP_BYTES;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  void* o;
  float* lse;                    // partial mode: (B * H,) float32
  float* ws;                     // n_splits > 1: (m, l) then acc partials
  int32_t* counters;             // n_splits > 1: one per (row, group chunk)
  int K, G, Smax, split, n_splits, n_gc;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float sl2;                     // the softmax scale times log2(e)
  int bf16_scores;               // round each q.k to bfloat16 first
};

__device__ __forceinline__ void to_f32(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void to_f32(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
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

constexpr float LN2 = 0.6931471805599453f;

// Output element `i` of row `row` (element `d` of the head dim) from the
// merged (m, l, acc): the value in the model's dtype, or in partial mode
// the float32 o = acc / l, and the row's lse written by its element 0
template <typename T>
__device__ __forceinline__ void store_out(const Args& a, long long i,
                                          long long row, int d, float acc,
                                          float l, float m) {
  if (a.lse != nullptr) {
    static_cast<float*>(a.o)[i] = l > 0.0f ? acc / l : 0.0f;
    if (d == 0) a.lse[row] = l > 0.0f ? (m + log2f(l)) * LN2 : -INFINITY;
  } else {
    static_cast<T*>(a.o)[i] = from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
}

// 16 bytes global -> shared, zero-filled when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The copies of iteration `it` (if it < n_iter) into its ring stage: a
// lane's K and V slices of positions p0 + p * RPP, zeros at or past `end`;
// one commit group either way
template <typename T, int HD>
__device__ __forceinline__ void issue(uint32_t ring, const T* kbase,
                                      const T* vbase, long long k_ss,
                                      long long v_ss, int it, int n_iter,
                                      int p0, int end) {
  using S = Shape<T, HD>;
  if (it < n_iter) {
    const uint32_t st = ring + (it % STAGES) * S::STAGE_BYTES;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int pos = p0 + p * S::RPP;
      const bool ok = pos < end;
      const long long at = ok ? pos : 0;
      cp_async16(st + p * 512, kbase + at * k_ss, ok);
      cp_async16(st + (PASSES + p) * 512, vbase + at * v_ss, ok);
    }
  }
  cp_async_commit();
}

template <typename T, int HD, int GM>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const Args a) {
  using S = Shape<T, HD>;
  constexpr int EPL = S::EPL, LPR = S::LPR, RPP = S::RPP;
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int split = blockIdx.x, gc = blockIdx.y % a.n_gc;
  const int row = blockIdx.y / a.n_gc, b = row / a.K, kvh = row % a.K;
  const int G = a.G, g0 = gc * GM, gn = min(GM, G - g0);
  const int len = max(0, min(a.lengths[row], a.Smax));
  const int s0 = split * a.split;
  const int end = min(len, min(s0 + a.split, a.Smax));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane / LPR, c = lane % LPR;
  // partials of (row, head) h go to ws: (m, l) at [(row * G + h) *
  // n_splits + split], acc after all of those
  const long long n_ml = static_cast<long long>(gridDim.y / a.n_gc) * G *
                         a.n_splits;
  float* ws_ml = a.ws;
  float* ws_acc = a.ws + 2 * n_ml;
  __shared__ int last;

  if (s0 < end) {
    const T* kbase = k + b * a.k_sb + kvh * a.k_sh + c * EPL;
    const T* vbase = v + b * a.v_sb + kvh * a.v_sh + c * EPL;
    const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(
                              smem + warp * S::WARP_BYTES)) + lane * 16;
    const int n_iter = (end - s0 + S::NPB - 1) / S::NPB;
    const int p_lane = s0 + warp * S::NPW + r;   // iteration 0, pass 0
#pragma unroll
    for (int it = 0; it < STAGES - 1; ++it)
      issue<T, HD>(ring, kbase, vbase, a.k_ss, a.v_ss, it, n_iter,
                   p_lane + it * S::NPB, end);

    float qr[GM][EPL], acc[GM][EPL], m[GM], l[GM];
    const float qs = a.bf16_scores ? 1.0f : a.sl2;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const T* qrow = q + b * a.q_sb + (kvh * G + g0 + g) * a.q_sh + c * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        qr[g][e] = g < gn ? to_f32(qrow[e]) * qs : 0.0f;
        acc[g][e] = 0.0f;
      }
      m[g] = -INFINITY;
      l[g] = 0.0f;
    }

    for (int it = 0; it < n_iter; ++it) {
      issue<T, HD>(ring, kbase, vbase, a.k_ss, a.v_ss, it + STAGES - 1,
                   n_iter, p_lane + (it + STAGES - 1) * S::NPB, end);
      cp_async_wait<STAGES - 1>();             // iteration it has landed
      const uint8_t* st = smem + warp * S::WARP_BYTES +
                          (it % STAGES) * S::STAGE_BYTES + lane * 16;
      const int p0 = p_lane + it * S::NPB;
      // scores (base-2 units) of this lane's positions
      float sc[PASSES][GM];
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        float kf[EPL];
        to_f32(*reinterpret_cast<const uint4*>(st + p * 512), kf, T());
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float d = 0.0f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
          for (int o = 1; o < LPR; o <<= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          if (a.bf16_scores)
            d = __bfloat162float(__float2bfloat16_rn(d)) * a.sl2;
          sc[p][g] = p0 + p * RPP < end ? d : -INFINITY;
        }
      }
      // the warp's running max, rescale, probabilities, then acc += p v
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = sc[0][g];
#pragma unroll
        for (int p = 1; p < PASSES; ++p) mx = fmaxf(mx, sc[p][g]);
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[g], mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = exp2f(m[g] - m_use);
        m[g] = m_new;
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          sc[p][g] = exp2f(sc[p][g] - m_use);
          l[g] += sc[p][g];
        }
      }
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        float vf[EPL];
        to_f32(*reinterpret_cast<const uint4*>(st + (PASSES + p) * 512), vf,
               T());
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[g][e] = fmaf(sc[p][g], vf[e], acc[g][e]);
      }
    }
    cp_async_wait<0>();
    __syncwarp();
    // sum l and acc over the warp's positions (lanes of one slice), then
    // publish the warp's state in its own ring region
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    float* wst = reinterpret_cast<float*>(smem + warp * S::WARP_BYTES);
    if (r == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          wst[2 * GM + g * HD + c * EPL + e] = acc[g][e];
      if (c == 0) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          wst[g] = m[g];
          wst[GM + g] = l[g];
        }
      }
    }
    __syncthreads();
    // merge the warps in order 0..3: this block's partial, or the output
    for (int i = tid; i < gn * HD; i += THREADS) {
      const int g = i / HD, d = i % HD;
      float mb = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        mb = fmaxf(mb, reinterpret_cast<const float*>(
                           smem + w * S::WARP_BYTES)[g]);
      float lb = 0.0f, ab = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float* ww = reinterpret_cast<const float*>(
            smem + w * S::WARP_BYTES);
        if (ww[g] == -INFINITY) continue;      // a warp with no position
        const float f = exp2f(ww[g] - mb);
        lb = fmaf(ww[GM + g], f, lb);
        ab = fmaf(ww[2 * GM + g * HD + d], f, ab);
      }
      const int h = kvh * G + g0 + g;
      if (a.n_splits == 1) {
        const long long orow = static_cast<long long>(b) * a.K * G + h;
        store_out<T>(a, orow * HD + d, orow, d, ab, lb, mb);
      } else {
        const long long pi = (static_cast<long long>(row) * G + g0 + g) *
                                 a.n_splits + split;
        ws_acc[pi * HD + d] = ab;
        if (d == 0) {
          ws_ml[2 * pi] = mb;
          ws_ml[2 * pi + 1] = lb;
        }
      }
    }
    if (a.n_splits == 1) return;
  } else {
    if (a.n_splits == 1) {                    // a row of length 0
      for (int i = tid; i < gn * HD; i += THREADS) {
        const long long orow = static_cast<long long>(b) * a.K * G +
                               kvh * G + g0 + i / HD;
        store_out<T>(a, orow * HD + i % HD, orow, i % HD, 0.0f, 0.0f,
                     -INFINITY);
      }
      return;
    }
    for (int g = tid; g < gn; g += THREADS) {   // an empty partial
      const long long pi = (static_cast<long long>(row) * G + g0 + g) *
                               a.n_splits + split;
      ws_ml[2 * pi] = -INFINITY;
      ws_ml[2 * pi + 1] = 0.0f;
    }
  }

  // the last block of this (row, group chunk) merges the splits in order
  __threadfence();
  __syncthreads();
  int32_t* counter = a.counters + blockIdx.y;
  if (tid == 0) last = atomicAdd(counter, 1) == a.n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the largest m of each row (a warp a row, its lanes over the splits),
  // then a thread a (row, element) sums the splits' l and acc in split
  // order, weighted by exp2(m_s - m), MERGE_LOADS splits' loads in flight
  // at a time (an empty split's m is -inf, its l and acc zeros)
  const int NS = a.n_splits;
  float* smax = reinterpret_cast<float*>(smem);         // (gn,)
  for (int g = warp; g < gn; g += WARPS) {
    const long long p0 = (static_cast<long long>(row) * G + g0 + g) * NS;
    float mt = -INFINITY;
    for (int s = lane; s < NS; s += 32)
      mt = fmaxf(mt, __ldcg(ws_ml + 2 * (p0 + s)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    if (lane == 0) smax[g] = mt;
  }
  __syncthreads();
  for (int i = tid; i < gn * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    const long long p0 = (static_cast<long long>(row) * G + g0 + g) * NS;
    const float mt = smax[g];
    float lt = 0.0f, at = 0.0f;
#pragma unroll 1
    for (int s0 = 0; s0 < NS; s0 += MERGE_LOADS) {
      float m[MERGE_LOADS], l[MERGE_LOADS], v[MERGE_LOADS];
#pragma unroll
      for (int j = 0; j < MERGE_LOADS; ++j) {
        const long long ps = p0 + min(s0 + j, NS - 1);
        m[j] = __ldcg(ws_ml + 2 * ps);
        l[j] = __ldcg(ws_ml + 2 * ps + 1);
        v[j] = __ldcg(ws_acc + ps * HD + d);
      }
#pragma unroll
      for (int j = 0; j < MERGE_LOADS; ++j) {
        if (s0 + j < NS && m[j] != -INFINITY) {
          const float w = exp2f(m[j] - mt);
          lt = fmaf(l[j], w, lt);
          at = fmaf(v[j], w, at);
        }
      }
    }
    const long long orow = static_cast<long long>(b) * a.K * G + kvh * G +
                           g0 + g;
    store_out<T>(a, orow * HD + d, orow, d, at, lt, mt);
  }
  if (tid == 0) *counter = 0;                  // ready for the next call
}

// The group chunk: the fewest of 1, 2, 4, 8 query rows a block that holds
// the group (G > 8 takes chunks of 8)
int group_chunk(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

template <typename T, int HD, int GM>
int launch(const Args& a, int rows, cudaStream_t stream) {
  constexpr int smem = Shape<T, HD>::SMEM;
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, HD, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(a.n_splits, rows * a.n_gc);
  decode_attention_kernel<T, HD, GM><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_g(const Args& a, int rows, cudaStream_t s) {
  switch (group_chunk(a.G)) {
    case 1: return launch<T, HD, 1>(a, rows, s);
    case 2: return launch<T, HD, 2>(a, rows, s);
    case 4: return launch<T, HD, 4>(a, rows, s);
    default: return launch<T, HD, 8>(a, rows, s);
  }
}

template <typename T>
int launch_hd(const Args& a, int rows, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_g<T, 16>(a, rows, s);
    case 32: return launch_g<T, 32>(a, rows, s);
    case 64: return launch_g<T, 64>(a, rows, s);
    case 128: return launch_g<T, 128>(a, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the decode attention on `stream`: dtype 0 = float32,
// 1 = bfloat16; strides in elements; `split` positions a block.  `lse`
// null: `o` (B, H, hd) in the inputs' dtype; otherwise partial mode, `o`
// float32 (B, H, hd) and `lse` float32 (B, H) (see the top).  With
// n_splits = ceil(Smax / split) > 1, `ws` holds B*K*G*n_splits*(2 + hd)
// floats and `counters` B*K*G int32 zeros (left zero after the launch).
// `bf16_scores` nonzero: each q.k rounded to bfloat16 before the scale
// (bfloat16 inputs; float32 ones ignore it).  Returns a cudaError_t code
// (0 = launched).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int32_t* lengths, void* o, float* lse,
                            float* ws,
                            int32_t* counters, int B, int Smax, int H, int K,
                            int hd, int dtype, int split, long long q_sb,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, float scale, int bf16_scores,
                            void* stream) {
  if (K < 1 || H % K != 0 || split < 1 || Smax < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K, n_splits = (Smax + split - 1) / split;
  if (n_splits > 1 && (ws == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_gc = (G + group_chunk(G) - 1) / group_chunk(G);
  Args a{q, k, v, lengths, o, lse, ws, counters, K, G, Smax, split,
         n_splits, n_gc, q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         scale * 1.4426950408889634f, bf16_scores != 0 && dtype == 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(a, B * K, hd, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, B * K, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
