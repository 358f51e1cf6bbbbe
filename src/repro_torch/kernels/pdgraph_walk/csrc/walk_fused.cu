// Fused PDGraph refresh kernel for Hopper (sm_90a): counter-RNG Monte-Carlo
// walk -> per-app demand-histogram row -> Gittins rank -> per-(app, unit)
// arrival-histogram rows, in one launch.
//
// Replaces the TPU kernel pdgraph_walk_fused_kernel
// (src/repro/kernels/pdgraph_walk/kernel.py, body _kernel).  The TPU version
// selects table rows with one-hot matrix products because TPU Pallas has no
// vector gather; none of that is carried over.
//
// Bound on the card: latency, and at thousands of apps the instruction
// issue of the walk.  A walker-step is a dependent chain (hash -> sample ->
// CDF scan) of a few tens of operations (no conversion instructions: see
// small_uint_to_float), the walk is about
// N * mean_steps of them (4.7 steps a walker at the main path's tables,
// the longest of an app's walkers 64), and DRAM traffic is the per-app
// inputs and output rows.  What the design does about it:
//
//   * one block of `threads` (32 to 256) per application; each thread walks
//     one walker at a time and, when it is absorbed, takes the next from a
//     block-wide counter in shared memory, so lanes stay busy until the
//     app's walkers run out instead of idling behind the longest walker of
//     their warp (a walker's draws are keyed by (stream, its own step, w),
//     so which thread walks it changes no bit);
//   * every table a step reads is staged in shared memory, in one round of
//     cp.async copies (16 bytes where aligned) that the block issues at
//     once and waits for once: the
//     app's transition CDF rows (the graph's, or its posterior rows), the
//     sample counts, the posterior ratios, the graph's samples and the
//     app's override rows, so a step makes no global read;
//   * a walker's first-arrival times stay in registers (UMAX of them, the
//     CDF scan unrolled over UMAX >= U), written to shared memory once,
//     when the walker is absorbed;
//   * epilogue in parallel: block min/max (order-free), bucket counts by
//     warp ballots, one per bit of the bucket index (exact integers, no
//     atomics), probs and edges one lane per bucket, the rank one lane per candidate bucket j (each lane keeps
//     the plain version's left-to-right chain over b, the min over j is
//     order-free), and one warp per unit builds its [hist | lo | span |
//     n_reach] arrival row, the lanes writing its nb + 3 floats together.
//
// With posterior tables (online PDGraph learning) the block stages its
// app's posterior CDF rows in place of the graph's, and the per-unit demand
// ratios beside them; the step multiplies each sampled service by the ratio
// behind the reference's max(., 0) guard.
//
// Bits: every float op is spelled with an explicit rounding intrinsic and
// the file is built with -fmad=false, so nothing is contracted except the
// rank's bucket sum, which is a deliberate __fmaf_rn chain — the same chain
// XLA emits for the reference on the CPU and the plain PyTorch version
// emulates (repro_torch.core.gittins.fma32).
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "walk_step.cuh"

namespace {

using namespace pdgraph_walk;

constexpr float kEm3 = 0x1.0624dep-10f;         // 1e-3
constexpr float kEm6 = 0x1.0c6f7ap-20f;         // 1e-6
constexpr float kEm12 = 0x1.197998p-40f;        // 1e-12
constexpr float kOneMinusEm6 = 0x1.ffffdep-1f;  // 1 - 1e-6
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;                    // 256 threads a block

struct Args {
  const float* samples;     // (G, U, S)
  const float* counts;      // (G, U)
  const float* cum;         // (G, U, U+1)
  const float* ov_samples;  // (A*U, So) or null
  const float* ov_counts;   // (A*U,) or null
  const float* attained;    // (A,)
  const int32_t* start;     // (A,)
  const int32_t* graph_idx; // (A,)
  const uint32_t* streams;  // (A,)
  const float* executed;    // (A,)
  const uint8_t* valid;     // (A,)
  const float* po_cum;      // (A*U, U+1) or null
  const float* po_scale;    // (A*U,) or null
  float* probs;             // (A, nb)
  float* edges;             // (A, nb)
  float* ranks;             // (A,)
  float* arrstats;          // (A*U, nb+3) or null
  float* rem;               // (A, W) or null
  int A, W, U, S, So, max_steps, nb;
  float inv_w, inv_nb;
};

// Word offsets of a block's shared-memory arrays (one source for the kernel
// and for the size the launcher asks for); the sample rows start 16-byte
// aligned, for 16-byte copies.
struct Layout {
  int cum, scale, cnt_g, ovc, neff, useov, samp, ovs, tot, arr, cnt, red,
      rank, next, words;
};
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline Layout layout(int W, int U, int S, int So,
                                         int warps, bool with_ov,
                                         bool with_arr) {
  Layout L;
  L.cum = 0;
  L.scale = L.cum + U * (U + 1);
  L.cnt_g = L.scale + U;
  L.ovc = L.cnt_g + U;
  L.neff = L.ovc + U;
  L.useov = L.neff + U;
  L.samp = round4(L.useov + U);
  L.ovs = L.samp + round4(U * S);
  L.tot = L.ovs + (with_ov ? round4(U * So) : 0);
  L.arr = L.tot + W;
  L.cnt = L.arr + (with_arr ? U * W : 0);
  L.red = L.cnt + 32 * warps;
  L.rank = L.red + 2 * warps;
  L.next = L.rank + 4 * 32;
  L.words = L.next + 1;
  return L;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// How many lanes of the (converged) warp have `ok` and bucket `idx` equal
// to the caller's lane (for lanes below nb; idx < 32): one ballot per bit
// of idx, and each lane keeps the lanes whose bits match its own.
__device__ __forceinline__ int lane_bucket_count(int idx, bool ok, int lane) {
  unsigned m = __ballot_sync(kFull, ok);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const unsigned bk = __ballot_sync(kFull, (idx >> k) & 1);
    m &= ((lane >> k) & 1) ? bk : ~bk;
  }
  return __popc(m);
}

// A copy from global to shared memory that does not wait for its data
// (cp.async, 16 or 4 bytes): staging issues all of a block's copies, then
// waits once.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n floats from src to dst (shared) by the block's threads: 16-byte copies
// where both start 16-byte aligned, 4-byte copies for the rest.
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n,
                                         int tid, int T) {
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        static_cast<uintptr_t>(__cvta_generic_to_shared(dst))) & 15) == 0) {
    head = n & ~3;
    for (int i = 4 * tid; i < head; i += 4 * T) copy_async16(dst + i, src + i);
  }
  for (int i = head + tid; i < n; i += T) copy_async(dst + i, src + i);
}

template <int UMAX>
__global__ void __launch_bounds__(256) walk_fused_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int U = p.U, W = p.W, S = p.S, So = p.So, nb = p.nb, U1 = U + 1;
  const bool with_ov = p.ov_samples != nullptr;
  const bool with_arr = p.arrstats != nullptr;
  const bool with_po = p.po_cum != nullptr;

  const Layout L = layout(W, U, S, So, nwarps, with_ov, with_arr);
  float* const f = reinterpret_cast<float*>(smem);
  float* s_cum = f + L.cum;                    // U*(U+1)
  float* s_scale = f + L.scale;                // U
  float* s_cnt_g = f + L.cnt_g;                // U graph counts
  float* s_ovc = f + L.ovc;                    // U override counts
  float* s_neff = f + L.neff;                  // U
  int* s_useov = reinterpret_cast<int*>(f + L.useov);  // U
  float* s_samp = f + L.samp;                  // U*S, 16-byte aligned
  float* s_ovs = f + L.ovs;                    // U*So (overrides)
  float* s_tot = f + L.tot;                    // W
  float* s_arr = f + L.arr;                    // U*W (arrivals)
  int* s_cnt = reinterpret_cast<int*>(f + L.cnt);      // 32 per warp
  float* s_red = f + L.red;                    // 2 per warp
  float* s_rank = f + L.rank;                  // 4 * 32
  int* s_next = reinterpret_cast<int*>(f + L.next);    // 1

  // ------------------------------------------------------------ staging
  // the app's row, then every table a step reads in one round of copies
  const int g = p.graph_idx[a];
  const uint32_t stream = p.streams[a];
  const float ex = p.executed[a];
  const float att = p.attained[a];
  const int start = p.start[a];
  // an invalid (padding) row's walkers start absorbed
  const int max_steps = p.valid[a] != 0 ? p.max_steps : 0;
  const float* g_cum = with_po ? p.po_cum + static_cast<size_t>(a) * U * U1
                               : p.cum + static_cast<size_t>(g) * U * U1;
  for (int i = tid; i < U * U1; i += T) copy_async(s_cum + i, g_cum + i);
  for (int u = tid; u < U; u += T) {
    copy_async(s_cnt_g + u, p.counts + g * U + u);
    if (with_ov) copy_async(s_ovc + u, p.ov_counts + a * U + u);
    if (with_po) copy_async(s_scale + u, p.po_scale + a * U + u);
  }
  copy_row(s_samp, p.samples + static_cast<size_t>(g) * U * S, U * S, tid, T);
  if (with_ov)
    copy_row(s_ovs, p.ov_samples + static_cast<size_t>(a) * U * So, U * So,
             tid, T);
  if (tid == 0) *s_next = T;
  copy_wait_all();
  __syncthreads();
  // per unit: the sample count and row a step draws from (the override
  // row where the app has one)
  for (int u = tid; u < U; u += T) {
    const bool use = with_ov && s_ovc[u] > 0.0f;
    s_neff[u] = use ? s_ovc[u] : s_cnt_g[u];
    s_useov[u] = use;
    if (!with_po) s_scale[u] = 1.0f;
  }
  __syncthreads();

  // ---------------------------------------------------------------- walk
  int w = tid;
  int cur = start, s = 0;
  float total = 0.0f;
  float arr[UMAX];
#pragma unroll
  for (int u = 0; u < UMAX; ++u) arr[u] = kNever;
  uint32_t bits = fmix32(stream + step_counter(0, W, w) * kGolden);
  while (w < W) {
    bool done = s >= max_steps;
    if (!done) {
      const float r = __fmul_rn(small_uint_to_float(bits >> 16), kU16);
      const float r2 = __fmul_rn(small_uint_to_float(bits & 0xFFFFu), kU16);
      const int si = floor_small(__fmul_rn(r, s_neff[cur]));
      float svc = s_useov[cur] ? s_ovs[cur * So + min(si, So - 1)]
                               : s_samp[cur * S + si];
      if (with_po) svc = fmaxf(__fmul_rn(svc, s_scale[cur]), 0.0f);
      if (s == 0) svc = fmaxf(__fsub_rn(svc, ex), 0.0f);
      total = __fadd_rn(total, svc);
      const int nxt = cdf_next<UMAX>(s_cum + cur * U1, U, r2);
      ++s;
      // the next step's draw, while this step's reads are in flight
      bits = fmix32(stream + step_counter(s, W, w) * kGolden);
      if (nxt >= U) {
        done = true;
      } else {
#pragma unroll
        for (int u = 0; u < UMAX; ++u)
          if (u == nxt) arr[u] = fminf(arr[u], total);
        cur = nxt;
      }
    }
    if (done) {
      if (p.rem != nullptr) p.rem[static_cast<size_t>(a) * W + w] = total;
      s_tot[w] = __fadd_rn(att, fmaxf(total, 0.0f));
      if (with_arr) {
#pragma unroll
        for (int u = 0; u < UMAX; ++u)
          if (u < U) s_arr[u * W + w] = arr[u];
      }
      w = atomicAdd(s_next, 1);
      cur = start;
      s = 0;
      total = 0.0f;
#pragma unroll
      for (int u = 0; u < UMAX; ++u) arr[u] = kNever;
      bits = fmix32(stream + step_counter(0, W, w) * kGolden);
    }
  }
  __syncthreads();

  // ------------------------------------------- demand histogram and rank
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (int i = tid; i < W; i += T) {
    lo = fminf(lo, s_tot[i]);
    hi = fmaxf(hi, s_tot[i]);
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    s_red[warp] = lo;
    s_red[nwarps + warp] = hi;
  }
  __syncthreads();
  lo = s_red[0];
  hi = s_red[nwarps];
  for (int i = 1; i < nwarps; ++i) {
    lo = fminf(lo, s_red[i]);
    hi = fmaxf(hi, s_red[nwarps + i]);
  }
  if (hi <= lo) hi = __fadd_rn(lo, fmaxf(__fmul_rn(fabsf(lo), kEm3), kEm6));
  const float norm = __fdiv_rn(static_cast<float>(nb), __fsub_rn(hi, lo));
  int cnt = 0;
  for (int w0 = warp * 32; w0 < W; w0 += T) {
    const int i = w0 + lane;
    int idx = 0;
    if (i < W) {
      idx = __float2int_rz(__fmul_rn(__fsub_rn(s_tot[i], lo), norm));
      idx = min(max(idx, 0), nb - 1);
    }
    cnt += lane_bucket_count(idx, i < W, lane);
  }
  s_cnt[warp * 32 + lane] = cnt;
  __syncthreads();

  if (warp == 0) {
    // lane b: bucket b's probability and right edge
    float* probs = s_rank;
    float* edges = s_rank + 32;
    float* rem = s_rank + 64;
    float* pc = s_rank + 96;
    const int b = lane;
    float pr = 0.0f;
    if (b < nb) {
      int c = 0;
      for (int i = 0; i < nwarps; ++i) c += s_cnt[i * 32 + b];
      pr = __fmul_rn(static_cast<float>(c), p.inv_w);
      const float frac = __fmul_rn(static_cast<float>(b + 1), p.inv_nb);
      const float ed = b == nb - 1
          ? hi : __fadd_rn(lo, fmaxf(__fmul_rn(__fsub_rn(hi, lo), frac), 0.0f));
      probs[b] = pr;
      edges[b] = ed;
      p.probs[a * nb + b] = pr;
      p.edges[a * nb + b] = ed;
    }
    __syncwarp();
    // Gittins rank: the float ops of repro_torch.core.gittins.
    // gittins_rank_core, in its order, lane b holding bucket b.  The row
    // arrays the lanes share live in shared memory (an earlier form kept
    // the rank's arrays in per-thread local arrays, and its sm_90a build
    // gave a wrong rank for every app; the cause was not found).
    const float max_edge = edges[nb - 1];
    const bool exhausted = att >= max_edge;
    const float at = fminf(att, __fmul_rn(max_edge, kOneMinusEm6));
    float mid = 0.0f;
    bool alive = false;
    if (b < nb) {
      // bucket 0's left edge extrapolated from its width; each later
      // bucket's left edge is its neighbour's right edge
      const float left = b == 0
          ? __fadd_rn(__fmul_rn(edges[0], 0.0f),
                      __fsub_rn(__fmul_rn(2.0f, edges[0]), edges[1]))
          : edges[b - 1];
      mid = __fmul_rn(0.5f, __fadd_rn(left, edges[b]));
      alive = mid > at;
    }
    // the tail mass, summed left to right as the plain version does
    const float term = alive ? pr : 0.0f;
    float tail = __shfl_sync(kFull, term, 0);
    for (int i = 1; i < nb; ++i) tail = __fadd_rn(tail, __shfl_sync(kFull, term, i));
    const float tail_mass = fmaxf(tail, kEm12);
    float my_rem = 0.0f;
    if (b < nb) {
      pc[b] = __fdiv_rn(term, tail_mass);
      my_rem = alive ? __fsub_rn(mid, at) : 0.0f;
      rem[b] = my_rem;
    }
    __syncwarp();
    float ratio = kNever;
    if (b < nb) {
      float e = 0.0f, pl = 0.0f;
      for (int i = 0; i < nb; ++i) {
        const float ri = rem[i], pi = pc[i];
        e = __fmaf_rn(fminf(ri, my_rem), pi, e);
        pl = __fadd_rn(pl, ri <= my_rem ? pi : 0.0f);
      }
      if (pl > kEm12 && alive) ratio = __fdiv_rn(e, fmaxf(pl, kEm12));
    }
    const float rank = fminf(kNever, warp_min(ratio));
    if (lane == 0) p.ranks[a] = exhausted ? att : rank;
  }

  // ------------------------------------------------ arrival histogram rows
  if (!with_arr) return;
  for (int u = warp; u < U; u += nwarps) {
    const float* col = s_arr + u * W;
    int n = 0;
    float ulo = kNever, uhi = -kNever;
    for (int i = lane; i < W; i += 32) {
      const float v = col[i];
      if (v < kHalfNever) {
        ++n;
        ulo = fminf(ulo, v);
        uhi = fmaxf(uhi, v);
      }
    }
    n = warp_sum(n);
    ulo = warp_min(ulo);
    uhi = warp_max(uhi);
    const float span = fmaxf(__fsub_rn(uhi, ulo), kEm6);
    const float scale = __fdiv_rn(static_cast<float>(nb), span);
    int c = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      const int i = w0 + lane;
      const float v = i < W ? col[i] : kNever;
      const bool ok = v < kHalfNever;
      int idx = 0;
      if (ok) {
        idx = __float2int_rz(__fmul_rn(__fsub_rn(v, ulo), scale));
        idx = min(max(idx, 0), nb - 1);
      }
      c += lane_bucket_count(idx, ok, lane);
    }
    float* row = p.arrstats + (static_cast<size_t>(a) * U + u) * (nb + 3);
    for (int i = lane; i < nb + 3; i += 32)
      row[i] = i < nb ? static_cast<float>(c)
                      : i == nb ? ulo
                      : i == nb + 1 ? span : static_cast<float>(n);
  }
}

template <int UMAX>
int launch(const Args& p, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      walk_fused_kernel<UMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_fused_kernel<UMAX><<<p.A, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block of `threads` needs, in bytes (the wrapper checks
// it against the card's limit before launching).
size_t pdgraph_walk_fused_smem(int W, int U, int S, int So, int threads,
                               int with_ov, int with_arr) {
  return static_cast<size_t>(
             layout(W, U, S, So, threads / 32, with_ov, with_arr).words) * 4;
}

// Launches the kernel on `stream` with `threads` (a multiple of 32, at most
// 256) a block and the CDF scan unrolled over `umax` (4, 8, 16 or 32, at
// least U); returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a plan the kernel does not take.
int pdgraph_walk_fused(const float* samples, const float* counts,
                       const float* cum, const float* ov_samples,
                       const float* ov_counts, const float* attained,
                       const int32_t* start, const int32_t* graph_idx,
                       const uint32_t* streams, const float* executed,
                       const uint8_t* valid, const float* po_cum,
                       const float* po_scale, float* probs, float* edges,
                       float* ranks, float* arrstats, float* rem, int A, int W,
                       int U, int S, int So, int max_steps, int nb,
                       int threads, int umax, float inv_w, float inv_nb,
                       void* stream) {
  if (threads < 32 || threads > 32 * kMaxWarps || threads % 32 != 0 ||
      U < 1 || U > umax || nb < 2 || nb > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{samples, counts, cum, ov_samples, ov_counts, attained, start,
         graph_idx, streams, executed, valid, po_cum, po_scale, probs, edges,
         ranks, arrstats, rem, A, W, U, S, So, max_steps, nb, inv_w, inv_nb};
  const size_t smem = pdgraph_walk_fused_smem(
      W, U, S, So, threads, ov_samples != nullptr, arrstats != nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (umax) {
    case 4: return launch<4>(p, threads, smem, s);
    case 8: return launch<8>(p, threads, smem, s);
    case 16: return launch<16>(p, threads, smem, s);
    case 32: return launch<32>(p, threads, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* pdgraph_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
