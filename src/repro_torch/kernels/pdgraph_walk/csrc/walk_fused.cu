// Fused PDGraph refresh kernel for Hopper (sm_90a): counter-RNG Monte-Carlo
// walk -> per-app demand-histogram row -> Gittins rank -> per-(app, unit)
// arrival-histogram rows, in one launch.
//
// Replaces the TPU kernel pdgraph_walk_fused_kernel
// (src/repro/kernels/pdgraph_walk/kernel.py, body _kernel).  The TPU version
// selects table rows with one-hot matrix products because TPU Pallas has no
// vector gather; none of that is carried over.  Here:
//
//   * one CTA per application, one thread per walker (threads loop over the
//     walkers when W exceeds the block);
//   * the CTA stages its graph's (U, U+1) transition CDF rows, the per-unit
//     sample counts and the app's override rows in shared memory; demand
//     samples are gathered straight through the read-only cache (a walker
//     touches a handful of the S samples per unit, fewer than staging the
//     rows would read);
//   * each walker steps until it is absorbed or max_steps, so early exit
//     takes the place of the TPU's phase compaction (exact: an absorbed
//     walker adds 0.0 and draws nothing that is kept); first-arrival times
//     live in a (U, W) shared-memory tile;
//   * epilogue: block min/max (order-free), integer bucket counts through
//     shared-memory atomics (exact), then one thread computes probs, edges
//     and the rank in the plain version's sequential order, and one warp per
//     unit builds the [hist | lo | span | n_reach] arrival row.
//
// With posterior tables (online PDGraph learning) the CTA stages its app's
// posterior CDF rows in place of the graph's, and the per-unit demand
// ratios beside them; the step multiplies each sampled service by the ratio
// behind the reference's max(., 0) guard.  The step body is walk_step.cuh,
// shared with the per-phase walk kernel (walk_phase.cu).
//
// Bits: every float op is spelled with an explicit rounding intrinsic and
// the file is built with -fmad=false, so nothing is contracted except the
// rank's bucket sum, which is a deliberate __fmaf_rn chain — the same chain
// XLA emits for the reference on the CPU and the plain PyTorch version
// emulates (repro_torch.core.gittins.fma32).
//
// Bound on the card: latency and the integer ALU.  Each walker-step is a
// dependent chain of ~30 integer/float ops (hash, gather, CDF scan), and the
// walk is about N * mean_steps of them; DRAM traffic is the per-app inputs
// and output rows, well under 1 MB per delta tick.
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

// One app's table rows, staged in shared memory (service samples are read
// from global memory through the read-only cache).
struct SharedRows {
  const float* neff;      // (U,) sample count, override count where used
  const int* useov;       // (U,)
  const float* ov;        // (U, So) the app's override rows
  const float* samples;   // (U, S) the graph's samples, global
  const float* cum;       // (U, U+1) graph CDF or app posterior CDF
  const float* po_scale;  // (U,)
  int S, So, U1;
  bool posterior;

  __device__ __forceinline__ float n_eff(int cur) const { return neff[cur]; }
  __device__ __forceinline__ float sample(int cur, int si) const {
    return useov[cur] ? ov[cur * So + min(si, So - 1)]
                      : __ldg(samples + static_cast<size_t>(cur) * S + si);
  }
  __device__ __forceinline__ float scale(int cur) const { return po_scale[cur]; }
  __device__ __forceinline__ const float* cdf(int cur) const {
    return cum + cur * U1;
  }
};

// Block-wide min and max of one value per thread; every thread gets both.
__device__ void block_minmax(float& lo, float& hi, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) {
    red[warp] = lo;
    red[32 + warp] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[32];
  for (int i = 1; i < nwarps; ++i) {
    lo = fminf(lo, red[i]);
    hi = fmaxf(hi, red[32 + i]);
  }
}

// Gittins rank of one histogram row: the same float ops, in the same order,
// as repro_torch.core.gittins.gittins_rank_core.
// The row arrays live in shared memory (`rk`, 4 * nb words).  An earlier
// form kept them in per-thread local arrays, and its sm_90a build gave a
// wrong rank for every app; building that form with -Xcicc -O0 also gave
// the right ranks.  Whether the fault was the compiler's or undefined
// behaviour in that form was not found.
__device__ float gittins_rank(const float* probs, const float* edges,
                              float att, int nb, float* rk) {
  float* mids = rk;
  float* rem = rk + nb;
  float* pc = rk + 2 * nb;
  int* alive = reinterpret_cast<int*>(rk + 3 * nb);
  // left edge of bucket 0 extrapolated from the first bucket's width; each
  // later bucket's left edge is its neighbour's right edge
  float left = __fadd_rn(__fmul_rn(edges[0], 0.0f),
                         __fsub_rn(__fmul_rn(2.0f, edges[0]), edges[1]));
  for (int b = 0; b < nb; ++b) {
    mids[b] = __fmul_rn(0.5f, __fadd_rn(left, edges[b]));
    left = edges[b];
  }
  const float max_edge = edges[nb - 1];
  const bool exhausted = att >= max_edge;
  const float a = fminf(att, __fmul_rn(max_edge, kOneMinusEm6));
  alive[0] = mids[0] > a;
  float tail = alive[0] ? probs[0] : 0.0f;
  for (int b = 1; b < nb; ++b) {
    alive[b] = mids[b] > a;
    tail = __fadd_rn(tail, alive[b] ? probs[b] : 0.0f);
  }
  const float tail_mass = fmaxf(tail, kEm12);
  for (int b = 0; b < nb; ++b) {
    pc[b] = __fdiv_rn(alive[b] ? probs[b] : 0.0f, tail_mass);
    rem[b] = alive[b] ? __fsub_rn(mids[b], a) : 0.0f;
  }
  float rank = kNever;
  for (int j = 0; j < nb; ++j) {
    float e = 0.0f, pl = 0.0f;
    for (int b = 0; b < nb; ++b) {
      e = __fmaf_rn(fminf(rem[b], rem[j]), pc[b], e);
      pl = __fadd_rn(pl, rem[b] <= rem[j] ? pc[b] : 0.0f);
    }
    const float ratio = (pl > kEm12 && alive[j])
                            ? __fdiv_rn(e, fmaxf(pl, kEm12)) : kNever;
    rank = fminf(rank, ratio);
  }
  return exhausted ? att : rank;
}

__global__ void walk_fused_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int U = p.U, W = p.W, S = p.S, So = p.So, nb = p.nb;
  const bool with_ov = p.ov_samples != nullptr;
  const bool with_arr = p.arrstats != nullptr;
  const bool with_po = p.po_cum != nullptr;

  float* s_cum = reinterpret_cast<float*>(smem);       // U*(U+1)
  float* s_scale = s_cum + U * (U + 1);                  // U (posterior)
  float* s_neff = s_scale + (with_po ? U : 0);           // U
  int* s_useov = reinterpret_cast<int*>(s_neff + U);     // U
  float* s_ov = reinterpret_cast<float*>(s_useov + U);   // U*So
  float* s_arr = s_ov + (with_ov ? U * So : 0);          // U*W
  float* s_tot = s_arr + (with_arr ? U * W : 0);         // W
  int* s_hist = reinterpret_cast<int*>(s_tot + W);       // nb
  int* s_ahist = s_hist + nb;                            // U*nb
  float* s_red = reinterpret_cast<float*>(s_ahist + (with_arr ? U * nb : 0));
  float* s_rank = s_red + 64;                            // 6*nb (thread 0)

  const int g = p.graph_idx[a];
  const float* g_cum = with_po ? p.po_cum + static_cast<size_t>(a) * U * (U + 1)
                               : p.cum + static_cast<size_t>(g) * U * (U + 1);
  for (int i = tid; i < U * (U + 1); i += T) s_cum[i] = g_cum[i];
  if (with_po)
    for (int u = tid; u < U; u += T) s_scale[u] = p.po_scale[a * U + u];
  for (int u = tid; u < U; u += T) {
    float n = p.counts[g * U + u];
    int use = 0;
    if (with_ov) {
      const float oc = p.ov_counts[a * U + u];
      if (oc > 0.0f) {
        n = oc;
        use = 1;
      }
    }
    s_neff[u] = n;
    s_useov[u] = use;
  }
  if (with_ov) {
    const float* a_ov = p.ov_samples + static_cast<size_t>(a) * U * So;
    for (int i = tid; i < U * So; i += T) s_ov[i] = a_ov[i];
  }
  if (with_arr) {
    for (int i = tid; i < U * W; i += T) s_arr[i] = kNever;
    for (int i = tid; i < U * nb; i += T) s_ahist[i] = 0;
  }
  for (int i = tid; i < nb; i += T) s_hist[i] = 0;
  __syncthreads();

  // ---------------------------------------------------------------- walk
  const uint32_t stream = p.streams[a];
  const float ex = p.executed[a];
  const float att = p.attained[a];
  const bool valid = p.valid[a] != 0;
  SharedRows rows;
  rows.neff = s_neff;
  rows.useov = s_useov;
  rows.ov = s_ov;
  rows.samples = p.samples + static_cast<size_t>(g) * U * S;
  rows.cum = s_cum;
  rows.po_scale = s_scale;
  rows.S = S;
  rows.So = So;
  rows.U1 = U + 1;
  rows.posterior = with_po;
  for (int w = tid; w < W; w += T) {
    int cur = p.start[a];
    float total = 0.0f;
    bool done = !valid;
    for (int s = 0; s < p.max_steps && !done; ++s) {
      const int nxt = walk_step(rows, U, stream,
                                step_counter(s, W, static_cast<uint32_t>(w)),
                                s == 0, ex, cur, total);
      if (nxt >= U) {
        done = true;
      } else {
        if (with_arr) {
          float* slot = s_arr + nxt * W + w;
          *slot = fminf(*slot, total);
        }
        cur = nxt;
      }
    }
    if (p.rem != nullptr) p.rem[static_cast<size_t>(a) * W + w] = total;
    s_tot[w] = __fadd_rn(att, fmaxf(total, 0.0f));
  }
  __syncthreads();

  // ------------------------------------------- demand histogram and rank
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (int w = tid; w < W; w += T) {
    lo = fminf(lo, s_tot[w]);
    hi = fmaxf(hi, s_tot[w]);
  }
  block_minmax(lo, hi, s_red);
  if (hi <= lo) hi = __fadd_rn(lo, fmaxf(__fmul_rn(fabsf(lo), kEm3), kEm6));
  const float norm = __fdiv_rn(static_cast<float>(nb), __fsub_rn(hi, lo));
  for (int w = tid; w < W; w += T) {
    int idx = __float2int_rz(__fmul_rn(__fsub_rn(s_tot[w], lo), norm));
    idx = min(max(idx, 0), nb - 1);
    atomicAdd(&s_hist[idx], 1);
  }
  __syncthreads();
  if (tid == 0) {
    float* probs = s_rank;
    float* edges = s_rank + nb;
    const float span = __fsub_rn(hi, lo);
    for (int b = 0; b < nb; ++b) {
      probs[b] = __fmul_rn(static_cast<float>(s_hist[b]), p.inv_w);
      const float frac = __fmul_rn(static_cast<float>(b + 1), p.inv_nb);
      edges[b] = __fadd_rn(lo, fmaxf(__fmul_rn(span, frac), 0.0f));
    }
    edges[nb - 1] = hi;
    for (int b = 0; b < nb; ++b) {
      p.probs[a * nb + b] = probs[b];
      p.edges[a * nb + b] = edges[b];
    }
    p.ranks[a] = gittins_rank(probs, edges, att, nb, s_rank + 2 * nb);
  }

  // ------------------------------------------------ arrival histogram rows
  if (!with_arr) return;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  for (int u = warp; u < U; u += nwarps) {
    const float* col = s_arr + u * W;
    int cnt = 0;
    float ulo = kNever, uhi = -kNever;
    for (int w = lane; w < W; w += 32) {
      const float v = col[w];
      if (v < kHalfNever) {
        ++cnt;
        ulo = fminf(ulo, v);
        uhi = fmaxf(uhi, v);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
      ulo = fminf(ulo, __shfl_xor_sync(0xffffffffu, ulo, off));
      uhi = fmaxf(uhi, __shfl_xor_sync(0xffffffffu, uhi, off));
    }
    const float span = fmaxf(__fsub_rn(uhi, ulo), kEm6);
    const float scale = __fdiv_rn(static_cast<float>(nb), span);
    for (int w = lane; w < W; w += 32) {
      const float v = col[w];
      if (v < kHalfNever) {
        int idx = __float2int_rz(__fmul_rn(__fsub_rn(v, ulo), scale));
        idx = min(max(idx, 0), nb - 1);
        atomicAdd(&s_ahist[u * nb + idx], 1);
      }
    }
    __syncwarp();
    if (lane == 0) {
      float* row = p.arrstats + (static_cast<size_t>(a) * U + u) * (nb + 3);
      for (int b = 0; b < nb; ++b) row[b] = static_cast<float>(s_ahist[u * nb + b]);
      row[nb] = ulo;
      row[nb + 1] = span;
      row[nb + 2] = static_cast<float>(cnt);
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes (the wrapper checks it against the
// card's limit before launching).
size_t pdgraph_walk_fused_smem(int W, int U, int So, int nb, int with_ov,
                               int with_arr, int with_po) {
  size_t words = static_cast<size_t>(U) * (U + 1) + 2 * U + W + 7 * nb + 64;
  if (with_po) words += U;
  if (with_ov) words += static_cast<size_t>(U) * So;
  if (with_arr) words += static_cast<size_t>(U) * W + static_cast<size_t>(U) * nb;
  return words * 4;
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int pdgraph_walk_fused(const float* samples, const float* counts,
                       const float* cum, const float* ov_samples,
                       const float* ov_counts, const float* attained,
                       const int32_t* start, const int32_t* graph_idx,
                       const uint32_t* streams, const float* executed,
                       const uint8_t* valid, const float* po_cum,
                       const float* po_scale, float* probs, float* edges,
                       float* ranks, float* arrstats, float* rem, int A, int W,
                       int U, int S, int So, int max_steps, int nb,
                       int threads, float inv_w, float inv_nb, void* stream) {
  Args p{samples, counts, cum, ov_samples, ov_counts, attained, start,
         graph_idx, streams, executed, valid, po_cum, po_scale, probs, edges,
         ranks, arrstats, rem, A, W, U, S, So, max_steps, nb, inv_w, inv_nb};
  const size_t smem = pdgraph_walk_fused_smem(W, U, So, nb, ov_samples != nullptr,
                                              arrstats != nullptr,
                                              po_cum != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      walk_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_fused_kernel<<<A, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* pdgraph_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
