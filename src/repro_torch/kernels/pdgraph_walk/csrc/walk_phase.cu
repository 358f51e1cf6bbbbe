// Per-phase PDGraph walk kernel for Hopper (sm_90a): advances flat walker
// state (cur, total, done[, first-arrival times]) through global steps
// step0 .. step0 + n_steps of the counter-RNG walk.
//
// Replaces the TPU kernel pdgraph_walk_kernel
// (src/repro/kernels/pdgraph_walk/kernel.py).  The caller
// (repro_torch.kernels.pdgraph_walk.ops.pdgraph_walk) runs it once per
// compaction phase and packs the surviving walkers between phases.  The TPU
// version walks (1, BN) lane blocks and selects table rows with one-hot
// matrix products over app-aligned blocks; none of that is carried over:
//
//   * one thread per flat lane, the walker's state in registers; a thread
//     returns as soon as its walker is absorbed (exact: an absorbed walker
//     adds 0.0 and moves nowhere);
//   * table rows are read straight from global memory through the
//     read-only cache: the graph's rows by graph id, override and
//     posterior rows by app id;
//   * first-arrival times are a (U, N) array, so a warp's writes for one
//     unit fall on neighbouring addresses.
//
// The step body is walk_step.cuh, shared with the fused kernel.
//
// Bound on the card: latency.  Each walker-step is a dependent chain (hash
// -> sample gather -> CDF scan) of ~30 integer and float operations and two
// or three dependent loads; the bytes moved are the lane state, a few tens
// of bytes per walker.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "walk_step.cuh"

namespace {

using namespace pdgraph_walk;

// One walker's table rows, read from global memory.
struct GlobalRows {
  const float* counts;    // (U,)      the walker's graph
  const float* samples;   // (U, S)
  const float* cum;       // (U, U+1)  graph CDF or app posterior CDF
  const float* ov_counts; // (U,) of the app, or null
  const float* ov_samples;// (U, So) of the app
  const float* po_scale;  // (U,) of the app
  int S, So, U1;
  bool posterior;

  __device__ __forceinline__ float ov_count(int cur) const {
    return ov_counts != nullptr ? __ldg(ov_counts + cur) : 0.0f;
  }
  __device__ __forceinline__ float n_eff(int cur) const {
    const float oc = ov_count(cur);
    return oc > 0.0f ? oc : __ldg(counts + cur);
  }
  __device__ __forceinline__ float sample(int cur, int si) const {
    if (ov_count(cur) > 0.0f)
      return __ldg(ov_samples + static_cast<size_t>(cur) * So + min(si, So - 1));
    return __ldg(samples + static_cast<size_t>(cur) * S + si);
  }
  __device__ __forceinline__ float scale(int cur) const {
    return __ldg(po_scale + cur);
  }
  __device__ __forceinline__ const float* cdf(int cur) const {
    return cum + static_cast<size_t>(cur) * U1;
  }
};

struct Args {
  const float* samples;     // (G, U, S)
  const float* counts;      // (G, U)
  const float* cum;         // (G, U, U+1)
  const float* ov_samples;  // (A*U, So) or null
  const float* ov_counts;   // (A*U,) or null
  const float* po_cum;      // (A*U, U+1) or null
  const float* po_scale;    // (A*U,) or null
  const int32_t* cur;       // (N,)
  const float* total;       // (N,)
  const uint8_t* done;      // (N,) 0/1
  const int32_t* gi;        // (N,)
  const int32_t* app;       // (N,)
  const uint32_t* stream;   // (N,)
  const uint32_t* lane;     // (N,) original lane within the app
  const float* executed;    // (N,) or null
  const float* arr_in;      // (U, N) or null
  int32_t* cur_out;
  float* total_out;
  uint8_t* done_out;
  float* arr_out;           // (U, N) or null (may alias arr_in)
  int N, U, S, So, lanes_per_app, step0, n_steps;
};

__global__ void walk_phase_kernel(Args p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.N) return;
  const int U = p.U;
  const size_t N = static_cast<size_t>(p.N);
  const bool with_arr = p.arr_out != nullptr;
  if (with_arr && p.arr_out != p.arr_in)
    for (int u = 0; u < U; ++u) p.arr_out[u * N + i] = p.arr_in[u * N + i];

  int cur = p.cur[i];
  float total = p.total[i];
  bool done = p.done[i] != 0;
  if (!done && p.n_steps > 0) {
    const int g = p.gi[i];
    const int a = p.app[i];
    const bool with_ov = p.ov_counts != nullptr;
    const bool with_po = p.po_cum != nullptr;
    GlobalRows rows;
    rows.counts = p.counts + static_cast<size_t>(g) * U;
    rows.samples = p.samples + static_cast<size_t>(g) * U * p.S;
    rows.cum = with_po ? p.po_cum + static_cast<size_t>(a) * U * (U + 1)
                       : p.cum + static_cast<size_t>(g) * U * (U + 1);
    rows.ov_counts = with_ov ? p.ov_counts + static_cast<size_t>(a) * U : nullptr;
    rows.ov_samples = with_ov ? p.ov_samples + static_cast<size_t>(a) * U * p.So
                              : nullptr;
    rows.po_scale = with_po ? p.po_scale + static_cast<size_t>(a) * U : nullptr;
    rows.S = p.S;
    rows.So = p.So;
    rows.U1 = U + 1;
    rows.posterior = with_po;
    const uint32_t stream = p.stream[i];
    const uint32_t lane = p.lane[i];
    const float ex = p.executed != nullptr ? p.executed[i] : 0.0f;
    for (int k = 0; k < p.n_steps; ++k) {
      const int s = p.step0 + k;
      const int nxt = walk_step(rows, U, stream,
                                step_counter(s, p.lanes_per_app, lane),
                                s == 0 && p.executed != nullptr, ex, cur,
                                total);
      if (nxt >= U) {
        done = true;
        break;
      }
      if (with_arr) {
        float* slot = p.arr_out + static_cast<size_t>(nxt) * N + i;
        *slot = fminf(*slot, total);
      }
      cur = nxt;
    }
  }
  p.cur_out[i] = cur;
  p.total_out[i] = total;
  p.done_out[i] = done ? 1 : 0;
}

}  // namespace

extern "C" {

// Launches one walk phase on `stream`; returns cudaGetLastError()
// (0 = launched).
int pdgraph_walk_phase(const float* samples, const float* counts,
                       const float* cum, const float* ov_samples,
                       const float* ov_counts, const float* po_cum,
                       const float* po_scale, const int32_t* cur,
                       const float* total, const uint8_t* done,
                       const int32_t* gi, const int32_t* app,
                       const uint32_t* stream_ids, const uint32_t* lane,
                       const float* executed, const float* arr_in,
                       int32_t* cur_out, float* total_out, uint8_t* done_out,
                       float* arr_out, int N, int U, int S, int So,
                       int lanes_per_app, int step0, int n_steps,
                       int threads, void* stream) {
  Args p{samples, counts, cum, ov_samples, ov_counts, po_cum, po_scale,
         cur, total, done, gi, app, stream_ids, lane, executed, arr_in,
         cur_out, total_out, done_out, arr_out, N, U, S, So, lanes_per_app,
         step0, n_steps};
  const int blocks = (N + threads - 1) / threads;
  walk_phase_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* pdgraph_walk_phase_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
