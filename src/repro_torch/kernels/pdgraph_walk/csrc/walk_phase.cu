// Per-phase PDGraph walk kernel for Hopper (sm_90a): advances flat walker
// state (cur, total, done[, first-arrival times]) through global steps
// step0 .. step0 + n_steps of the counter-RNG walk.
//
// Replaces the TPU kernel pdgraph_walk_kernel
// (src/repro/kernels/pdgraph_walk/kernel.py).  The caller
// (repro_torch.kernels.pdgraph_walk.ops.pdgraph_walk) runs it once per
// compaction phase and packs the surviving walkers between phases.  The TPU
// version walks (1, BN) lane blocks and selects table rows with one-hot
// matrix products over app-aligned blocks; none of that is carried over.
//
// Bound on the card.  At the composed path's launches (one app of 256
// walkers, 64 steps: one block) the time is latency: the longest walker's
// chain of steps, each a hash, a count read, a sample read and a CDF scan,
// whose next unit depends on the CDF row alone.  At thousands of apps it is
// the lane state, read and written once (a few tens of bytes a walker), and
// the steps' instruction issue.  What the design does about it:
//
//   * one thread per lane, its walker's state and first-arrival times in
//     registers (UMAX of them, the CDF scan unrolled over UMAX >= U, so the
//     U + 1 CDF entries are read at once): the times are read once from
//     arr_in and written once to arr_out, nothing in between;
//   * the tables are read through the read-only cache: an app's rows fit
//     L1, and staging them in shared memory was slower at every measured
//     shape (all rows, or the small ones alone; PERF.md §6), as was
//     walking several lanes a thread from a block counter.
//
// Bits: the step is the reference's, every float op with an explicit
// rounding intrinsic, built with -fmad=false.
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "walk_step.cuh"

namespace {

using namespace pdgraph_walk;

constexpr int kMaxThreads = 256;

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
  float* arr_out;           // (U, N) or null
  int N, U, S, So, lanes_per_app, step0, n_steps;
};

template <int UMAX>
__global__ void __launch_bounds__(kMaxThreads) walk_phase_kernel(Args p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.N) return;
  const int U = p.U, S = p.S, So = p.So, U1 = U + 1;
  const size_t N = static_cast<size_t>(p.N);
  const bool with_arr = p.arr_out != nullptr;
  int cur = p.cur[i];
  float total = p.total[i];
  bool done = p.done[i] != 0;
  float arr[UMAX];
#pragma unroll
  for (int u = 0; u < UMAX; ++u)
    arr[u] = with_arr && u < U ? p.arr_in[u * N + i] : kNever;
  if (!done && p.n_steps > 0) {
    const size_t g = static_cast<size_t>(p.gi[i]);
    const size_t a = static_cast<size_t>(p.app[i]);
    const bool with_ov = p.ov_counts != nullptr;
    const bool with_po = p.po_cum != nullptr;
    const bool with_ex = p.executed != nullptr && p.step0 == 0;
    const float* samples = p.samples + g * U * S;
    const float* counts = p.counts + g * U;
    const float* cdf = with_po ? p.po_cum + a * U * U1 : p.cum + g * U * U1;
    const float* ov_samples = with_ov ? p.ov_samples + a * U * So : nullptr;
    const float* ov_counts = with_ov ? p.ov_counts + a * U : nullptr;
    const float* scale = with_po ? p.po_scale + a * U : nullptr;
    const uint32_t stream = p.stream[i];
    const uint32_t ln = p.lane[i];
    const float ex = with_ex ? p.executed[i] : 0.0f;
    const int s_end = p.step0 + p.n_steps;
    int s = p.step0;
    uint32_t bits =
        fmix32(stream + step_counter(s, p.lanes_per_app, ln) * kGolden);
    while (true) {
      const float r = __fmul_rn(small_uint_to_float(bits >> 16), kU16);
      const float r2 = __fmul_rn(small_uint_to_float(bits & 0xFFFFu), kU16);
      const float oc = with_ov ? __ldg(ov_counts + cur) : 0.0f;
      const bool use_ov = oc > 0.0f;
      const float neff = use_ov ? oc : __ldg(counts + cur);
      const int si = floor_small(__fmul_rn(r, neff));
      float svc = use_ov ? __ldg(ov_samples + cur * So + min(si, So - 1))
                         : __ldg(samples + cur * S + si);
      if (with_po) svc = fmaxf(__fmul_rn(svc, __ldg(scale + cur)), 0.0f);
      if (with_ex && s == 0) svc = fmaxf(__fsub_rn(svc, ex), 0.0f);
      total = __fadd_rn(total, svc);
      const int nxt = cdf_next<UMAX>(cdf + cur * U1, U, r2);
      ++s;
      // the next step's draw, while this step's reads are in flight
      bits = fmix32(stream + step_counter(s, p.lanes_per_app, ln) * kGolden);
      if (nxt >= U) {
        done = true;
        break;
      }
#pragma unroll
      for (int u = 0; u < UMAX; ++u)
        if (u == nxt) arr[u] = fminf(arr[u], total);
      cur = nxt;
      if (s >= s_end) break;
    }
  }
  p.cur_out[i] = cur;
  p.total_out[i] = total;
  p.done_out[i] = done ? 1 : 0;
  if (with_arr) {
#pragma unroll
    for (int u = 0; u < UMAX; ++u)
      if (u < U) p.arr_out[u * N + i] = arr[u];
  }
}

template <int UMAX>
int launch(const Args& p, int threads, cudaStream_t stream) {
  walk_phase_kernel<UMAX>
      <<<(p.N + threads - 1) / threads, threads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches one walk phase on `stream`: a lane a thread, blocks of `threads`
// (a multiple of 32, at most 256), the CDF scan unrolled over `umax` (4, 8,
// 16 or 32, at least U); returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a plan the kernel does not take.
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
                       int threads, int umax, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || U < 1 ||
      U > umax)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{samples, counts, cum, ov_samples, ov_counts, po_cum, po_scale,
         cur, total, done, gi, app, stream_ids, lane, executed, arr_in,
         cur_out, total_out, done_out, arr_out, N, U, S, So, lanes_per_app,
         step0, n_steps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (umax) {
    case 4: return launch<4>(p, threads, s);
    case 8: return launch<8>(p, threads, s);
    case 16: return launch<16>(p, threads, s);
    case 32: return launch<32>(p, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* pdgraph_walk_phase_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
