// Grouped expert matmul kernels for Hopper (sm_90a): out[e] = x[e] @ w[e]
// for x (E, C, D) capacity-packed tokens and w (E, D, N) expert weights,
// float32 or bfloat16, accumulated in float32 and written in x's dtype.
// x may have any expert and row strides (D contiguous; an expert stride of
// 0 repeats one token buffer across the experts); w and out are
// contiguous.  D and N are multiples of 8.  moe_gmm_launch dispatches by
// dtype.
//
// Replaces the TPU kernel moe_gmm_kernel (src/repro/kernels/moe_gmm/
// kernel.py), whose grid (E, C/bc, N/bn, D/bd) carries an f32 VMEM
// accumulator across the contraction axis.  Blocks on this card run in no
// order, so the contraction is a loop inside the block instead.
//
// Bound on the card: bytes at the model's token counts.  Each weight
// element is used C times (C = 1 when decoding, 8 in a short prefill, 160
// for Qwen1.5-MoE's 2,048-token prompt: 59 GFLOP against 440 MB), so
// every weight tile must be read once for all C rows and the reads must
// keep the memory busy.
//
// bfloat16: the tensor-core kernel (moe_gmm_tc).  The product is computed
// transposed, out[e]^T (N x C) = w[e]^T (N x D) x[e]^T (D x C), so the
// weights are the 64-row wgmma A operand and the tokens the B operand,
// whose width is C rounded up to NT (8 to 256; panels of 256 rows past
// that): a decode step multiplies 8 token columns, not 64 padded rows.
//
//   * one block per (expert, 128 output columns, NT-row panel): two
//     consumer warpgroups own 64 columns each and run wgmma.mma_async
//     m64nNTk16 (bf16, f32 accumulators), A = the (64 d x 64 n) weight box
//     read MN-major from shared memory (the transpose bit: n is w's
//     contiguous axis), B = the (NT x 64 d) token box, K-major;
//   * one producer warp streams both by TMA (tensor maps built on the
//     host, 128-byte swizzle, passed as __grid_constant__) into a ring of
//     four stages with full / empty mbarriers: 16 KB of weights and NT x
//     128 B of tokens a stage, three stages in flight while one is
//     multiplied.  TMA fills rows past C, contraction rows past D and
//     columns past N with zeros, so the edges need no masks; a token
//     buffer with an expert stride of 0 is read through a map with one
//     expert;
//   * the epilogue stages the transposed (NT x 128) tile in shared memory
//     (rows padded to 272 bytes: no bank conflicts) and writes rows c < C
//     of the output with 16-byte stores, columns n < N.
//
// float32: the scalar kernel (moe_gmm_kernel), kept for the float32 models,
// whose card-against-CPU checks hold logits to 1e-4 (TF32 tensor cores
// would not): one block of 256 threads per (expert, 64 output columns, BC
// token rows), BC = 1, 2, 4 or 8 after C; a thread owns 8 consecutive
// columns and one of 32 contraction lanes, issues its 8 weight loads of a
// 256-row stage before any is used, BC x 8 float32 accumulators, explicit
// fmaf (the build passes -fmad=false), warp-shuffle and shared-memory
// reduction; tails masked on every axis.  It re-reads each weight tile
// once per BC rows: correct, slow for long prefills.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 8;                  // columns per thread
constexpr int BN = 64;                   // columns per block
constexpr int GROUPS = BN / COLS;        // 8 column groups
constexpr int LANES = THREADS / GROUPS;  // 32 contraction lanes
constexpr int DCH = 256;                 // contraction rows per stage
constexpr int DPT = DCH / LANES;         // 8 rows per thread per stage

// 8 consecutive floats held as two 16-byte words, so that a thread can
// issue its loads before it uses any of them.  The address is 16-byte
// aligned (the wrapper checks pointers and strides).
struct Pack8 {
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

template <int BC>
__global__ void __launch_bounds__(THREADS)
moe_gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int C, int D, int N, long long sxe,
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
  const float* xe = x + e * sxe;
  const float* we = w + static_cast<long long>(e) * D * N + n;

  float acc[BC][COLS];
#pragma unroll
  for (int c = 0; c < BC; ++c)
#pragma unroll
    for (int i = 0; i < COLS; ++i) acc[c][i] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += DCH) {
    // this stage's weight rows: every load issued before any is used
    Pack8 wp[DPT];
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
        Pack8 p;
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
    out[(static_cast<long long>(e) * C + c0 + c) * N + n0 + col] = s;
  }
}

template <int BC>
int launch_bc(const void* x, const void* w, void* out, int E, int C, int D,
              int N, long long sxe, long long sxc, cudaStream_t stream) {
  const int n_tiles = (N + BN - 1) / BN;
  const long long blocks_x =
      static_cast<long long>(n_tiles) * ((C + BC - 1) / BC);
  if (blocks_x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_x), E);
  moe_gmm_kernel<BC><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), C, D, N, sxe, sxc, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* x, const void* w, void* out, int E, int C, int D,
               int N, long long sxe, long long sxc, cudaStream_t s) {
  if (C == 1) return launch_bc<1>(x, w, out, E, C, D, N, sxe, sxc, s);
  if (C == 2) return launch_bc<2>(x, w, out, E, C, D, N, sxe, sxc, s);
  if (C <= 4) return launch_bc<4>(x, w, out, E, C, D, N, sxe, sxc, s);
  return launch_bc<8>(x, w, out, E, C, D, N, sxe, sxc, s);
}

// --------------------------------------------------------------------------
// The bfloat16 tensor-core kernel.

namespace tc {

constexpr int BN = 128;           // output columns a block: two warpgroups
constexpr int BK = 64;            // contraction rows a stage (128 B rows)
constexpr int STAGES = 4;
constexpr int THREADS = 288;      // two consumer warpgroups + a producer warp
constexpr int PRODUCER_WARP = 8;
constexpr int MAX_NT = 256;       // token rows a panel (wgmma's widest n)
constexpr int W_HALF = BK * 64 * 2;     // one (64 d x 64 n) weight box
constexpr int W_BYTES = 2 * W_HALF;
constexpr int OUT_LD = BN * 2 + 16;     // staged output row, bytes

template <int NT>
struct Shape {
  static constexpr int X_BYTES = NT * BK * 2;       // one (NT x 64 d) box
  static constexpr int STAGE = W_BYTES + X_BYTES;   // a multiple of 1024
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(NT * OUT_LD <= BAR_OFF, "the output tile reuses the ring");
};

struct TcArgs {
  __nv_bfloat16* out;
  int C, D, N, n_panels, x_rep;   // x_rep: x's expert stride is 0
};

// A box of a 3-d tensor map at (c0, c1, c2) into shared memory, completing
// on `bar`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// D (64 x NT, f32) += A (64 x 16, shared, MN-major bf16: the transpose
// bit) * B (16 x NT, shared, K-major bf16)
template <int NT>
__device__ __forceinline__ void wgmma_tn(float (&d)[NT / 2], uint64_t a,
                                         uint64_t b);
template <> __device__ __forceinline__ void wgmma_tn<8>(
    float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<16>(
    float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<24>(
    float (&d)[12], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<32>(
    float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<48>(
    float (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<64>(
    float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<96>(
    float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<128>(
    float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<160>(
    float (&d)[80], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<192>(
    float (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<224>(
    float (&d)[112], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, %112, %113, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(a), "l"(b), "r"(1));
}
template <> __device__ __forceinline__ void wgmma_tn<256>(
    float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
moe_gmm_tc(const __grid_constant__ CUtensorMap wmap,
           const __grid_constant__ CUtensorMap xmap, const TcArgs a) {
  using S = Shape<NT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms align
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + S::BAR_OFF;        // full[STAGES], empty[..]

  const int e = blockIdx.y;
  const int c0 = (blockIdx.x % a.n_panels) * NT;
  const int n0 = (blockIdx.x / a.n_panels) * BN;
  const bool half1 = n0 + 64 < a.N;               // columns for warpgroup 1
  const int k_tiles = (a.D + BK - 1) / BK;
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
      const int xe = a.x_rep ? 0 : e;
      const uint32_t bytes = (half1 ? W_BYTES : W_HALF) + S::X_BYTES;
      for (int t = 0; t < k_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES)
          mbar_wait(bars + 8 * (STAGES + s), ((t / STAGES) - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t st = base + s * S::STAGE;
        mbar_expect_tx(full, bytes);
        tma_load3(st, &wmap, full, n0, t * BK, e);
        if (half1) tma_load3(st + W_HALF, &wmap, full, n0 + 64, t * BK, e);
        tma_load3(st + W_BYTES, &xmap, full, t * BK, c0, xe);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const bool active = wg == 0 || half1;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  for (int t = 0; t < k_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t st = base + s * S::STAGE;
    mbar_wait(bars + 8 * s, (t / STAGES) & 1);
    if (active) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: 16 weight rows (d) of 128 B, 64 columns (n) each; B: NT token
        // rows of 128 B, 16 contraction elements 32 B in
        const uint64_t da = make_desc(st + wg * W_HALF + kk * 16 * 128,
                                      W_HALF, 8 * 128, 1);
        const uint64_t db = make_desc(st + W_BYTES + kk * 32, 16, 8 * 128, 1);
        wgmma_tn<NT>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait_all();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));   // stage free
  }

  // every consumer is done with the ring: stage the (NT x 128) tile there.
  // Element 4j + 2i + h is column n0 + nl + 8i, row c0 + 8j + 2 quad + h.
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int quad = lane & 3;
  const int nl = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat16*>(
            smem + (8 * j + 2 * quad + h) * OUT_LD + (nl + 8 * i) * 2) =
            __float2bfloat16(acc[4 * j + 2 * i + h]);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int rows = min(NT, a.C - c0);
  for (int q = threadIdx.x; q < rows * (BN / 8); q += 256) {
    const int c = q / (BN / 8), u = q % (BN / 8), n = n0 + 8 * u;
    if (n < a.N)
      *reinterpret_cast<uint4*>(
          a.out + (static_cast<long long>(e) * a.C + c0 + c) * a.N + n) =
          *reinterpret_cast<const uint4*>(smem + c * OUT_LD + 16 * u);
  }
}

// A 3-d bf16 tensor map (dims innermost first, byte strides of dims 1
// and 2) read in (box0 x box1 x 1) boxes under the 128-byte swizzle; a
// dimension of extent 1 gets a stride the encoder accepts (never used)
int encode3(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[3],
            long long s1, long long s2, int box0, int box1) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long fill = static_cast<long long>(dims[0]) * 2;
  cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(dims[1] > 1 ? s1 : fill),
      static_cast<cuuint64_t>(dims[2] > 1 ? s2 : fill)};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(box0),
                       static_cast<cuuint32_t>(box1), 1u};
  cuuint32_t elem[3] = {1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NT>
int launch_nt(const void* x, const void* w, void* out, int E, int C, int D,
              int N, long long sxe, long long sxc, cudaStream_t stream) {
  using Sh = Shape<NT>;
  const int x_rep = sxe == 0;
  CUtensorMap wmap, xmap;
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(E)};
  const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(x_rep ? 1 : E)};
  int rc = encode3(&wmap, w, wdims, 2LL * N, 2LL * D * N, 64, BK);
  if (rc == 0) rc = encode3(&xmap, x, xdims, 2 * sxc, 2 * sxe, BK, NT);
  if (rc != 0) return rc;
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_tc<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Sh::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int n_panels = (C + NT - 1) / NT;
  const long long blocks_x =
      static_cast<long long>((N + BN - 1) / BN) * n_panels;
  if (blocks_x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const TcArgs a{static_cast<__nv_bfloat16*>(out), C, D, N, n_panels, x_rep};
  moe_gmm_tc<NT><<<dim3(static_cast<unsigned>(blocks_x), E), THREADS,
                   Sh::SMEM, stream>>>(wmap, xmap, a);
  return static_cast<int>(cudaGetLastError());
}

// The narrowest instantiated panel width that holds C rows (C > 256 runs
// panels of 256)
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int N, long long sxe, long long sxc, cudaStream_t s) {
#define GMM_NT(NT) \
  if (C <= NT) return launch_nt<NT>(x, w, out, E, C, D, N, sxe, sxc, s)
  GMM_NT(8); GMM_NT(16); GMM_NT(24); GMM_NT(32); GMM_NT(48); GMM_NT(64);
  GMM_NT(96); GMM_NT(128); GMM_NT(160); GMM_NT(192); GMM_NT(224);
#undef GMM_NT
  return launch_nt<MAX_NT>(x, w, out, E, C, D, N, sxe, sxc, s);
}

}  // namespace tc

}  // namespace

extern "C" {

// Launches the grouped matmul on `stream`: dtype 0 = float32 (the scalar
// kernel), 1 = bfloat16 (the tensor-core kernel); x strides in elements.
// Returns a cudaError_t code (0 = launched).
int moe_gmm_launch(const void* x, const void* w, void* out, int E, int C,
                   int D, int N, long long sxe, long long sxc, int dtype,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || D <= 0 || N <= 0 || D % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_f32(x, w, out, E, C, D, N, sxe, sxc, s);
  if (dtype == 1) return tc::launch(x, w, out, E, C, D, N, sxe, sxc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
