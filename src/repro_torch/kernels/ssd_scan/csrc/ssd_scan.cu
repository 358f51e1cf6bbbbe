// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,   y_t = C_t h_t
//
// for x (B, S, H, P), dt (B, S, H) float32 > 0, A (H,) float32 < 0 and
// B / C (B, S, N) shared by every head (one group).  Writes y (B, S, H, P)
// in x's dtype (float32 or bfloat16) and the final state (B, H, N, P)
// float32, which the model's prefill hands to decode.
//
// Replaces the TPU kernel ssd_scan_kernel
// (src/repro/kernels/ssd_scan/kernel.py), whose grid (B, H, chunks) walks
// the chunks in order and keeps the (N, P) state in VMEM.  Blocks run in no
// order here, so the chunk axis is a loop inside one block per (batch,
// head), and the state stays in shared memory across it.  Per chunk of L
// positions (L = min(chunk, S); the last chunk may be shorter):
//
//   1. stage C (L, N), B transposed (N, L), x (L, P) as float32 and dt;
//      rows past the sequence's end are zeros, so they add nothing and the
//      state decays only over real positions (the reference's zero pad);
//      warp 0 takes the inclusive cumsum of dt * A with shuffles;
//   2. y = exp(cum) * (C . state), in registers (4 x 4 tiles per thread);
//   3. y += M . x over 32-column panels of M = (C . B^T) * exp(cum_l -
//      cum_s) * dt_s, s <= l (the panel is 16 KB where all of M would not
//      fit beside the rest at L = 128 in float32); y written;
//   4. state = exp(seg) * state + (B * exp(seg - cum) * dt)^T . x.
//
// Bound on the card.  The function needs, per (batch, chunk of
// L positions), L (L + 1) N FLOPs for the causal half of C . B^T (the same
// for every head), and per (batch, head, chunk) L (L + 1) P for its product
// with x and 4 L N P for the state's read and update; at mamba2-1.3b's
// widths (H 64, P 64, N 128, L 128) that is ~5.4 GFLOP against ~37 MB for
// S = 2,048 in bfloat16: 0.08 ms at the float32 rate (operations), 0.011 ms
// at the memory rate (bytes) beside 0.0055 ms on bfloat16 tensor cores.
// This first version recomputes
// C . B^T in every head's block and does the work as scalar float32 FMAs on
// 4 x 4 register tiles fed by 16-byte shared-memory loads, one block per
// (batch, head) (64 blocks at full width, batch 1);
// tensor cores (wgmma) and sharing the head-independent C . B^T panel
// across heads are what would move it toward the bound.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPanel = 32;          // columns of M per panel (step 3)
constexpr int kMaxChunk = 128;      // warp 0's scan: 4 positions per lane
constexpr int kMaxYTiles = 4;       // y tiles per thread: L * P / 16 / 256

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

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += sum_{k < K} A[i * lda + k] * B[k * ldb + j] for a 4 x 4
// tile; A and B in shared memory, 16-byte aligned rows, K a multiple of 4.
__device__ __forceinline__ void tile_mma(const float* __restrict__ A,
                                         int lda,
                                         const float* __restrict__ B,
                                         int ldb, int K, float (&acc)[4][4]) {
  for (int k = 0; k < K; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + i * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(B + (k + kk) * ldb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = comp(a[i], kk);
        acc[i][0] = fmaf(ai, b.x, acc[i][0]);
        acc[i][1] = fmaf(ai, b.y, acc[i][1]);
        acc[i][2] = fmaf(ai, b.z, acc[i][2]);
        acc[i][3] = fmaf(ai, b.w, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// Shared-memory layout in floats (every offset a multiple of 4).  LR: the
// chunk's rows rounded up to the panel width.
struct Layout {
  int ldc, ldbt, ldm;
  int cs, bt, xs, st, mt, cum, dts, ecum, wv, total;
  __host__ __device__ Layout(int LR, int N, int P) {
    ldc = N + 4;          // C rows; +4 staggers the banks of 4-row tiles
    ldbt = LR + 4;        // B^T rows
    ldm = kPanel + 4;     // M panel rows
    cs = 0;
    bt = cs + LR * ldc;
    xs = bt + N * ldbt;
    st = xs + LR * P;
    mt = st + N * P;
    cum = mt + LR * ldm;
    dts = cum + LR;
    ecum = dts + LR;
    wv = ecum + LR;
    total = wv + LR;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y,
                    float* __restrict__ final_state, int S, int H, int P,
                    int N, int L, int LR) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(LR, N, P);
  float* Cs = smem + lay.cs;
  float* BT = smem + lay.bt;
  float* xs = smem + lay.xs;
  float* St = smem + lay.st;
  float* Mt = smem + lay.mt;
  float* cum = smem + lay.cum;
  float* dts = smem + lay.dts;
  float* ecum = smem + lay.ecum;
  float* wv = smem + lay.wv;
  __shared__ float seg_s;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const float a = A[h];
  const int tilesP = P / 4;

  for (int i = tid; i < N * P; i += kThreads) St[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int Lc = min(L, S - t0);
    const int Lc4 = (Lc + 3) & ~3;
    __syncthreads();  // the previous chunk is done with every buffer

    // ---- 1. stage the chunk (zeros past the sequence's end) -------------
    for (int i = tid; i < LR * N; i += kThreads) {
      const int l = i / N;
      const int n = i - l * N;
      float cv = 0.0f, bv = 0.0f;
      if (l < Lc) {
        const long long g = (static_cast<long long>(b) * S + t0 + l) * N + n;
        cv = to_f32(Cm[g]);
        bv = to_f32(Bm[g]);
      }
      Cs[l * lay.ldc + n] = cv;
      BT[n * lay.ldbt + l] = bv;
    }
    for (int i = tid; i < LR * P; i += kThreads) {
      const int l = i / P;
      const int p = i - l * P;
      xs[i] = l < Lc ? to_f32(x[((static_cast<long long>(b) * S + t0 + l) * H
                                  + h) * P + p])
                     : 0.0f;
    }
    if (tid < 32) {
      // inclusive cumsum of dt * A: four positions per lane, then a warp
      // scan of the lane sums
      float d[4], c[4];
      float run = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = tid * 4 + j;
        d[j] = l < Lc ? dt[(static_cast<long long>(b) * S + t0 + l) * H + h]
                      : 0.0f;
        run += d[j] * a;
        c[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
      const float seg = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = tid * 4 + j;
        if (l < LR) {
          const float cl = excl + c[j];
          cum[l] = cl;
          dts[l] = d[j];
          ecum[l] = expf(cl);
          wv[l] = expf(seg - cl) * d[j];
        }
      }
      if (tid == 0) seg_s = seg;
    }
    __syncthreads();

    // ---- 2. y = exp(cum) * (C . state) ---------------------------------
    const int nY = (Lc4 / 4) * tilesP;
    float acc[kMaxYTiles][4][4];
#pragma unroll
    for (int j = 0; j < kMaxYTiles; ++j) {
      zero(acc[j]);
      const int t = tid + j * kThreads;
      if (t < nY) {
        const int tl = t / tilesP, tp = t - (t / tilesP) * tilesP;
        tile_mma(Cs + 4 * tl * lay.ldc, lay.ldc, St + 4 * tp, P, N, acc[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = ecum[4 * tl + i];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][i][q] *= e;
        }
      }
    }

    // ---- 3. y += M . x, one 32-column panel of M at a time --------------
    for (int s0 = 0; s0 < Lc; s0 += kPanel) {
      const int rows4 = (Lc4 - s0) / 4;           // rows l >= s0 only
      for (int t = tid; t < rows4 * (kPanel / 4); t += kThreads) {
        const int tl = s0 / 4 + t / (kPanel / 4);
        const int ts = t - (t / (kPanel / 4)) * (kPanel / 4);
        float m[4][4];
        zero(m);
        tile_mma(Cs + 4 * tl * lay.ldc, lay.ldc, BT + s0 + 4 * ts, lay.ldbt,
                 N, m);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = 4 * tl + i;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int s = s0 + 4 * ts + q;
            Mt[l * lay.ldm + 4 * ts + q] =
                s <= l ? m[i][q] * expf(cum[l] - cum[s]) * dts[s] : 0.0f;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMaxYTiles; ++j) {
        const int t = tid + j * kThreads;
        if (t < nY) {
          const int tl = t / tilesP, tp = t - (t / tilesP) * tilesP;
          if (4 * tl + 3 >= s0)
            tile_mma(Mt + 4 * tl * lay.ldm, lay.ldm, xs + s0 * P + 4 * tp, P,
                     kPanel, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kMaxYTiles; ++j) {
      const int t = tid + j * kThreads;
      if (t < nY) {
        const int tl = t / tilesP, tp = t - (t / tilesP) * tilesP;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = 4 * tl + i;
          if (l < Lc) {
            T* yr = y + ((static_cast<long long>(b) * S + t0 + l) * H + h) * P
                    + 4 * tp;
#pragma unroll
            for (int q = 0; q < 4; ++q) yr[q] = from_f32<T>(acc[j][i][q]);
          }
        }
      }
    }

    // ---- 4. state = exp(seg) * state + (B * w)^T . x --------------------
    for (int i = tid; i < N * Lc4; i += kThreads) {
      const int n = i / Lc4;
      const int l = i - n * Lc4;
      BT[n * lay.ldbt + l] *= wv[l];
    }
    __syncthreads();
    const float eseg = expf(seg_s);
    for (int t = tid; t < (N / 4) * tilesP; t += kThreads) {
      const int tn = t / tilesP, tp = t - (t / tilesP) * tilesP;
      float u[4][4];
      zero(u);
      tile_mma(BT + 4 * tn * lay.ldbt, lay.ldbt, xs + 4 * tp, P, Lc4, u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* sr = St + (4 * tn + i) * P + 4 * tp;
#pragma unroll
        for (int q = 0; q < 4; ++q) sr[q] = eseg * sr[q] + u[i][q];
      }
    }
  }
  __syncthreads();
  float* fs = final_state + static_cast<long long>(blockIdx.x) * N * P;
  for (int i = tid; i < N * P; i += kThreads) fs[i] = St[i];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* final_state, int Bsz, int S,
           int H, int P, int N, int L, cudaStream_t stream) {
  if (L < 1 || L > kMaxChunk || P % 4 || N % 4 || P < 4 || N < 4 ||
      (kMaxChunk / 4) * (P / 4) > kMaxYTiles * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int LR = (L + kPanel - 1) / kPanel * kPanel;
  const size_t bytes = sizeof(float) * Layout(LR, N, P).total;
  auto kern = ssd_scan_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<Bsz * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), final_state, S, H, P, N,
      L, LR);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block takes for chunk length L (<= 128).
long long ssd_scan_smem_bytes(int L, int N, int P) {
  const int LR = (L + kPanel - 1) / kPanel * kPanel;
  return static_cast<long long>(sizeof(float)) * Layout(LR, N, P).total;
}

// Launches the scan on `stream`: dtype 0 = float32, 1 = bfloat16 (x, Bm,
// Cm and y).  Returns cudaGetLastError() (0 = launched).
int ssd_scan_launch(const void* x, const float* dt, const float* A,
                    const void* Bm, const void* Cm, void* y,
                    float* final_state, int Bsz, int S, int H, int P, int N,
                    int L, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, final_state, Bsz, S, H, P, N,
                         L, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, final_state, Bsz, S,
                                 H, P, N, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
