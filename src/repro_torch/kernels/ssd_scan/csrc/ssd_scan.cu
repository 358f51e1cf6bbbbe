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
// the chunks in order and keeps the (N, P) state in VMEM.  Two forms:
//
// bfloat16: the state-passing form of SSD, chunks in parallel, products on
// the tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators).
// One block of 8 warps per (chunk, batch, head, 64 state columns); the
// blocks take their work from a ticket, chunk-major, so a block only ever
// waits for blocks that are already running.  Per chunk of L <= 128
// positions (rows past the sequence's end are zeros: the reference's pad):
//
//   1. stage C, B (L, N) and x (L, 64 columns) as bf16 by 16-byte cp.async
//      copies in the layout the products read (padded rows, so ldmatrix is
//      free of bank conflicts), dt; warp 0 takes the cumsum of dt * A;
//   2. the chunk's own end state, B^T . (w * x), w = exp(seg - cum) * dt:
//      w * x is split into bf16 hi + lo parts, so the state keeps ~16 bits
//      of mantissa (the float32 final state is held to 1e-4);
//   3. the chunk's in-state: the chunks form groups of 4; a block
//      publishes its own state at once, then folds the in-state of its
//      group (published by the group before's last block) through the own
//      states of its group's earlier chunks, as the sequential recurrence
//      would, bit for bit; a group's last block publishes the next
//      group's in-state (each publication a flag per (batch, head,
//      columns, chunk or group) set to this launch's epoch);
//   4. y = exp(cum) * (C . state_in) + M . x, M = (C . B^T) * exp(cum_l -
//      cum_s) * dt_s for s <= l, C . B^T computed 16 keys at a time and M
//      rounded to bf16 in registers as the next product's A operand; the
//      state operand is state_in rounded to bf16 (y is held to 5e-2).
//
// Only step 3 is ordered across chunks, and only from group to group:
// ceil(S / 4L) - 1 links, each a few float32 (N, 64) tiles through L2.
//
// float32: one block per (batch, head) walks the chunks in order, the (N, P)
// state in shared memory, the products as scalar float32 FMAs on 4 x 4
// register tiles (the 1e-4 tolerance admits no TF32 rounding).
//
// Bound on the card.  Per (batch, chunk of L positions) the function needs
// L (L + 1) N FLOPs for the causal half of C . B^T, and per (batch, head,
// chunk) L (L + 1) P for its product with x and 4 L N P for the state's
// read and update: at mamba2-1.3b's widths (H 64, P 64, N 128, L 128) and
// S = 2,048 that is ~5.4 GFLOP against ~37 MB in bfloat16, 0.011 ms at the
// memory rate (bytes) beside 0.0055 ms on the tensor cores, and 0.08 ms at
// the float32 rate.  The bf16 form recomputes C . B^T in every block (one
// head, 64 columns) and adds the lo half of step 2's operand: ~2x the
// FLOPs the function needs.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// float32: chunks in order, scalar

constexpr int kThreads = 256;
constexpr int kPanel = 32;          // columns of M per panel (step 3)
constexpr int kMaxChunk = 128;      // warp 0's scan: 4 positions per lane
constexpr int kMaxYTiles = 4;       // y tiles per thread: L * P / 16 / 256

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

__global__ void __launch_bounds__(kThreads)
    ssd_scan_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm, float* __restrict__ y,
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
        cv = Cm[g];
        bv = Bm[g];
      }
      Cs[l * lay.ldc + n] = cv;
      BT[n * lay.ldbt + l] = bv;
    }
    for (int i = tid; i < LR * P; i += kThreads) {
      const int l = i / P;
      const int p = i - l * P;
      xs[i] = l < Lc ? x[((static_cast<long long>(b) * S + t0 + l) * H + h) * P
                         + p]
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
            float* yr = y + ((static_cast<long long>(b) * S + t0 + l) * H + h)
                        * P + 4 * tp;
#pragma unroll
            for (int q = 0; q < 4; ++q) yr[q] = acc[j][i][q];
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

// ---------------------------------------------------------------------------
// bfloat16: chunk-parallel, on the tensor cores

constexpr int kTcWarps = 8;     // a 16-row strip each (4 ran slower)
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kCols = 64;           // state / y columns a block
constexpr int kMaxRows = 128;       // chunk rows and state rows: 8 strips
constexpr int kStrips = kMaxRows / 16 / kTcWarps;  // state strips a warp
constexpr int kXld = kCols + 8;     // x and state row stride (elements)
constexpr long long kMaxPolls = 1LL << 26;
constexpr int kGroup = 4;           // chunks whose hand-off one fold covers

typedef __nv_bfloat16 bf16;

// Byte offsets of a block's shared memory (one source for the kernel and
// for the size the launcher asks for).  LR: the chunk's rows and Np the
// state's, each rounded up to 16; C and B rows are Np + 8 elements and x
// and state rows kXld, so the 8 rows an ldmatrix reads fall on all 32
// banks.
struct TcLayout {
  int ldc, cs, bs, xs, sb, cum, dts, ecum, wv, total;
  __host__ __device__ TcLayout(int LR, int Np) {
    ldc = Np + 8;
    cs = 0;
    bs = cs + LR * ldc * 2;
    xs = bs + LR * ldc * 2;
    sb = xs + LR * kXld * 2;
    cum = sb + Np * kXld * 2;
    dts = cum + LR * 4;
    ecum = dts + LR * 4;
    wv = ecum + LR * 4;
    total = wv + LR * 4;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// A operand (16 x 16, row-major rows of `ld` elements at p)
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], const bf16* p,
                                       int ld, int lane) {
  const bf16* q = p + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                  ((lane >> 4) << 3);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(q)));
}
// A operand (16 x 16) read transposed: element (m, k) at p[k * ld + m]
__device__ __forceinline__ void ldsm_a_trans(uint32_t (&r)[4], const bf16* p,
                                             int ld, int lane) {
  const bf16* q = p + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                  (((lane >> 3) & 1) << 3);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(q)));
}
// B operands of two n8 tiles (16 x 8 each) stored as rows of the N dim with
// K contiguous: rows n0..n0+7 -> r[0..1], rows n0+8..n0+15 -> r[2..3]
__device__ __forceinline__ void ldsm_b2(uint32_t (&r)[4], const bf16* p,
                                        int ld, int lane) {
  const bf16* q = p + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                  (((lane >> 3) & 1) << 3);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(q)));
}
// B operand (16 x 8) stored row-major K x N: element (k, n) at p[k * ld + n]
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&r)[2], const bf16* p,
                                             int ld, int lane) {
  const bf16* q = p + (lane & 15) * ld;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(q)));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Visits a warp's state fragment: its 16-row strips (w, w + kTcWarps, ...)
// of the chunk state, each n8 tile of the block's columns, both row halves:
// f(strip index, tile, half, state row, column).
template <class F>
__device__ __forceinline__ void for_state(int warp, int Np, int PT, F&& f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kStrips; ++i) {
    const int strip = warp + i * kTcWarps;
    if (strip * 16 >= Np) break;
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      if (nt >= PT) break;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        f(i, nt, r, strip * 16 + g + 8 * r, nt * 8 + 2 * t);
    }
  }
}
// Makes the block's global writes visible, then sets `flag` to `epoch`.
__device__ __forceinline__ void publish(int* flag, int epoch, int tid) {
  __threadfence();
  __syncthreads();
  if (tid == 0) st_release(flag, epoch);
}
// Waits (one thread) until `flag` holds `epoch`; a broken hand-off faults
// instead of hanging the card.
__device__ __forceinline__ void wait_for(const int* flag, int epoch) {
  for (long long n = 0; ld_acquire(flag) != epoch; ++n) {
    if (n > kMaxPolls) __trap();
    __nanosleep(32);
  }
}

struct TcArgs {
  const bf16* x;              // (B, S, H, P)
  const float* dt;            // (B, S, H)
  const float* A;             // (H,)
  const bf16* Bm;             // (B, S, N)
  const bf16* Cm;             // (B, S, N)
  bf16* y;                    // (B, S, H, P)
  float* final_state;         // (B, H, N, P)
  // per (batch, head, column block): the chunks' own states (nc, N, kCols),
  // the groups' in-states (ng, N, kCols), then the chunks' seg (nc)
  float* scratch;
  int* flags;                 // (BHP, nc + ng): epoch once published
  unsigned long long* ticket; // blocks started on these buffers so far
  unsigned long long ticket_base;
  int epoch, Bsz, S, H, P, N, L, nc, PB, BHP;
};

__global__ void __launch_bounds__(kTcThreads, 2) ssd_scan_tc_kernel(TcArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_work;
  __shared__ float s_seg;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0)
    s_work = static_cast<int>(atomicAdd(p.ticket, 1ULL) - p.ticket_base);
  __syncthreads();
  // the work this block took: chunk-major, so every block of chunk c - 1
  // started before any of chunk c
  const int per_chunk = p.Bsz * p.H * p.PB;
  const int c = s_work / per_chunk;
  const int bhp = s_work - c * per_chunk;     // (b * H + h) * PB + pb
  const int bh = bhp / p.PB, pb = bhp - bh * p.PB;
  const int b = bh / p.H, h = bh - b * p.H;
  const int N = p.N, P = p.P, S = p.S, H = p.H;
  const int t0 = c * p.L;
  const int Lc = min(p.L, S - t0);
  const int LR = (Lc + 15) & ~15;
  const int Np = (N + 15) & ~15;
  const int p0 = pb * kCols;
  const int Pn = min(kCols, P - p0);          // this block's columns
  const int PT = (Pn + 7) >> 3;               // ... in n8 tiles
  const TcLayout lay(LR, Np);
  const int ldc = lay.ldc;
  bf16* Cs = reinterpret_cast<bf16*>(smem + lay.cs);
  bf16* Bs = reinterpret_cast<bf16*>(smem + lay.bs);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.xs);
  bf16* Sb = reinterpret_cast<bf16*>(smem + lay.sb);
  float* cum = reinterpret_cast<float*>(smem + lay.cum);
  float* dts = reinterpret_cast<float*>(smem + lay.dts);
  float* ecum = reinterpret_cast<float*>(smem + lay.ecum);
  float* wv = reinterpret_cast<float*>(smem + lay.wv);
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // ---- 1. stage C, B, x and dt (zeros past the sequence and the widths)
  const size_t row0 = static_cast<size_t>(b) * S + t0;
  if (N % 8 == 0) {
    const int per_row = Np / 8;
    for (int q = tid; q < LR * per_row; q += kTcThreads) {
      const int l = q / per_row, k = (q - l * per_row) * 8;
      bf16* dc = Cs + l * ldc + k;
      bf16* db = Bs + l * ldc + k;
      if (l < Lc && k < N) {
        const size_t src = (row0 + l) * N + k;
        cp_async16(dc, p.Cm + src);
        cp_async16(db, p.Bm + src);
      } else {
        *reinterpret_cast<uint4*>(dc) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(db) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int q = tid; q < LR * Np; q += kTcThreads) {
      const int l = q / Np, k = q - l * Np;
      const bool in = l < Lc && k < N;
      const size_t src = (row0 + l) * N + k;
      Cs[l * ldc + k] = in ? p.Cm[src] : zero;
      Bs[l * ldc + k] = in ? p.Bm[src] : zero;
    }
  }
  const bf16* xrow = p.x + (row0 * H + h) * P + p0;  // position l: + l*H*P
  if (P % 8 == 0) {
    const int per_row = PT;
    for (int q = tid; q < LR * per_row; q += kTcThreads) {
      const int l = q / per_row, k = (q - l * per_row) * 8;
      bf16* dx = xs + l * kXld + k;
      if (l < Lc)
        cp_async16(dx, xrow + static_cast<size_t>(l) * H * P + k);
      else
        *reinterpret_cast<uint4*>(dx) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int q = tid; q < LR * PT * 8; q += kTcThreads) {
      const int l = q / (PT * 8), k = q - l * (PT * 8);
      xs[l * kXld + k] = l < Lc && k < Pn
          ? xrow[static_cast<size_t>(l) * H * P + k] : zero;
    }
  }
  for (int l = tid; l < LR; l += kTcThreads)
    dts[l] = l < Lc ? p.dt[(row0 + l) * H + h] : 0.0f;
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) {
    // inclusive cumsum of dt * A: four positions per lane, then a warp scan
    // of the lane sums; rows past the chunk's end add 0
    const float a = p.A[h];
    float d[4], cs[4];
    float run = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = lane * 4 + j;
      d[j] = l < LR ? dts[l] : 0.0f;
      run = __fadd_rn(run, __fmul_rn(d[j], a));
      cs[j] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, u);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    const float seg = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = lane * 4 + j;
      if (l < LR) {
        const float cl = __fadd_rn(excl, cs[j]);
        cum[l] = cl;
        ecum[l] = expf(cl);
        wv[l] = __fmul_rn(expf(__fsub_rn(seg, cl)), d[j]);
      }
    }
    if (lane == 0) s_seg = seg;
  }
  __syncthreads();

  // ---- 2. the chunk's own end state: B^T . (w * x), w * x as hi + lo ---
  // warp w holds state rows [16 w, 16 w + 16), [16 (w + kTcWarps), ...)
  float st[kStrips][kCols / 8][4];
#pragma unroll
  for (int i = 0; i < kStrips; ++i)
#pragma unroll
    for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) st[i][j][q] = 0.0f;
  for (int kt = 0; kt < LR / 16; ++kt) {
    const int la = kt * 16 + 2 * t, lb = la + 8;
    const float w0 = wv[la], w1 = wv[la + 1], w2 = wv[lb], w3 = wv[lb + 1];
    uint32_t bhi[kCols / 8][2], blo[kCols / 8][2];
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      if (nt >= PT) break;
      const int col = nt * 8 + g;
      const float v0 = __fmul_rn(w0, __bfloat162float(xs[la * kXld + col]));
      const float v1 = __fmul_rn(w1, __bfloat162float(xs[(la + 1) * kXld + col]));
      const float v2 = __fmul_rn(w2, __bfloat162float(xs[lb * kXld + col]));
      const float v3 = __fmul_rn(w3, __bfloat162float(xs[(lb + 1) * kXld + col]));
      bhi[nt][0] = pack_bf16(v0, v1);
      bhi[nt][1] = pack_bf16(v2, v3);
      blo[nt][0] = pack_bf16(__fsub_rn(v0, bf16_round(v0)),
                             __fsub_rn(v1, bf16_round(v1)));
      blo[nt][1] = pack_bf16(__fsub_rn(v2, bf16_round(v2)),
                             __fsub_rn(v3, bf16_round(v3)));
    }
#pragma unroll
    for (int i = 0; i < kStrips; ++i) {
      const int strip = warp + i * kTcWarps;
      if (strip * 16 >= Np) break;
      uint32_t a[4];
      ldsm_a_trans(a, Bs + kt * 16 * ldc + strip * 16, ldc, lane);
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        if (nt >= PT) break;
        mma16816(st[i][nt], a, bhi[nt][0], bhi[nt][1]);
        mma16816(st[i][nt], a, blo[nt][0], blo[nt][1]);
      }
    }
  }

  // ---- 3. the hand-off: the chunk's in-state from its group's ---------
  // The chunks form groups of kGroup.  A block publishes its own state at
  // once (unless it ends its group or the sequence), folds the in-state of
  // its group (the last block of the group before publishes it) through
  // the own states of the chunks before it in its group, and, ending a
  // group, publishes the next group's in-state.  Each fold is the
  // recurrence state = exp(seg) state + own, in chunk order, so every
  // block gets the bits the sequential scan would.
  const size_t tile = static_cast<size_t>(N) * kCols;
  const int ng = (p.nc + kGroup - 1) / kGroup;
  float* own = p.scratch + static_cast<size_t>(bhp) * p.nc * tile;
  float* group_in = p.scratch + static_cast<size_t>(p.BHP) * p.nc * tile +
                    static_cast<size_t>(bhp) * ng * tile;
  float* segs = p.scratch + static_cast<size_t>(p.BHP) * (p.nc + ng) * tile +
                static_cast<size_t>(bhp) * p.nc;
  int* own_flag = p.flags + static_cast<size_t>(bhp) * (p.nc + ng);
  int* group_flag = own_flag + p.nc;
  const int g0 = c / kGroup, c0 = g0 * kGroup;
  const bool last = c == p.nc - 1;
  const bool ends_group = !last && c % kGroup == kGroup - 1;
  const float eseg = expf(s_seg);
  if (!last && !ends_group) {
    for_state(warp, Np, PT, [&](int i, int nt, int r, int n, int col) {
      if (n < N)
        __stcg(reinterpret_cast<float2*>(own + c * tile +
                                         static_cast<size_t>(n) * kCols +
                                         col),
               make_float2(st[i][nt][2 * r], st[i][nt][2 * r + 1]));
    });
    if (tid == 0) segs[c] = s_seg;
    publish(own_flag + c, p.epoch, tid);
  }
  if (tid == 0) {
    if (g0 > 0) wait_for(group_flag + g0, p.epoch);
    for (int k = c0; k < c; ++k) wait_for(own_flag + k, p.epoch);
  }
  __syncthreads();
  float sin[kStrips][kCols / 8][4];
  for_state(warp, Np, PT, [&](int i, int nt, int r, int n, int col) {
    float2 v = make_float2(0.0f, 0.0f);
    if (n < N && g0 > 0)
      v = __ldcg(reinterpret_cast<const float2*>(
          group_in + g0 * tile + static_cast<size_t>(n) * kCols + col));
    sin[i][nt][2 * r] = v.x;
    sin[i][nt][2 * r + 1] = v.y;
  });
  for (int k = c0; k < c; ++k) {
    const float e = expf(__ldcg(segs + k));
    const float* src = own + k * tile;
    for_state(warp, Np, PT, [&](int i, int nt, int r, int n, int col) {
      float2 v = make_float2(0.0f, 0.0f);
      if (n < N)
        v = __ldcg(reinterpret_cast<const float2*>(
            src + static_cast<size_t>(n) * kCols + col));
      sin[i][nt][2 * r] = __fadd_rn(__fmul_rn(e, sin[i][nt][2 * r]), v.x);
      sin[i][nt][2 * r + 1] =
          __fadd_rn(__fmul_rn(e, sin[i][nt][2 * r + 1]), v.y);
    });
  }
  // the out-state: the final state, or the next group's in-state
  for_state(warp, Np, PT, [&](int i, int nt, int r, int n, int col) {
    const float2 in = make_float2(sin[i][nt][2 * r], sin[i][nt][2 * r + 1]);
    if (n < N && (last || ends_group)) {
      const float2 out = make_float2(
          __fadd_rn(__fmul_rn(eseg, in.x), st[i][nt][2 * r]),
          __fadd_rn(__fmul_rn(eseg, in.y), st[i][nt][2 * r + 1]));
      if (last) {
        if (col < Pn)
          *reinterpret_cast<float2*>(
              p.final_state + (static_cast<size_t>(bh) * N + n) * P + p0 +
              col) = out;
      } else {
        __stcg(reinterpret_cast<float2*>(group_in + (g0 + 1) * tile +
                                         static_cast<size_t>(n) * kCols +
                                         col),
               out);
      }
    }
    *reinterpret_cast<uint32_t*>(Sb + n * kXld + col) = pack_bf16(in.x, in.y);
  });
  if (ends_group)
    publish(group_flag + g0 + 1, p.epoch, tid);
  else
    __syncthreads();

  // ---- 4. y = exp(cum) (C . state_in) + M . x ---------------------------
  // row strips of 16: warp w takes strips w and (ns - 1 - w) when that is
  // past the first kTcWarps, which evens out the causal triangle's work
  const int ns = LR / 16;
#pragma unroll 1
  for (int q = 0; q < 2; ++q) {
    const int strip = q == 0 ? warp : ns - 1 - warp;
    if (q == 1 && strip < kTcWarps) break;
    if (strip >= ns) continue;
    const int r0 = strip * 16;
    float acc[kCols / 8][4];
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[nt][k] = 0.0f;
    uint32_t ca[kMaxRows / 16][4];
#pragma unroll
    for (int kt = 0; kt < kMaxRows / 16; ++kt) {
      if (kt * 16 >= Np) break;
      ldsm_a(ca[kt], Cs + r0 * ldc + kt * 16, ldc, lane);
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        if (nt >= PT) break;
        uint32_t bb[2];
        ldsm_b_trans(bb, Sb + kt * 16 * kXld + nt * 8, kXld, lane);
        mma16816(acc[nt], ca[kt], bb[0], bb[1]);
      }
    }
    const int la = r0 + g, lb = la + 8;
    const float ea = ecum[la], eb = ecum[lb];
    const float cla = cum[la], clb = cum[lb];
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      acc[nt][0] = __fmul_rn(acc[nt][0], ea);
      acc[nt][1] = __fmul_rn(acc[nt][1], ea);
      acc[nt][2] = __fmul_rn(acc[nt][2], eb);
      acc[nt][3] = __fmul_rn(acc[nt][3], eb);
    }
    for (int kk = 0; kk <= strip; ++kk) {
      // C . B^T for keys [16 kk, 16 kk + 16): two n8 tiles
      float cb[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kt = 0; kt < kMaxRows / 16; ++kt) {
        if (kt * 16 >= Np) break;
        uint32_t bb[4];
        ldsm_b2(bb, Bs + kk * 16 * ldc + kt * 16, ldc, lane);
        mma16816(cb[0], ca[kt], bb[0], bb[1]);
        mma16816(cb[1], ca[kt], bb[2], bb[3]);
      }
      // M = (C . B^T) exp(cum_l - cum_s) dt_s for s <= l, as the A operand
      // of keys [16 kk, 16 kk + 16) (an accumulator pair's layout is an A
      // fragment's)
      float mv[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s0 = kk * 16 + 8 * j + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + (e & 1);
          const int l = e < 2 ? la : lb;
          const float cl = e < 2 ? cla : clb;
          mv[j][e] = s <= l
              ? __fmul_rn(__fmul_rn(cb[j][e], expf(__fsub_rn(cl, cum[s]))),
                          dts[s])
              : 0.0f;
        }
      }
      uint32_t m[4];
      m[0] = pack_bf16(mv[0][0], mv[0][1]);
      m[1] = pack_bf16(mv[0][2], mv[0][3]);
      m[2] = pack_bf16(mv[1][0], mv[1][1]);
      m[3] = pack_bf16(mv[1][2], mv[1][3]);
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        if (nt >= PT) break;
        uint32_t bb[2];
        ldsm_b_trans(bb, xs + kk * 16 * kXld + nt * 8, kXld, lane);
        mma16816(acc[nt], m, bb[0], bb[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (nt >= PT || col >= Pn) break;
      if (la < Lc)
        *reinterpret_cast<uint32_t*>(
            p.y + ((row0 + la) * H + h) * P + p0 + col) =
            pack_bf16(acc[nt][0], acc[nt][1]);
      if (lb < Lc)
        *reinterpret_cast<uint32_t*>(
            p.y + ((row0 + lb) * H + h) * P + p0 + col) =
            pack_bf16(acc[nt][2], acc[nt][3]);
    }
  }
}

int launch_f32(const float* x, const float* dt, const float* A,
               const float* Bm, const float* Cm, float* y,
               float* final_state, int Bsz, int S, int H, int P, int N,
               int L, cudaStream_t stream) {
  if (L < 1 || L > kMaxChunk || P % 4 || N % 4 || P < 4 || N < 4 ||
      (kMaxChunk / 4) * (P / 4) > kMaxYTiles * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int LR = (L + kPanel - 1) / kPanel * kPanel;
  const size_t bytes = sizeof(float) * Layout(LR, N, P).total;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_scan_f32_kernel<<<Bsz * H, kThreads, bytes, stream>>>(
      x, dt, A, Bm, Cm, y, final_state, S, H, P, N, L, LR);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of the float32 kernel takes for chunk
// length L (<= 128).
long long ssd_scan_smem_bytes(int L, int N, int P) {
  const int LR = (L + kPanel - 1) / kPanel * kPanel;
  return static_cast<long long>(sizeof(float)) * Layout(LR, N, P).total;
}

// Shared memory (bytes) one block of the bfloat16 kernel takes for chunk
// length L (<= 128) and N (<= 128) state rows.
long long ssd_scan_bf16_smem_bytes(int L, int N) {
  return TcLayout((L + 15) & ~15, (N + 15) & ~15).total;
}

// Launches the float32 scan on `stream`.  Returns cudaGetLastError() (0 =
// launched).
int ssd_scan_f32(const float* x, const float* dt, const float* A,
                 const float* Bm, const float* Cm, float* y,
                 float* final_state, int Bsz, int S, int H, int P, int N,
                 int L, void* stream) {
  return launch_f32(x, dt, A, Bm, Cm, y, final_state, Bsz, S, H, P, N, L,
                    static_cast<cudaStream_t>(stream));
}

// Launches the bfloat16 scan on `stream`: nc = ceil(S / L) chunks times
// BHP = Bsz * H * ceil(P / 64) blocks.  With more than one chunk,
// `scratch` holds BHP * ((nc + ng) * N * 64 + nc) floats, ng = ceil(nc /
// 4), and `flags` BHP * (nc + ng) ints, none equal to `epoch`, which the
// caller makes new for every launch on these buffers; `*ticket` counts the
// blocks started on them, `ticket_base` its value when this launch
// starts.  Returns cudaGetLastError() (0 = launched).
int ssd_scan_bf16(const void* x, const float* dt, const float* A,
                  const void* Bm, const void* Cm, void* y, float* final_state,
                  float* scratch, int* flags, unsigned long long* ticket,
                  unsigned long long ticket_base, int epoch, int Bsz, int S,
                  int H, int P, int N, int L, void* stream) {
  if (L < 1 || L > kMaxRows || N < 1 || N > kMaxRows || P < 4 || P % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  const int PB = (P + kCols - 1) / kCols;
  const int bytes = static_cast<int>(ssd_scan_bf16_smem_bytes(L, N));
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  TcArgs a{static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
           static_cast<const bf16*>(Cm), static_cast<bf16*>(y), final_state,
           scratch, flags, ticket, ticket_base, epoch, Bsz, S, H, P, N, L, nc,
           PB, Bsz * H * PB};
  ssd_scan_tc_kernel<<<nc * Bsz * H * PB, kTcThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
