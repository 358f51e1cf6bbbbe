"""The launch plans the kernel wrappers compute in Python, on the CPU: what
the CUDA sources take as given (a plan that covers the row, threads a
power of two, the block inside 1,024 threads, shared memory inside the
card's 227 KB a block).  The card tests hold the shared-memory sizes to the
built sources' (``tests/test_torch_cuda.py``)."""
import pytest
import torch

from repro_torch.kernels.rmsnorm import kernel as rms_kernel

RMS_D = [1, 7, 8, 33, 64, 100, 128, 129, 512, 1000, 2048, 4095, 4096, 5000,
         8192, 16384]


@pytest.mark.parametrize("D", RMS_D)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_plan_covers_the_row(D, dtype):
    es = torch.empty((), dtype=dtype).element_size()
    for aligned in (True, False):
        vec, nv, tpr, rpb, _ = rms_kernel.launch_plan(D, es, aligned)
        whole = aligned and D % (16 // es) == 0
        assert vec == (16 // es if whole else 1)
        assert D % vec == 0
        assert tpr & (tpr - 1) == 0 and 1 <= tpr <= rms_kernel.MAX_THREADS
        assert vec * nv * tpr >= D                       # covers the row
        if tpr > 1:                                      # and no wider
            assert vec * nv * (tpr // 2) < D
        assert rpb == max(1, rms_kernel.BLOCK_THREADS // tpr)
        assert tpr * rpb <= rms_kernel.MAX_THREADS
        # what the source instantiates
        assert nv in ((1, 2, 4) if vec > 1 else (1, 2, 4, 8, 16))


@pytest.mark.parametrize("rows", [1, 24, 132, 133, 264, 265, 4096, 131072])
def test_rmsnorm_plan_prefetches_scale_in_one_wave(rows):
    """``scale`` is read beside x when the grid has at most one block per
    multiprocessor (the kernel's time is then its latency)."""
    for D, aligned in ((128, True), (1024, True), (4096, True),
                       (16384, False)):
        plan = rms_kernel.launch_plan(D, 2, aligned, rows, sms=132)
        blocks = -(-rows // plan.rows_per_block)
        assert plan.prefetch == (blocks <= 132
                                 and plan.nv * plan.vec <= 16)


@pytest.mark.parametrize("D,dtype,tpr", [(4096, torch.bfloat16, 256),
                                         (2048, torch.bfloat16, 128),
                                         (1024, torch.bfloat16, 32),
                                         (128, torch.bfloat16, 16),
                                         (4096, torch.float32, 512)])
def test_rmsnorm_plan_sizes_threads_to_the_row(D, dtype, tpr):
    """Rows past a warp's 128 vectors: two 16-byte vectors a thread; up to
    128, one warp; D = 128 bf16: 16 lanes a row, so one warp holds two
    rows."""
    es = torch.empty((), dtype=dtype).element_size()
    plan = rms_kernel.launch_plan(D, es, True)
    assert plan.tpr == tpr and plan.vec * es == 16
    assert plan.nv * plan.vec <= 32


from repro_torch.kernels.pdgraph_walk import kernel as walk_kernel  # noqa: E402

WALK_W = [1, 31, 32, 33, 100, 128, 129, 256, 257, 512, 1024, 4096]


@pytest.mark.parametrize("W", WALK_W)
def test_walk_plan_sizes_the_block_to_the_walkers(W):
    """Past two blocks per multiprocessor, about two walkers a thread over
    32 to 128 threads; up to it, a walker a thread up to 256; the CDF scan
    unrolled over the smallest of UNITS_MAX that holds U."""
    for U in (1, 4, 5, 8, 9, 16, 17, 32):
        threads, umax = walk_kernel.walk_plan(W, U, 4096, sms=132)
        assert threads % 32 == 0 and 32 <= threads <= 128
        if 32 < threads < 128:
            assert 2 * threads >= W > threads
        assert umax in walk_kernel.UNITS_MAX and U <= umax
        assert umax == walk_kernel.UNITS_MAX[0] or umax // 2 < U
        for A in (1, 264):
            few = walk_kernel.walk_plan(W, U, A, sms=132)
            assert few.units_max == umax
            assert few.threads == min(-(-W // 32) * 32, 256)


@pytest.mark.parametrize("A,threads", [(1, 256), (2, 256), (264, 256),
                                       (265, 128), (4096, 128)])
def test_walk_plan_main_shapes(A, threads):
    """The main path's launches (one or two apps) take a block of 256
    threads; the 4,096-app cell one of 128."""
    assert walk_kernel.walk_plan(256, 4, A, sms=132) == (threads, 4)


def test_walk_plan_refuses_more_units_than_it_unrolls():
    with pytest.raises(ValueError, match="at most 32 units"):
        walk_kernel.walk_plan(256, 33)


# the per-phase walk (K2): lanes of its launches on the composed path (one
# app of 256 walkers, two, the largest of 32 apps, its compacted phases) and
# at 4,096 apps, before and after compaction
PHASE_N = [1, 31, 128, 256, 512, 2048, 8192, 67585, 262144, 1048576]


@pytest.mark.parametrize("N", PHASE_N)
def test_phase_plan_sizes_the_launch(N):
    """A lane a thread, blocks of up to 256 threads (a multiple of 32, the
    kernel's launch bound); the CDF scan unrolled over the smallest of
    UNITS_MAX that holds U."""
    for U in (1, 4, 5, 8, 9, 16, 17, 32):
        threads, umax = walk_kernel.phase_plan(N, U)
        assert threads % 32 == 0 and 32 <= threads <= 256
        assert threads == min(max(-(-N // 32) * 32, 32), 256)
        assert umax in walk_kernel.UNITS_MAX and U <= umax
        assert umax == walk_kernel.UNITS_MAX[0] or umax // 2 < U


@pytest.mark.parametrize("N,threads", [(256, 256), (128, 128), (512, 256),
                                       (1048576, 256), (5, 32)])
def test_phase_plan_main_shapes(N, threads):
    """The composed path's one-app launch is one block of 256 threads; its
    compacted 128-lane phase one of 128; U = 4 units unroll over 4."""
    assert walk_kernel.phase_plan(N, 4) == (threads, 4)


def test_phase_plan_refuses_more_units_than_it_unrolls():
    with pytest.raises(ValueError, match="at most 32 units"):
        walk_kernel.phase_plan(256, 33)


from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402

# (B, S, H, P, N, chunk): mamba2-1.3b's serve prompts, S = 2,048 and a
# ragged S = 300; Jamba's P = 128; the reference's test sweep
SSD_SHAPES = [(1, 24, 64, 64, 128, 128), (1, 8, 64, 64, 128, 128),
              (1, 2048, 64, 64, 128, 128), (1, 300, 64, 64, 128, 128),
              (1, 300, 8, 128, 128, 128), (1, 128, 2, 32, 16, 32),
              (2, 256, 4, 64, 32, 64), (1, 64, 8, 16, 8, 64),
              (1, 3, 2, 8, 8, 128), (2, 70, 5, 36, 20, 16)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plan_bf16_chunks_in_parallel(B, S, H, P, N, chunk):
    """bfloat16: every chunk of ``min(chunk, S)`` positions its own block
    per (batch, head, 64 state columns), inside the card's shared memory
    and two blocks a multiprocessor at mamba2's widths."""
    plan = ssd_kernel.scan_plan(torch.bfloat16, B, S, H, P, N, chunk)
    L = min(chunk, S)
    assert plan.chunk == L and plan.chunks == -(-S // L)
    assert plan.col_blocks == -(-P // 64)
    assert plan.blocks == plan.chunks * B * H * plan.col_blocks
    assert plan.smem == ssd_kernel.bf16_smem_bytes(L, N)
    assert plan.smem <= ssd_kernel.SMEM_MAX
    if N <= 128 and L <= 128:
        assert 2 * (plan.smem + 1024) <= 233472      # 228 KB an SM


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_plan_f32_walks_the_chunks(B, S, H, P, N, chunk):
    """float32: a block per (batch, head) over the chunks in order, at the
    largest chunk whose block fits (P = 128: 64)."""
    plan = ssd_kernel.scan_plan(torch.float32, B, S, H, P, N, chunk)
    assert plan.chunk == ssd_kernel.fitting_chunk(chunk, S, N, P)
    assert plan.chunk == (64 if P == 128 and min(chunk, S) > 64
                          else min(chunk, S))
    assert plan.blocks == B * H
    assert plan.smem == ssd_kernel.f32_smem_bytes(plan.chunk, N, P)
    assert plan.smem <= ssd_kernel.SMEM_MAX


@pytest.mark.parametrize("L,N,bf16,f32", [
    (128, 128, 108544, 221184),    # mamba2-1.3b (f32 at P = 64)
    (24, 128, 40960, 81408),       # its serve prompt (f32: 32 rows)
    (128, 16, 35072, 76032),       # the reference's test widths (P = 64)
])
def test_ssd_plan_shared_memory_sizes(L, N, bf16, f32):
    """The sizes the sources' layouts give at the main shapes."""
    assert ssd_kernel.bf16_smem_bytes(L, N) == bf16
    assert ssd_kernel.f32_smem_bytes(L, N, 64) == f32
