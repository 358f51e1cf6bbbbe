"""Binding of the SSD chunk-scan kernel (``csrc/ssd_scan.cu``), which
replaces the TPU kernel ``ssd_scan_kernel`` of
``repro.kernels.ssd_scan.kernel``.

The wrapper checks its operands, allocates y and the final state, launches
the kernel on the current stream and raises if the launch is refused.
bfloat16 inputs take the chunk-parallel tensor-core form, float32 inputs
the chunk-sequential scalar form; :func:`scan_plan` says how either is cut
into blocks.  CUDA tensors only: the plain versions are in ``ref``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.binding import (check_operand, on_device,
                                         raise_on_error, stream_of)

NAME = "ssd_scan"
SOURCE = Path(__file__).parent / "csrc" / "ssd_scan.cu"
CHUNK_MAX = 128                 # a chunk is at most 8 strips of 16 rows
P_MAX = 128                     # float32: y tiles a thread holds in registers
N_MAX_BF16 = 128                # bfloat16: state rows, 8 strips of 16
BF16_COLS = 64                  # bfloat16: state columns a block
BF16_GROUP = 4                  # bfloat16: chunks a hand-off fold covers
SMEM_MAX = 232448               # bytes of shared memory a block can use
LAUNCHES.setdefault(NAME, 0)


class ScanPlan(NamedTuple):
    chunk: int          # positions a chunk (the last may be shorter)
    chunks: int
    col_blocks: int     # blocks of state columns per head
    blocks: int
    smem: int           # bytes of shared memory a block takes


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def f32_smem_bytes(L: int, N: int, P: int) -> int:
    """Shared memory of one float32 block at chunk length L: the source's
    ``Layout`` (C rows, B^T rows, x, the state, a 32-column panel of M and
    four per-position vectors, rows rounded up to the panel)."""
    LR = _up(L, 32)
    return 4 * (LR * (N + 4) + N * (LR + 4) + LR * P + N * P + LR * 36
                + 4 * LR)


def bf16_smem_bytes(L: int, N: int) -> int:
    """Shared memory of one bfloat16 block at chunk length L: the source's
    ``TcLayout`` (C and B rows of N + 8, x and the state's bf16 copy in rows
    of 72, four per-position vectors; rows and N rounded up to 16)."""
    LR, Np = _up(L, 16), _up(N, 16)
    return 2 * 2 * LR * (Np + 8) + 2 * 72 * (LR + Np) + 4 * 4 * LR


def fitting_chunk(chunk: int, S: int, N: int, P: int) -> int:
    """float32: ``min(chunk, S)``, halved until one block's shared memory
    holds it (128 -> 64 at N = P = 128): the chunk length changes only the
    rounding."""
    L = min(int(chunk), S)
    while f32_smem_bytes(L, N, P) > SMEM_MAX:
        if L == 1:
            raise ValueError(f"{NAME}: N={N}, P={P} needs "
                             f"{f32_smem_bytes(L, N, P)} bytes of shared "
                             f"memory at chunk 1, more than {SMEM_MAX}")
        L = -(-L // 2)
    return L


def scan_plan(dtype: torch.dtype, Bsz: int, S: int, H: int, P: int, N: int,
              chunk: int) -> ScanPlan:
    """How a launch is cut (a block has 256 threads in either form).
    bfloat16: chunks of ``min(chunk, S)`` in parallel, a block per (chunk,
    batch, head, 64 state columns), at every chunk up to 128 (P = 128
    included).  float32: a block per (batch, head) over the chunks in
    order, at the largest chunk whose block fits (:func:`fitting_chunk`)."""
    if dtype == torch.bfloat16:
        L = min(int(chunk), S)
        nc, cb = -(-S // L), -(-P // BF16_COLS)
        return ScanPlan(L, nc, cb, nc * Bsz * H * cb, bf16_smem_bytes(L, N))
    L = fitting_chunk(chunk, S, N, P)
    return ScanPlan(L, -(-S // L), 1, Bsz * H, f32_smem_bytes(L, N, P))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.ssd_scan_f32.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_f32.argtypes = [P] * 7 + [I] * 6 + [P]
        lib.ssd_scan_f32.restype = I
        lib.ssd_scan_bf16.argtypes = ([P] * 10 + [ctypes.c_ulonglong]
                                      + [I] * 7 + [P])
        lib.ssd_scan_bf16.restype = I
        lib.ssd_scan_error_string.argtypes = [I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_smem_bytes.argtypes = [I, I, I]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_scan_bf16_smem_bytes.argtypes = [I, I]
        lib.ssd_scan_bf16_smem_bytes.restype = ctypes.c_longlong
    return lib


class _Handoff:
    """The bfloat16 form's hand-off buffers of one (device, stream): the
    block ticket and the chunk flags, which its launches share in stream
    order.  ``base`` is the ticket's count before the next launch, and each
    launch takes a new ``epoch`` for its flags."""

    def __init__(self, device: torch.device):
        self.ticket = torch.zeros(1, dtype=torch.int64, device=device)
        self.flags = torch.zeros(0, dtype=torch.int32, device=device)
        self.base = 0
        self.epoch = 0

    def flags_for(self, n: int) -> torch.Tensor:
        if self.flags.numel() < n:
            self.flags = torch.zeros(max(n, 2 * self.flags.numel()),
                                     dtype=torch.int32,
                                     device=self.flags.device)
        return self.flags


_HANDOFF: Dict[Tuple[torch.device, int], _Handoff] = {}


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P) float32 or bfloat16; dt (B, S, H) float32; A (H,)
    float32; Bm / Cm (B, S, N) of x's dtype; all contiguous; P and N
    multiples of 4, P at most 128 (N at most 128 in bfloat16).  ``chunk``
    is at most 128; :func:`scan_plan` gives the chunk the kernel scans,
    and S need not be a multiple of it.  Returns (y (B, S, H, P) in x's
    dtype, final state (B, H, N, P) float32)."""
    dev = x.device
    check_operand(x, "x", device=dev, ndim=4)
    check_operand(dt, "dt", device=dev, dtype=torch.float32, ndim=3)
    check_operand(A, "A", device=dev, dtype=torch.float32, ndim=1)
    check_operand(Bm, "Bm", device=dev, dtype=x.dtype, ndim=3)
    check_operand(Cm, "Cm", device=dev, dtype=x.dtype, ndim=3)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[2]
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (Bsz, S, N) or Cm.shape != Bm.shape):
        raise ValueError(f"{NAME}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} disagree")
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError(f"{NAME}: operands must be contiguous")
    if P % 4 or N % 4 or not 4 <= P <= P_MAX or N < 4:
        raise ValueError(f"{NAME}: P and N must be multiples of 4, P at most "
                         f"{P_MAX}; got P={P}, N={N}")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and N > N_MAX_BF16:
        raise ValueError(f"{NAME}: bfloat16 takes N at most {N_MAX_BF16}, "
                         f"got N={N}")
    if not 1 <= chunk <= CHUNK_MAX:
        raise ValueError(f"{NAME}: chunk must be in [1, {CHUNK_MAX}], got "
                         f"{chunk}")
    y = torch.empty_like(x)
    final = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=dev)
    if Bsz * H == 0:
        return y, final
    if S == 0:
        return y, final.zero_()
    plan = scan_plan(x.dtype, Bsz, S, H, P, N, chunk)
    lib = _lib()
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), final.data_ptr())
    with on_device(dev):
        stream = stream_of(dev)
        if bf16:
            hand = _HANDOFF.get((dev, stream))
            if hand is None:
                hand = _HANDOFF[(dev, stream)] = _Handoff(dev)
            bhp, nc = Bsz * H * plan.col_blocks, plan.chunks
            ng = -(-nc // BF16_GROUP)
            # the chunks' own states, the groups' in-states, the chunks' seg
            scratch = (torch.empty(bhp * ((nc + ng) * N * BF16_COLS + nc),
                                   dtype=torch.float32, device=dev)
                       if nc > 1 else final)
            flags = hand.flags_for(bhp * (nc + ng))
            hand.epoch += 1
            rc = lib.ssd_scan_bf16(*ptrs, scratch.data_ptr(), flags.data_ptr(),
                                   hand.ticket.data_ptr(), hand.base,
                                   hand.epoch, Bsz, S, H, P, N, plan.chunk,
                                   stream)
            if rc == 0:
                hand.base += plan.blocks
        else:
            rc = lib.ssd_scan_f32(*ptrs, Bsz, S, H, P, N, plan.chunk, stream)
    raise_on_error(rc, lib, "ssd_scan_error_string", NAME)
    LAUNCHES[NAME] += 1
    return y, final
