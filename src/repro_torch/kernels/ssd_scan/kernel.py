"""Binding of the SSD chunk-scan kernel (``csrc/ssd_scan.cu``), which
replaces the TPU kernel ``ssd_scan_kernel`` of
``repro.kernels.ssd_scan.kernel``.

The wrapper checks its operands, allocates y and the final state, launches
the kernel on the current stream and raises if the launch is refused.
CUDA tensors only: the plain versions are in ``ref``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.binding import (check_operand, dtype_code,
                                         on_device, raise_on_error,
                                         stream_of)

NAME = "ssd_scan"
SOURCE = Path(__file__).parent / "csrc" / "ssd_scan.cu"
CHUNK_MAX = 128                 # warp 0 scans 4 positions per lane
P_MAX = 128                     # y tiles a thread holds in registers
SMEM_MAX = 232448               # bytes of shared memory a block can use
LAUNCHES.setdefault(NAME, 0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
        fn.restype = I
        lib.ssd_scan_error_string.argtypes = [I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib.ssd_scan_smem_bytes.argtypes = [I, I, I]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(L: int, N: int, P: int) -> int:
    """Shared memory (bytes) one block takes at chunk length L, from the
    source's ``Layout``."""
    return int(_lib().ssd_scan_smem_bytes(L, N, P))


def fitting_chunk(chunk: int, S: int, N: int, P: int) -> int:
    """``min(chunk, S)``, halved until one block's shared memory holds it
    (128 -> 64 at N = P = 128): the chunk length changes only the
    rounding."""
    L = min(int(chunk), S)
    while smem_bytes(L, N, P) > SMEM_MAX:
        if L == 1:
            raise ValueError(f"{NAME}: N={N}, P={P} needs "
                             f"{smem_bytes(L, N, P)} bytes of shared memory "
                             f"at chunk 1, more than {SMEM_MAX}")
        L = -(-L // 2)
    return L


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P) float32 or bfloat16; dt (B, S, H) float32; A (H,)
    float32; Bm / Cm (B, S, N) of x's dtype; all contiguous; P and N
    multiples of 4, P at most 128.  ``chunk`` is at most 128; the kernel
    scans chunks of ``fitting_chunk`` positions, and S need not be a
    multiple of it.  Returns (y (B, S, H, P) in x's
    dtype, final state (B, H, N, P) float32)."""
    dev = x.device
    check_operand(x, "x", device=dev, ndim=4)
    check_operand(dt, "dt", device=dev, dtype=torch.float32, ndim=3)
    check_operand(A, "A", device=dev, dtype=torch.float32, ndim=1)
    check_operand(Bm, "Bm", device=dev, dtype=x.dtype, ndim=3)
    check_operand(Cm, "Cm", device=dev, dtype=x.dtype, ndim=3)
    code = dtype_code(x, "x")
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
    if not 1 <= chunk <= CHUNK_MAX:
        raise ValueError(f"{NAME}: chunk must be in [1, {CHUNK_MAX}], got "
                         f"{chunk}")
    y = torch.empty_like(x)
    final = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=dev)
    if Bsz * H == 0:
        return y, final
    if S == 0:
        return y, final.zero_()
    L = fitting_chunk(chunk, S, N, P)
    lib = _lib()
    with on_device(dev):
        rc = lib.ssd_scan_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                 Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                                 final.data_ptr(), Bsz, S, H, P, N, L, code,
                                 stream_of(dev))
    raise_on_error(rc, lib, "ssd_scan_error_string", NAME)
    LAUNCHES[NAME] += 1
    return y, final
