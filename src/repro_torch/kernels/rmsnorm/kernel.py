"""Binding of the RMSNorm kernel (``csrc/rmsnorm.cu``), which replaces the
TPU kernel ``rmsnorm_kernel`` of ``repro.kernels.rmsnorm.kernel``.

The wrapper checks its operands, picks the launch plan
(:func:`launch_plan`), allocates the output, launches the kernel on the
current stream and raises if the launch is refused.  CUDA tensors only: the
plain version is ``ref.rmsnorm_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.binding import (check_operand, dtype_code,
                                         on_device, raise_on_error,
                                         sm_count, stream_of)

NAME = "rmsnorm"
SOURCE = Path(__file__).parent / "csrc" / "rmsnorm.cu"
D_MAX = 16384
# threads a block holds when its rows fit in fewer (a row of more threads
# takes a block of its own)
BLOCK_THREADS = 256
MAX_THREADS = 1024
LAUNCHES.setdefault(NAME, 0)


class Plan(NamedTuple):
    vec: int             # elements per access: 16 bytes' worth, or 1
    nv: int              # vectors each thread holds
    tpr: int             # threads per row, a power of two
    rows_per_block: int
    prefetch: int        # 1: scale read beside x (a grid of one wave)


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def launch_plan(D: int, element_size: int, aligned: bool, rows: int = 1,
                sms: int = 132) -> Plan:
    """The kernel's launch plan for ``rows`` rows of ``D`` elements of
    ``element_size`` bytes on a card of ``sms`` multiprocessors.  16-byte
    accesses where the rows and ``scale`` start 16-byte aligned and ``D``
    is a whole number of vectors, else one element per access.  A row of
    up to 32 vectors takes one vector a lane over as many lanes (a power of
    two, so a warp holds several rows); up to 64 and 128 vectors, two and
    four vectors a lane over a warp; longer rows two a lane over more
    warps (more vectors a lane past 1,024 threads).  A grid of at most one
    block per multiprocessor reads ``scale`` beside x (at up to 16
    elements a thread)."""
    vec = 16 // element_size
    if not aligned or D % vec:
        vec = 1
    dv = D // vec
    nv = 1 if dv <= 32 else 4 if 64 < dv <= 128 else 2
    tpr = _pow2_ceil(-(-dv // nv))
    while tpr > MAX_THREADS:
        nv *= 2
        tpr = _pow2_ceil(-(-dv // nv))
    rpb = max(1, BLOCK_THREADS // tpr)
    return Plan(vec, nv, tpr, rpb,
                int(nv * vec <= 16 and -(-rows // rpb) <= sms))



def _aligned16(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.rmsnorm_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, ctypes.c_float, I, I, I, I, I, I, P]
        fn.restype = I
        lib.rmsnorm_error_string.argtypes = [I]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_kernel(x: torch.Tensor, scale: torch.Tensor, *,
                   eps: float) -> torch.Tensor:
    """``x`` (rows, D) float32 or bfloat16, contiguous; ``scale`` (D,)
    float32.  Returns (rows, D) in ``x``'s dtype."""
    dev = x.device
    check_operand(x, "x", device=dev, ndim=2)
    check_operand(scale, "scale", device=dev, dtype=torch.float32, ndim=1)
    rows, D = x.shape
    code = dtype_code(x, "x")
    if not x.is_contiguous() or scale.shape[0] != D:
        raise ValueError(f"rmsnorm: x must be contiguous (rows, D) and scale "
                         f"(D,), got {tuple(x.shape)} / {tuple(scale.shape)}")
    if not 1 <= D <= D_MAX:
        raise ValueError(f"rmsnorm: D must be in [1, {D_MAX}], got {D}")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    plan = launch_plan(D, x.element_size(), _aligned16(x, scale, out), rows,
                       sm_count(dev))
    lib = _lib()
    with on_device(dev):
        rc = lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(),
                                out.data_ptr(), rows, D, float(eps), code,
                                *plan, stream_of(dev))
    raise_on_error(rc, lib, "rmsnorm_error_string", NAME)
    LAUNCHES[NAME] += 1
    return out
