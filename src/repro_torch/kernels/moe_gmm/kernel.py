"""Binding of the grouped expert matmul kernel (``csrc/moe_gmm.cu``),
which replaces the TPU kernel ``moe_gmm_kernel`` of
``repro.kernels.moe_gmm.kernel``.

bfloat16 runs on the tensor cores (``wgmma``, the weights read once for
every token row of a block's panel of up to 256), float32 on the scalar
kernel.  The wrapper checks its operands, allocates the output, launches
the kernel on the current stream and raises if the launch is refused.
CUDA tensors only: the plain version is ``ref.moe_gmm_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.binding import (check_aligned16, check_operand,
                                         dtype_code, on_device,
                                         raise_on_error, stream_of)

NAME = "moe_gmm"
SOURCE = Path(__file__).parent / "csrc" / "moe_gmm.cu"
E_MAX = 65535                   # the grid's y dimension
LAUNCHES.setdefault(NAME, 0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.moe_gmm_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, I, I, I, I, L, L, I, P]
        fn.restype = I
        lib.moe_gmm_error_string.argtypes = [I]
        lib.moe_gmm_error_string.restype = ctypes.c_char_p
    return lib


def moe_gmm_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, D) with any expert and row strides (D contiguous, rows
    16-byte aligned; an expert stride of 0 repeats one buffer across the
    experts); w (E, D, N) contiguous, of x's dtype (float32 or bfloat16);
    D and N multiples of 8.  Returns (E, C, N) contiguous in x's dtype."""
    dev = x.device
    check_operand(x, "x", device=dev, ndim=3)
    check_operand(w, "w", device=dev, dtype=x.dtype, ndim=3)
    code = dtype_code(x, "x")
    E, C, D = x.shape
    if tuple(w.shape[:2]) != (E, D) or not w.is_contiguous():
        raise ValueError(f"{NAME}: w must be contiguous ({E}, {D}, N) for x "
                         f"{tuple(x.shape)}, got {tuple(w.shape)}")
    N = w.shape[2]
    if D < 8 or D % 8 or N < 8 or N % 8:
        raise ValueError(f"{NAME}: D and N must be positive multiples of 8 "
                         f"(16-byte loads), got D={D}, N={N}")
    if E > E_MAX:
        raise ValueError(f"{NAME}: at most {E_MAX} experts, got {E}")
    check_aligned16(x, "x")
    check_aligned16(w, "w")
    out = torch.empty((E, C, N), dtype=x.dtype, device=dev)
    if E == 0 or C == 0:
        return out
    lib = _lib()
    with on_device(dev):
        rc = lib.moe_gmm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                E, C, D, N, x.stride(0), x.stride(1), code,
                                stream_of(dev))
    raise_on_error(rc, lib, "moe_gmm_error_string", NAME)
    LAUNCHES[NAME] += 1
    return out
