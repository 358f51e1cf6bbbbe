"""Binding of the RMSNorm kernel (``csrc/rmsnorm.cu``), which replaces the
TPU kernel ``rmsnorm_kernel`` of ``repro.kernels.rmsnorm.kernel``.

The wrapper checks its operands, allocates the output, launches the kernel
on the current stream and raises if the launch is refused.  CUDA tensors
only: the plain version is ``ref.rmsnorm_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.binding import (check_operand, dtype_code,
                                         on_device, raise_on_error,
                                         stream_of)

NAME = "rmsnorm"
SOURCE = Path(__file__).parent / "csrc" / "rmsnorm.cu"
D_MAX = 16384
LAUNCHES.setdefault(NAME, 0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.rmsnorm_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, ctypes.c_float, I, P]
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
    lib = _lib()
    with on_device(dev):
        rc = lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(),
                                out.data_ptr(), rows, D, float(eps), code,
                                stream_of(dev))
    raise_on_error(rc, lib, "rmsnorm_error_string", NAME)
    LAUNCHES[NAME] += 1
    return out
