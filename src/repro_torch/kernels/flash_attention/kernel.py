"""Binding of the prefill-attention kernel (``csrc/flash_attention.cu``),
which replaces the TPU kernel ``flash_attention_kernel`` of
``repro.kernels.flash_attention.kernel``.

The wrapper checks its operands, allocates the output, launches the kernel
on the current stream and raises if the launch is refused.  CUDA tensors
only: the plain version is ``ref.attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.binding import (check_aligned16, check_hd,
                                         check_operand, dtype_code,
                                         on_device, raise_on_error,
                                         stream_of)

NAME = "flash_attention"
SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 256                 # query heads per KV head
LAUNCHES.setdefault(NAME, 0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 4 + [I] * 8 + [L] * 9 + [ctypes.c_float, P]
        fn.restype = I
        lib.flash_attention_error_string.argtypes = [I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, K, hd), one dtype (float32 or
    bfloat16), any strides with the head dim contiguous and rows 16-byte
    aligned.  Returns (B, Sq, H, hd) contiguous."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(t, name, device=dev, dtype=q.dtype, ndim=4)
        check_aligned16(t, name)
    code = dtype_code(q, "q")
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    check_hd(hd, HEAD_DIMS, NAME)
    if (tuple(k.shape) != (B, Skv, K, hd) or tuple(v.shape) != tuple(k.shape)
            or K < 1 or H % K or H // K > MAX_GROUP):
        raise ValueError(f"{NAME}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} / {tuple(v.shape)} do not form "
                         f"grouped-query attention (at most {MAX_GROUP} query "
                         "heads per KV head)")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    if B == 0 or Sq == 0 or Skv == 0:
        return out.zero_()
    lib = _lib()
    with on_device(dev):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, K, hd, code, int(bool(causal)),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            1.0 / math.sqrt(hd), stream_of(dev))
    raise_on_error(rc, lib, "flash_attention_error_string", NAME)
    LAUNCHES[NAME] += 1
    return out
