"""Binding of the decode-attention kernel (``csrc/decode_attention.cu``),
which replaces the TPU kernel ``decode_attention_kernel`` of
``repro.kernels.decode_attention.kernel``.

The wrapper checks its operands, allocates the output, launches the kernel
on the current stream and raises if the launch is refused.  CUDA tensors
only: the plain version is ``ref.decode_attention_ref``.
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

NAME = "decode_attention"
SOURCE = Path(__file__).parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
SMEM_MAX = 232448               # bytes of shared memory one block may use
LAUNCHES.setdefault(NAME, 0)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 5 + [I] * 6 + [L] * 8 + [ctypes.c_float, P]
        fn.restype = I
        lib.decode_attention_smem.argtypes = [I, I]
        lib.decode_attention_smem.restype = ctypes.c_size_t
        lib.decode_attention_error_string.argtypes = [I]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); caches (B, Smax, K, hd), any strides with the head dim
    contiguous and rows 16-byte aligned; one dtype (float32 or bfloat16);
    lengths (B*K,) int32, the valid length of each (batch, KV head) row,
    at least 1.  Returns (B, H, hd) contiguous."""
    dev = q.device
    check_operand(q, "q", device=dev, ndim=3)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        check_operand(t, name, device=dev, dtype=q.dtype, ndim=4)
        check_aligned16(t, name)
    code = dtype_code(q, "q")
    B, H, hd = q.shape
    _, Smax, K, _ = k_cache.shape
    check_hd(hd, HEAD_DIMS, NAME)
    if (tuple(k_cache.shape) != (B, Smax, K, hd)
            or tuple(v_cache.shape) != tuple(k_cache.shape)
            or K < 1 or H % K):
        raise ValueError(f"{NAME}: q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)} do "
                         "not form grouped-query attention")
    check_operand(lengths, "lengths", device=dev, dtype=torch.int32, ndim=1)
    if lengths.shape[0] != B * K or not lengths.is_contiguous():
        raise ValueError(f"{NAME}: lengths must be contiguous ({B * K},), got "
                         f"{tuple(lengths.shape)}")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    if B == 0:
        return out
    lib = _lib()
    smem = lib.decode_attention_smem(H // K, hd)
    if smem > SMEM_MAX:
        raise ValueError(f"{NAME} needs {smem} B of shared memory per block "
                         f"(G={H // K}, hd={hd}); the card offers {SMEM_MAX}")
    with on_device(dev):
        rc = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, Smax, H, K, hd, code,
            q.stride(0), q.stride(1),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            1.0 / math.sqrt(hd), stream_of(dev))
    raise_on_error(rc, lib, "decode_attention_error_string", NAME)
    LAUNCHES[NAME] += 1
    return out
