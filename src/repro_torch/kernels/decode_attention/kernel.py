"""Binding of the decode-attention kernel (``csrc/decode_attention.cu``),
which replaces the TPU kernel ``decode_attention_kernel`` of
``repro.kernels.decode_attention.kernel``.

The wrapper checks its operands, allocates the output, launches the kernel
on the current stream and raises if the launch is refused.  CUDA tensors
only: the plain version is ``ref.decode_attention_ref`` (and
``ref.decode_attention_split_ref`` for the kernel's split of the sequence).

The kernel splits the sequence into ``ceil(Smax / SPLIT)`` parts, one block
each per (batch, KV head).  With more than one, the blocks' partials go to
a float32 workspace and a per-row int32 counter picks the block that merges
them; both are cached per (device, stream), the counters zeroed once when
allocated and left zero by every launch.

With ``bf16_scores`` (bfloat16 operands) each q.k dot product is rounded
to bfloat16 before the scale, as the reference's ``decode_f32_scores=False``
scores are; float32 operands ignore it.

Partial mode (``partial=True``, the sequence-sharded decode across
processes): the same launch writes each (batch, head) row's float32
``(o, lse)`` instead of its output, counted under ``PARTIAL_NAME``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.binding import (check_aligned16, check_hd,
                                         check_operand, dtype_code,
                                         on_device, raise_on_error,
                                         stream_of)

NAME = "decode_attention"
PARTIAL_NAME = "decode_attention_partial"
SOURCE = Path(__file__).parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
SPLIT = 512                     # cache positions per block (tuned on an H100)
LAUNCHES.setdefault(NAME, 0)
LAUNCHES.setdefault(PARTIAL_NAME, 0)
# (device index, stream) -> (counters int32, workspace float32)
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 8 + [I] * 7 + [L] * 8 + [ctypes.c_float, I, P]
        fn.restype = I
        lib.decode_attention_error_string.argtypes = [I]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _scratch(dev: torch.device, stream: int, n_counters: int,
             n_floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split merge's counters and workspace for ``stream``, grown (and
    new counters zeroed) when a launch needs more than they hold."""
    key = (dev.index, stream)
    counters, ws = _SCRATCH.get(key, (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=dev)
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(n_floats, dtype=torch.float32, device=dev)
    _SCRATCH[key] = (counters, ws)
    return counters, ws


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, lengths: torch.Tensor,
                            partial: bool = False, bf16_scores: bool = False):
    """q (B, H, hd); caches (B, Smax, K, hd), any strides with the head dim
    contiguous and rows 16-byte aligned; one dtype (float32 or bfloat16);
    lengths (B*K,) int32, the valid length of each (batch, KV head) row
    (0 allowed: the row's output is 0).  Returns (B, H, hd) contiguous;
    with ``partial``, float32 ``(o (B, H, hd), lse (B, H))``: each row's
    softmax output and natural-log log-sum-exp (-inf for a row of length
    0, whose o is 0).  ``bf16_scores``: each q.k rounded to bfloat16
    before the scale (the module docstring)."""
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
    out = torch.empty((B, H, hd), dtype=torch.float32 if partial
                      else q.dtype, device=dev)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if partial else None)
    if B == 0 or Smax == 0:
        out.zero_()
        return (out, lse.fill_(-math.inf)) if partial else out
    lib = _lib()
    stream = stream_of(dev)
    split = SPLIT
    n_splits = -(-Smax // split)
    ws_ptr = counters_ptr = None
    if n_splits > 1:
        counters, ws = _scratch(dev, stream, B * H,
                                B * H * n_splits * (2 + hd))
        ws_ptr, counters_ptr = ws.data_ptr(), counters.data_ptr()
    with on_device(dev):
        rc = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), ws_ptr, counters_ptr, B,
            Smax, H, K, hd, code, split,
            q.stride(0), q.stride(1),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            1.0 / math.sqrt(hd), int(bf16_scores), stream)
    raise_on_error(rc, lib, "decode_attention_error_string", NAME)
    LAUNCHES[PARTIAL_NAME if partial else NAME] += 1
    return (out, lse) if partial else out
