"""What the model kernels' ctypes bindings share: operand checks, the dtype
code their C entry points take, and the launch-result check."""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Sequence

import torch

# dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operand(t: torch.Tensor, name: str, *, device: torch.device,
                  dtype=None, ndim: int = None) -> None:
    """Raise unless ``t`` is a CUDA tensor on ``device`` whose last dim is
    contiguous (other strides are passed to the kernel)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on "
                         f"{t.device}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if t.dim() and t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name}: the last dim must be contiguous")


def check_aligned16(t: torch.Tensor, name: str) -> None:
    """Raise unless every row of ``t``'s last dim starts 16-byte aligned,
    as the kernels' 16-byte loads need (true of any tensor the allocator
    gives and of views that cut it at whole rows)."""
    es = t.element_size()
    if t.data_ptr() % 16 or any(t.stride(i) * es % 16
                                for i in range(t.dim() - 1)
                                if t.shape[i] > 1):
        raise ValueError(f"{name}: rows must start 16-byte aligned (pointer "
                         f"{t.data_ptr()}, strides {t.stride()})")


def dtype_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: expected float32 or bfloat16, got "
                        f"{t.dtype}")
    return DTYPE_CODES[t.dtype]


def check_hd(hd: int, supported: Sequence[int], name: str) -> None:
    if hd not in supported:
        raise ValueError(f"{name}: head_dim {hd} not in {tuple(supported)}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Multiprocessors of the card ``device`` names (a launch plan sizes a
    grid of one wave by it)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device: torch.device):
    """The device context a launch on ``device`` needs: none when it is
    already the current device (entering one costs microseconds on every
    launch of a decode step)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raise_on_error(rc: int, lib: ctypes.CDLL, error_fn: str,
                   kernel: str) -> None:
    if rc != 0:
        msg = getattr(lib, error_fn)(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({rc})")
