"""The Mamba2 SSD chunk scan: the kernel for CUDA tensors, the plain
chunked version for CPU tensors."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P); dt (B, S, H) float32 > 0; A (H,) float32 < 0; Bm /
    Cm (B, S, N).  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, N, P) float32)."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, chunk)
    return ssd_scan_kernel(x.contiguous(), dt.contiguous(), A.contiguous(),
                           Bm.contiguous(), Cm.contiguous(), chunk=chunk)
