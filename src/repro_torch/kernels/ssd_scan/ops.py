"""The Mamba2 SSD chunk scan: the kernel for CUDA tensors (under autograd,
a Function whose backward is the plain chunked version's), the plain
chunked version for CPU tensors."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.autograd import plain_vjp, wants_grad
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked


def _launch(x, dt, A, Bm, Cm, chunk):
    return ssd_scan_kernel(x.contiguous(), dt.contiguous(), A.contiguous(),
                           Bm.contiguous(), Cm.contiguous(), chunk=chunk)


class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _launch(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy, gfinal):
        grads = plain_vjp(
            "ssd_scan",
            lambda *a: ssd_chunked(*a, ctx.chunk),
            ctx.saved_tensors, ctx.needs_input_grad[:5], (gy, gfinal))
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P); dt (B, S, H) float32 > 0; A (H,) float32 < 0; Bm /
    Cm (B, S, N).  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, N, P) float32)."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, chunk)
    if wants_grad(x, dt, A, Bm, Cm):
        return _SsdScan.apply(x, dt, A, Bm, Cm, chunk)
    return _launch(x, dt, A, Bm, Cm, chunk)
