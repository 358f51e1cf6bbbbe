"""The Mamba2 SSD chunk scan: the kernel for CUDA tensors (under autograd,
a Function whose backward is the plain chunked version's), the plain
chunked version for CPU tensors, and for ``meta`` tensors (the dry run's
trace) a stand-in that gives the outputs' shapes and charges the launch's
``cost``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.autograd import plain_vjp, wants_grad
from repro_torch.kernels.ssd_scan.kernel import NAME, ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.cost_hooks import charge


def cost(B: int, S: int, H: int, P: int, N: int, chunk: int, itemsize: int
         ) -> Tuple[float, int]:
    """(FLOPs, bytes) of one launch: each input read and each output
    written once (x, B, C and y in the inputs' dtype; dt, A and the final
    state float32), and the FLOPs the chunked algorithm needs: per (batch,
    chunk of Lc positions) Lc (Lc + 1) N for the causal half of C B^T,
    which every head shares, and per (batch, head, chunk) Lc (Lc + 1) P
    for its product with x and 4 Lc N P for the state's read and update."""
    n_bytes = (2 * B * S * H * P * itemsize + 2 * B * S * N * itemsize
               + 4 * B * S * H + 4 * H + 4 * B * H * N * P)
    full, rest = divmod(S, chunk)
    lens = [chunk] * full + ([rest] if rest else [])
    flops = float(B * sum(Lc * (Lc + 1) * (N + H * P) + 4 * H * Lc * N * P
                          for Lc in lens))
    return flops, n_bytes


def _launch(x, dt, A, Bm, Cm, chunk):
    if x.device.type == "meta":
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        charge(NAME, *cost(B, S, H, P, N, chunk, x.element_size()))
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                torch.empty((B, H, N, P), dtype=torch.float32,
                            device=x.device))
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
