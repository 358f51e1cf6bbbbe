"""Grouped expert matmul ``out[e] = x[e] @ w[e]``: the kernel for CUDA
tensors (under autograd, a Function whose backward is the plain version's),
the plain version for CPU tensors, and for ``meta`` tensors (the dry run's
trace) a stand-in that gives the output's shape and charges the launch's
``cost``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.autograd import plain_vjp, wants_grad
from repro_torch.kernels.moe_gmm.kernel import NAME, moe_gmm_kernel
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.cost_hooks import charge


def cost(E: int, C: int, D: int, N: int, itemsize: int
         ) -> Tuple[float, int]:
    """(FLOPs, bytes) of one launch: x (E, C, D) and w (E, D, N) read and
    the output (E, C, N) written once; 2 D FLOPs an output element."""
    return 2.0 * E * C * D * N, itemsize * (E * C * D + E * D * N + E * C * N)


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "meta":
        E, C, D = x.shape
        N = w.shape[-1]
        charge(NAME, *cost(E, C, D, N, x.element_size()))
        return torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    return moe_gmm_kernel(x, w)


class _MoeGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _launch(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return plain_vjp("moe_gmm", moe_gmm_ref, (x, w),
                         ctx.needs_input_grad[:2], (g,))


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) capacity-packed tokens; w: (E, D, N).  Returns
    (E, C, N) in ``x``'s dtype."""
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w)
    if wants_grad(x, w):
        return _MoeGmm.apply(x, w)
    return _launch(x, w)
