"""Grouped expert matmul ``out[e] = x[e] @ w[e]``: the kernel for CUDA
tensors (under autograd, a Function whose backward is the plain version's),
the plain version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import plain_vjp, wants_grad
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_kernel
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref


class _MoeGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return moe_gmm_kernel(x, w)

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
    return moe_gmm_kernel(x, w)
