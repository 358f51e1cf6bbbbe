"""RMSNorm over the last dim of a tensor of any leading dims: the kernel
for a CUDA tensor (under autograd, a Function whose backward is the plain
version's), the plain version for a CPU tensor, and for a ``meta`` tensor
(the dry run's trace) a stand-in that gives the output's shape and charges
the launch's ``cost``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.autograd import plain_vjp, wants_grad
from repro_torch.kernels.rmsnorm.kernel import NAME, rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.cost_hooks import charge


def cost(rows: int, D: int, itemsize: int, scale_itemsize: int = 4
         ) -> Tuple[float, int]:
    """(FLOPs, bytes) of one launch over ``rows`` rows of ``D``: x read
    and the output written once, ``scale`` read once; 4 FLOPs an element
    (the square, its sum, the two products)."""
    return 4.0 * rows * D, 2 * rows * D * itemsize + D * scale_itemsize


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    D = x.shape[-1]
    if x.device.type == "meta":
        charge(NAME, *cost(x.numel() // max(D, 1), D, x.element_size(),
                           scale.element_size()))
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out = rmsnorm_kernel(x.reshape(-1, D).contiguous(), scale, eps=eps)
    return out.reshape(x.shape)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        gx, gs = plain_vjp("rmsnorm",
                           lambda a, s: rmsnorm_ref(a, s, ctx.eps),
                           (x, scale), ctx.needs_input_grad[:2], (g,))
        return gx, gs, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if wants_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    return _launch(x, scale, eps)
