"""RMSNorm over the last dim of a tensor of any leading dims: the kernel
for a CUDA tensor (under autograd, a Function whose backward is the plain
version's), the plain version for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import plain_vjp, wants_grad
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    D = x.shape[-1]
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
