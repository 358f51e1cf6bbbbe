"""Plain PyTorch version of the RMSNorm kernel (the twin of the JAX
package's ``rmsnorm_ref``): float32 reduction, output in ``x``'s dtype."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
