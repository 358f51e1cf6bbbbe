"""RMSNorm over the last dim of a tensor of any leading dims: the kernel
for a CUDA tensor, the plain version for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    D = x.shape[-1]
    out = rmsnorm_kernel(x.reshape(-1, D).contiguous(), scale, eps=eps)
    return out.reshape(x.shape)
