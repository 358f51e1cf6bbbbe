"""Grouped expert matmul ``out[e] = x[e] @ w[e]``: the kernel for CUDA
tensors, the plain version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm.kernel import moe_gmm_kernel
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) capacity-packed tokens; w: (E, D, N).  Returns
    (E, C, N) in ``x``'s dtype."""
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w)
    return moe_gmm_kernel(x, w)
