"""Plain PyTorch version of the grouped expert matmul (the twin of the JAX
package's ``moe_gmm_ref``): float32 products of the operands' values,
output in ``x``'s dtype."""
from __future__ import annotations

import torch


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w: (E, D, N) -> (E, C, N) with float32 accumulation."""
    return torch.einsum("ecd,edn->ecn", x.float(), w.float()).to(x.dtype)
