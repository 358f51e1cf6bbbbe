"""Prefill attention in the model layout: the kernel for CUDA tensors, the
plain version (through the kernel layout, as the JAX package's ``ops`` calls
its Pallas kernel) for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, K, hd) with H = K*G.  Returns
    (B, Sq, H, hd)."""
    if q.device.type != "cpu":
        return flash_attention_kernel(q, k, v, causal=causal)
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    qf = (q.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)
          .reshape(B * K * G, Sq, hd))
    kf = k.permute(0, 2, 1, 3).reshape(B * K, Skv, hd)
    vf = v.permute(0, 2, 1, 3).reshape(B * K, Skv, hd)
    of = attention_ref(qf, kf, vf, causal=causal)
    return (of.reshape(B, K, G, Sq, hd).permute(0, 3, 1, 2, 4)
            .reshape(B, Sq, H, hd))
