"""Prefill attention in the model layout: the kernel for CUDA tensors
(under autograd, a Function whose backward is the plain version's), the
plain version (through the kernel layout, as the JAX package's ``ops``
calls its Pallas kernel) for CPU tensors, and for ``meta`` tensors (the
dry run's trace) a stand-in that gives the output's shape and charges the
launch's ``cost``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.autograd import plain_vjp, wants_grad
from repro_torch.kernels.flash_attention.kernel import (
    NAME, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.cost_hooks import charge


def cost(B: int, Sq: int, Skv: int, H: int, K: int, hd: int, itemsize: int,
         causal: bool) -> Tuple[float, int]:
    """(FLOPs, bytes) of one launch: q, k and v read and the output
    written once; 4 hd FLOPs a (query head, key) pair attended (the score
    and its product with v), the causal pairs of queries at offset 0 only
    (``min(i + 1, Skv)`` keys for query ``i``)."""
    if causal:
        m = min(Sq, Skv)
        pairs = m * (m + 1) // 2 + (Sq - m) * Skv
    else:
        pairs = Sq * Skv
    return (4.0 * B * H * hd * pairs,
            itemsize * (2 * B * Sq * H * hd + 2 * B * Skv * K * hd))


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    if q.device.type == "meta":
        B, Sq, H, hd = q.shape
        charge(NAME, *cost(B, Sq, k.shape[1], H, k.shape[2], hd,
                           q.element_size(), causal))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return flash_attention_kernel(q, k, v, causal=causal)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool) -> torch.Tensor:
    """The plain version in the model layout."""
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


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        grads = plain_vjp(
            "flash_attention",
            lambda a, b, c: flash_attention_plain(a, b, c, ctx.causal),
            (q, k, v), ctx.needs_input_grad[:3], (g,))
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, K, hd) with H = K*G.  Returns
    (B, Sq, H, hd)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    return _launch(q, k, v, causal)
