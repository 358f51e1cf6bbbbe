"""Single-token decode attention in the model layout: the kernel for CUDA
tensors, the plain version (through the kernel layout, as the JAX
package's ``ops`` calls its Pallas kernel) for CPU tensors, and for
``meta`` tensors (the dry run's trace) a stand-in that gives the output's
shape and charges the launch's ``cost``; its partial mode for a cache
whose positions are split across processes, and the merge of the
partials.  ``f32_scores=False`` rounds each q.k dot product to the
caches' dtype before the scale (the reference's
``decode_f32_scores=False``)."""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.kernel import (
    NAME, PARTIAL_NAME, decode_attention_kernel)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_partials_ref, decode_attention_ref)
from repro_torch.cost_hooks import charge


def cost(B: int, H: int, K: int, hd: int, positions: int, itemsize: int,
         partial: bool = False) -> Tuple[float, int]:
    """(FLOPs, bytes) of one launch over ``positions`` valid cache
    positions summed over the B K (batch, KV head) rows: their K and V
    rows read once, q read and the output written once (the partial mode's
    float32 o and lse), the lengths read; 4 hd FLOPs a (query head,
    position) pair (the score and its product with v)."""
    flops = 4.0 * (H // K) * hd * positions
    kv = 2 * hd * itemsize * positions
    if partial:
        return flops, (kv + B * H * hd * itemsize + 4 * (B * H * hd + B * H)
                       + 4 * B * K)
    return flops, kv + 2 * B * H * hd * itemsize + 4 * B * K


def _meta_positions(B: int, K: int, Smax: int, pos: Optional[int]) -> int:
    """The valid positions a ``meta`` launch counts: every row's ``pos +
    1``, or, with lengths that have no values on ``meta``, every row's
    ``Smax`` (the dry run's decode cell writes the last position)."""
    return B * K * (Smax if pos is None else min(int(pos) + 1, Smax))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: Optional[int] = None, *,
                     lengths: Optional[torch.Tensor] = None,
                     f32_scores: bool = True) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, Smax, K, hd) (any strides with the head
    dim contiguous).  Either ``pos``, the position just written (every row
    valid through it), or ``lengths`` (B*K,) int32, the valid length of
    each (batch, KV head) row as the TPU kernel takes them.  Returns
    (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    _, Smax, K, _ = k_cache.shape
    if (pos is None) == (lengths is None):
        raise ValueError("give exactly one of pos and lengths")
    if q.device.type == "meta":
        charge(NAME, *cost(B, H, K, hd, _meta_positions(B, K, Smax, pos),
                           q.element_size()))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if lengths is None:
        lengths = torch.full((B * K,), int(pos) + 1, dtype=torch.int32,
                             device=q.device)
    if q.device.type != "cpu":
        return decode_attention_kernel(
            q[:, 0], k_cache, v_cache, lengths,
            bf16_scores=not f32_scores).reshape(B, 1, H, hd)
    G = H // K
    qf = q.reshape(B * K, G, hd)
    kf = k_cache.permute(0, 2, 1, 3).reshape(B * K, Smax, hd)
    vf = v_cache.permute(0, 2, 1, 3).reshape(B * K, Smax, hd)
    return decode_attention_ref(qf, kf, vf, lengths,
                                f32_scores).reshape(B, 1, H, hd)


def decode_attention_partials(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, lengths: torch.Tensor,
                              f32_scores: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial of one slice of a cache: q (B, 1, H, hd), caches (B,
    Smax, K, hd) as :func:`decode_attention`, ``lengths`` (B*K,) int32 the
    valid positions of each row in this slice (0 allowed).  Returns
    float32 ``o`` (B, 1, H, hd) and ``lse`` (B, 1, H) (the kernel's
    partial mode; its plain version for CPU tensors)."""
    B, _, H, hd = q.shape
    _, Smax, K, _ = k_cache.shape
    if q.device.type == "meta":
        charge(PARTIAL_NAME, *cost(B, H, K, hd,
                                   _meta_positions(B, K, Smax, None),
                                   q.element_size(), partial=True))
        return (torch.empty((B, 1, H, hd), dtype=torch.float32,
                            device=q.device),
                torch.empty((B, 1, H), dtype=torch.float32, device=q.device))
    if q.device.type != "cpu":
        o, lse = decode_attention_kernel(q[:, 0], k_cache, v_cache, lengths,
                                         partial=True,
                                         bf16_scores=not f32_scores)
        return o.reshape(B, 1, H, hd), lse.reshape(B, 1, H)
    G = H // K
    kf = k_cache.permute(0, 2, 1, 3).reshape(B * K, Smax, hd)
    vf = v_cache.permute(0, 2, 1, 3).reshape(B * K, Smax, hd)
    o, lse = decode_attention_partials_ref(q.reshape(B * K, G, hd), kf, vf,
                                           lengths, f32_scores)
    return o.reshape(B, 1, H, hd), lse.reshape(B, 1, H)


def merge_partials(parts: List[Tuple[torch.Tensor, torch.Tensor]],
                   dtype: torch.dtype) -> torch.Tensor:
    """The attention over the whole cache from its slices' partials
    ``(o (..., hd), lse (...))``, added in the order given (the slices'
    rank order, so the result does not depend on timing), in float32,
    cast to ``dtype``.  A slice with lse = -inf weighs nothing."""
    lse_max = torch.stack([lse for _, lse in parts]).amax(0)
    ref = torch.where(lse_max == -math.inf, 0.0, lse_max)
    num = torch.zeros_like(parts[0][0])
    den = torch.zeros_like(parts[0][1])
    for o, lse in parts:
        w = torch.exp(lse - ref)
        num = num + o * w[..., None]
        den = den + w
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(dtype)
