"""Plain PyTorch version of the decode-attention kernel (the twin of the
JAX package's ``decode_attention_ref``): float32 scores and probabilities
over the first ``lengths[row]`` cache positions, output in ``q``'s dtype."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (BK, G, hd); k/v: (BK, Smax, hd); lengths: (BK,)."""
    BK, G, hd = q.shape
    Smax = k.shape[1]
    s = torch.einsum("bgh,bsh->bgs", q.float(), k.float()) / math.sqrt(hd)
    valid = (torch.arange(Smax, device=q.device)[None, None, :]
             < lengths.to(q.device)[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgs,bsh->bgh", p, v.float()).to(q.dtype)
