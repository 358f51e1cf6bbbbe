"""Plain PyTorch version of the prefill-attention kernel (the twin of the
JAX package's ``attention_ref``): float32 scores and probabilities, output
in ``q``'s dtype."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (BKG, Sq, hd) rows ordered (batch, kv_head, group); k/v:
    (BK, Skv, hd)."""
    BKG, Sq, hd = q.shape
    BK, Skv, _ = k.shape
    G = BKG // BK
    kk = torch.repeat_interleave(k, G, dim=0).float()
    vv = torch.repeat_interleave(v, G, dim=0).float()
    s = torch.einsum("bqh,bkh->bqk", q.float(), kk) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, vv).to(q.dtype)
