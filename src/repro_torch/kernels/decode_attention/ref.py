"""Plain PyTorch version of the decode-attention kernel (the twin of the
JAX package's ``decode_attention_ref``): float32 scores and probabilities
over the first ``lengths[row]`` cache positions, output in ``q``'s dtype.
With ``f32_scores=False`` each q.k dot product is rounded to the caches'
dtype before the scale (the reference's ``decode_f32_scores=False``; a
float32 cache is unchanged by it)."""
from __future__ import annotations

import math

import torch


def _scores(q: torch.Tensor, k: torch.Tensor,
            f32_scores: bool) -> torch.Tensor:
    """q.k^T / sqrt(hd) in float32, each product first rounded to ``k``'s
    dtype unless ``f32_scores``."""
    s = torch.einsum("bgh,bsh->bgs", q.float(), k.float())
    if not f32_scores:
        s = s.to(k.dtype).float()
    return s / math.sqrt(q.shape[-1])


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor,
                         f32_scores: bool = True) -> torch.Tensor:
    """q: (BK, G, hd); k/v: (BK, Smax, hd); lengths: (BK,)."""
    Smax = k.shape[1]
    s = _scores(q, k, f32_scores)
    valid = (torch.arange(Smax, device=q.device)[None, None, :]
             < lengths.to(q.device)[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgs,bsh->bgh", p, v.float()).to(q.dtype)


def decode_attention_partials_ref(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, lengths: torch.Tensor,
                                  f32_scores: bool = True) -> tuple:
    """The kernel's partial mode in plain PyTorch (one split of
    :func:`decode_attention_split_ref`, normalised): float32 ``o`` (BK, G,
    hd), each row's softmax output over its first ``lengths[row]``
    positions, and ``lse`` (BK, G), the natural-log log-sum-exp of its
    scores; a row of length 0 gives o = 0, lse = -inf.  Shapes as
    :func:`decode_attention_ref`."""
    Smax = k.shape[1]
    sc = _scores(q, k, f32_scores)
    pos = torch.arange(Smax, device=q.device)[None, None, :]
    sc = torch.where(pos < lengths.to(q.device)[:, None, None], sc,
                     torch.full_like(sc, -math.inf))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - torch.where(m == -math.inf, 0.0, m))
    l_s = p.sum(-1, keepdim=True)
    acc = torch.einsum("bgs,bsh->bgh", p, v.float())
    o = torch.where(l_s > 0, acc / torch.clamp(l_s, min=1e-30), 0.0)
    lse = torch.where(l_s > 0, m + torch.log(torch.clamp(l_s, min=1e-30)),
                      -math.inf)
    return o, lse[..., 0]


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor, *,
                               n_splits: int) -> torch.Tensor:
    """The kernel's split of the sequence, in plain PyTorch: positions
    ``[s*P, (s+1)*P)`` with ``P = ceil(Smax / n_splits)`` give split ``s``
    a partial (m, l, acc) in float32 (m = -inf, l = 0 where the split holds
    no position below the row's length), merged in split order 0, 1, ...
    as the kernel's last block merges them.  Shapes as
    :func:`decode_attention_ref`; nothing on the main path calls it."""
    BK, G, hd = q.shape
    Smax = k.shape[1]
    P = -(-Smax // n_splits)
    qf, kf, vf = q.float(), k.float(), v.float()
    lengths = lengths.to(q.device)[:, None, None]
    m_all = torch.full((BK, G, 1), -math.inf, device=q.device)
    parts = []
    for s in range(n_splits):
        lo, hi = s * P, min((s + 1) * P, Smax)
        if lo >= hi:
            continue
        sc = torch.einsum("bgh,bsh->bgs", qf, kf[:, lo:hi]) / math.sqrt(hd)
        pos = torch.arange(lo, hi, device=q.device)[None, None, :]
        sc = torch.where(pos < lengths, sc, torch.full_like(sc, -math.inf))
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - torch.where(m == -math.inf, 0.0, m))
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bgs,bsh->bgh", p, vf[:, lo:hi])))
        m_all = torch.maximum(m_all, m)
    m_ref = torch.where(m_all == -math.inf, 0.0, m_all)
    l_tot = torch.zeros((BK, G, 1), device=q.device)
    acc = torch.zeros((BK, G, hd), device=q.device)
    for m, l_s, acc_s in parts:
        w = torch.exp(m - m_ref)          # 0 for an empty split
        l_tot = l_tot + l_s * w
        acc = acc + acc_s * w
    return (acc / torch.clamp(l_tot, min=1e-30)).to(q.dtype)
