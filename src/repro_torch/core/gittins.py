"""Gittins-policy rank computation (§3.3).

    G(D, a) = inf_{Δ>0}  E[min(X−a, Δ) | X>a] / P(X−a ≤ Δ | X>a)

PyTorch counterpart of ``repro.core.gittins``.  The numpy host functions
are copied as they are.  ``to_histogram_rows`` and ``gittins_rank_core``
are the torch versions of ``to_histogram_rows_jnp`` and the JAX
``gittins_rank_core``, written op for op so the same float32 inputs give
the same bits.

Summation order.  The reference's bucket sums are XLA reductions, and XLA on
the CPU evaluates ``sum(min(rem, Δ) * p)`` as a left-to-right chain of fused
multiply-adds and ``sum(where(rem <= Δ, p, 0))`` as a left-to-right chain
of adds.  ``gittins_rank_core`` spells both as one explicit loop over the
buckets in that order, with :func:`fma32` for the fused step, and the CUDA
kernel's in-kernel rank runs the same loop with ``__fmaf_rn`` — so the
card's in-kernel ranks, the arena-wide rank-in-place and the JAX package's
CPU ranks are all the same bits.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

N_BUCKETS = 10
_INF = 1e30


def to_histogram(samples: np.ndarray, n_buckets: int = N_BUCKETS
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(probs (n,), right edges (n,)) over [min, max] of the samples."""
    s = np.asarray(samples, np.float64).reshape(1, -1)
    probs, edges = to_histogram_batch(s, n_buckets)
    return probs[0], edges[0]


def to_histogram_batch(samples: np.ndarray, n_buckets: int = N_BUCKETS
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Row-wise ``to_histogram``: samples (A, W) -> (probs, right edges),
    each (A, n).  Uniform bins over [min, max], right-open with the last bin
    closed (floor-based assignment)."""
    s = np.asarray(samples, np.float64)
    A, W = s.shape
    lo = s.min(axis=1)
    hi = s.max(axis=1)
    hi = np.where(hi <= lo, lo + np.maximum(np.abs(lo) * 1e-3, 1e-6), hi)
    norm = n_buckets / (hi - lo)
    idx = ((s - lo[:, None]) * norm[:, None]).astype(np.int64)
    np.clip(idx, 0, n_buckets - 1, out=idx)
    flat = idx + (np.arange(A) * n_buckets)[:, None]
    cnt = np.bincount(flat.ravel(), minlength=A * n_buckets) \
        .reshape(A, n_buckets)
    probs = cnt / max(W, 1)
    edges = np.linspace(lo, hi, n_buckets + 1, axis=1)[:, 1:]
    return probs.astype(np.float64), edges


def gittins_rank_samples(samples: np.ndarray, attained: float) -> float:
    """Exact empirical Gittins rank from raw samples (numpy oracle)."""
    s = np.sort(np.asarray(samples, np.float64))
    if len(s) and attained >= s[-1]:
        return float(attained)  # outlived the distribution: long-job prior
    a = float(attained) if len(s) else 0.0
    tail = s[s > a]
    if len(tail) == 0:
        tail = s[-1:]
    rem = tail - a                       # candidate Δ at each sample point
    n = len(rem)
    csum = np.cumsum(rem)
    j = np.arange(n)
    e_min = (csum + (n - j - 1) * rem) / n
    p_le = (j + 1) / n
    return float(np.min(e_min / p_le))


def f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device, rounded from ``x``
    exactly as numpy (and JAX's weak-typed Python floats) round it."""
    return torch.tensor(np.float32(x), device=like.device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fma(a, b, c)`` rounded once, as the hardware instruction.

    PyTorch has no fused multiply-add operator, so this computes it in
    float64: ``a * b`` is exact there (24 + 24 significant bits), the add
    is exact as a TwoSum pair ``s + err``, and the single float64 rounding
    of ``s`` can only mislead the final float32 rounding when ``s`` lies
    exactly on a float32 midpoint — then ``err`` decides the side."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    d = s - r.to(torch.float64)                  # > 0: r lies below s
    inf = torch.full_like(r, float("inf"))
    other = torch.where(d > 0, torch.nextafter(r, inf),
                        torch.nextafter(r, -inf))
    tie = (d != 0) & ((other.to(torch.float64) - s) == d)
    fix = tie & (((err > 0) & (d > 0)) | ((err < 0) & (d < 0)))
    return torch.where(fix, other, r)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order XLA's CPU backend evaluates
    ``jnp.sum`` there.  A row of at most 32 values sums left to right; a
    longer one is zero-padded to a multiple of 32 (half the padding in
    front, the odd element behind), each window of 32 sums left to right,
    and the window sums are summed the same way in turn."""
    n = x.shape[-1]
    if n <= 32:
        acc = x[..., 0]
        for k in range(1, n):
            acc = acc + x[..., k]
        return acc
    m = -(-n // 32) * 32
    lo = (m - n) // 2
    x = torch.nn.functional.pad(x, (lo, m - n - lo))
    return row_sum(row_sum(x.reshape(x.shape[:-1] + (m // 32, 32))))


def to_histogram_rows(total: torch.Tensor, n_buckets: int = N_BUCKETS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise ``to_histogram_batch`` in float32 (counterpart of
    ``to_histogram_rows_jnp``): total (A, W) -> (probs, edges) (A, nb)."""
    W = total.shape[1]
    lo = total.amin(dim=1)
    hi = total.amax(dim=1)
    zero = f32(0.0, total)
    hi = torch.where(hi <= lo, lo + torch.maximum(
        torch.abs(lo) * f32(1e-3, total), f32(1e-6, total)), hi)
    norm = f32(n_buckets, total) / (hi - lo)
    idx = ((total - lo[:, None]) * norm[:, None]).to(torch.int32)
    idx = torch.clamp(idx, 0, n_buckets - 1)
    cnt = torch.stack([(idx == b).sum(dim=1) for b in range(n_buckets)],
                      dim=1)
    # reciprocal-multiply like the reference (never division by a constant)
    probs = cnt.to(torch.float32) * f32(1.0 / max(W, 1), total)
    frac = torch.arange(1, n_buckets + 1, dtype=torch.float32,
                        device=total.device) * f32(1.0 / n_buckets, total)
    span_frac = torch.maximum((hi - lo)[:, None] * frac[None, :], zero)
    edges = lo[:, None] + span_frac
    edges[:, -1] = hi                    # pin the last edge to hi exactly
    return probs, edges


def gittins_rank_core(probs: torch.Tensor, edges: torch.Tensor,
                      attained: torch.Tensor) -> torch.Tensor:
    """Gittins ranks for a whole queue.

    probs/edges: (J, n) bucket probabilities and right edges (midpoints
    are the bucket values); attained: (J,) service received so far.
    Returns (J,) float32 ranks.  Every candidate Δ is evaluated at once;
    the bucket sums run left to right (see the module docstring)."""
    J, n = probs.shape
    zero = f32(0.0, probs)
    eps = f32(1e-12, probs)
    left = torch.cat([edges[:, :1] * zero
                      + (f32(2.0, probs) * edges[:, :1] - edges[:, 1:2]),
                      edges[:, :-1]], dim=1)
    mids = f32(0.5, probs) * (left + edges)                      # (J, n)
    max_edge = edges[:, -1]
    exhausted = attained >= max_edge                             # outlived
    a = torch.minimum(attained, max_edge * f32(1 - 1e-6, probs))  # (J,)
    alive = mids > a[:, None]                                    # past a
    p_tail = torch.where(alive, probs, zero)
    tail = p_tail[:, 0]
    for b in range(1, n):
        tail = tail + p_tail[:, b]
    p_cond = p_tail / torch.maximum(tail, eps)[:, None]          # (J, n)
    rem = torch.where(alive, mids - a[:, None], zero)            # (J, n)
    # candidate Δ_j = rem[:, j]: column j of e_min / p_le
    e_min = torch.zeros_like(rem)
    p_le = torch.zeros_like(rem)
    for b in range(n):
        rb, pb = rem[:, b:b + 1], p_cond[:, b:b + 1].expand(J, n)
        e_min = fma32(torch.minimum(rb, rem), pb, e_min)
        p_le = p_le + torch.where(rb <= rem, pb, zero)
    ratio = torch.where((p_le > eps) & alive,
                        e_min / torch.maximum(p_le, eps), f32(_INF, probs))
    ranks = ratio.amin(dim=1)
    # a job that outlived every recorded sample carries no hazard
    # information: treat it as a long job (rank grows with attained)
    return torch.where(exhausted, attained, ranks)


def gittins_rank_hist_np(probs: np.ndarray, edges: np.ndarray,
                         attained: np.ndarray) -> np.ndarray:
    """Host entry point: numpy rows in, numpy ranks out (CPU tensors)."""
    return gittins_rank_core(
        torch.tensor(np.asarray(probs, np.float32)),
        torch.tensor(np.asarray(edges, np.float32)),
        torch.tensor(np.asarray(attained, np.float32))).numpy()


def srpt_mean_rank(samples: np.ndarray, attained: float) -> float:
    """Mean-remaining rank (the SRPT-on-the-mean baseline §3.3 argues against).

    Can go negative when a job outlives its expectation — exactly the paper's
    'ironically negative remaining time' failure mode."""
    return float(np.mean(samples) - attained)
