"""Counter-RNG PDGraph walker: RNG primitives and the plain walk.

PyTorch counterpart of ``repro.kernels.pdgraph_walk.ref``.  Every
(walker, step) draws its 32 random bits from the murmur3 finalizer over a
per-walker Weyl counter, so the same bits come out of this plain version,
the CUDA kernel (``csrc/walk_fused.cu``) and the JAX package.

PyTorch on the CPU has no ``>>`` or ``+`` for ``uint32``, so the hash runs
on ``int64`` tensors holding values in ``[0, 2**32)``; products are split
into 16-bit halves so no intermediate leaves the ``int64`` range.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
M1 = 0x85EBCA6B          # murmur3 fmix32 constants
M2 = 0xC2B2AE35
GOLDEN = 0x9E3779B9      # Weyl increment (2**32 / phi)
U16_SCALE = float(np.float32(1.0 / 65536.0))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``x`` in ``[0, 2**32)`` without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer over uint32 values held in an int64 tensor."""
    x = x ^ (x >> 16)
    x = _mul32(x, M1)
    x = x ^ (x >> 13)
    x = _mul32(x, M2)
    return x ^ (x >> 16)


def counter_uniforms(stream: torch.Tensor, ctr: torch.Tensor):
    """Two [0,1) float32 uniforms (16-bit resolution) from one hash of a
    per-walker stream id and a per-step counter."""
    bits = fmix32((stream + _mul32(ctr, GOLDEN)) & MASK32)
    r = (bits >> 16).to(torch.float32) * U16_SCALE
    r2 = (bits & 0xFFFF).to(torch.float32) * U16_SCALE
    return r, r2


def _int64(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def walker_streams(seed, key_ids, refresh_ids,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """Per-(app, refresh) stream ids, ``int64`` in ``[0, 2**32)`` — the
    counter-RNG analogue of the ``fold_in(fold_in(key, key_id), refresh)``
    chain.  ``key_ids`` / ``refresh_ids`` are host arrays or tensors."""
    kid = _int64(key_ids, device) & MASK32
    rid = _int64(refresh_ids, kid.device) & MASK32
    s = fmix32((int(seed) & MASK32) ^ _mul32(kid, GOLDEN))
    return fmix32(s ^ _mul32(rid, M1))


def walk_phase_ref(fsamples: torch.Tensor,     # (G*U, S) float32
                   fcounts: torch.Tensor,      # (G*U,)  float32
                   fcum: torch.Tensor,         # (G*U, U+1) float32
                   fov_samples: Optional[torch.Tensor],  # (A*U, So) float32
                   fov_counts: Optional[torch.Tensor],   # (A*U,)  float32
                   cur: torch.Tensor, total: torch.Tensor, done: torch.Tensor,
                   gi: torch.Tensor, app: torch.Tensor,
                   stream: torch.Tensor, lane: torch.Tensor,
                   executed: Optional[torch.Tensor],
                   *, step0: int, n_steps: int, lanes_per_app: int,
                   arrivals: Optional[torch.Tensor] = None,
                   stats: Optional[dict] = None,
                   fpo_cum: Optional[torch.Tensor] = None,    # (A*U, U+1)
                   fpo_scale: Optional[torch.Tensor] = None):  # (A*U,)
    """One phase of the counter walk over flat walker state (N,).

    Same arithmetic as the JAX twin step for step.  ``cur``/``gi``/``app``
    are int64, ``stream``/``lane`` int64 in ``[0, 2**32)``, ``done`` bool.
    ``executed`` is consumed at global step 0 only.  ``arrivals`` (N, U)
    switches on first-arrival tracking and is updated in place.

    The loop stops once every walker is absorbed: an absorbed walker adds
    exactly ``0.0`` and draws nothing that is kept, so stopping early is
    exact — it takes the place of the reference's phase compaction.  With
    ``stats`` (a dict), ``stats["walker_steps"]`` grows by the steps the
    live walkers took, and ``stats["lane_steps"]``, where the caller put an
    (N,) integer tensor, by each walker's own.

    ``fpo_cum`` / ``fpo_scale`` (per-APP posterior walk tables, flattened
    as ``app * U + unit``; :mod:`repro_torch.core.posterior`) switch on
    posterior sampling: transitions draw against the app's blended CDF and
    every sampled service is rescaled by the unit's demand ratio.  Returns
    ``(cur, total, done)`` or ``(cur, total, done, arrivals)``."""
    U = fcum.shape[1] - 1
    S = fsamples.shape[1]
    fsv = fsamples.reshape(-1)
    with_ov = fov_samples is not None
    if with_ov:
        So = fov_samples.shape[1]
        fov = fov_samples.reshape(-1)
    with_po = fpo_cum is not None
    track = arrivals is not None
    zero = torch.zeros((), dtype=torch.float32, device=total.device)
    for s in range(step0, step0 + n_steps):
        alive = int((~done).sum())
        if alive == 0:
            break
        if stats is not None:
            stats["walker_steps"] = stats.get("walker_steps", 0) + alive
            if "lane_steps" in stats:           # (N,) steps per walker
                stats["lane_steps"] += (~done).to(stats["lane_steps"].dtype)
        ctr = (lane + s * lanes_per_app) & MASK32
        r, r2 = counter_uniforms(stream, ctr)
        row = gi * U + cur
        n_eff = fcounts[row]
        orow = app * U + cur if (with_ov or with_po) else None
        if with_ov:
            oc = fov_counts[orow]
            n_eff = torch.where(oc > 0, oc, n_eff)
        si = torch.floor(r * n_eff).to(torch.int64)
        svc = fsv[row * S + si]
        if with_ov:
            svc = torch.where(
                oc > 0, fov[orow * So + torch.clamp(si, max=So - 1)], svc)
        if with_po:
            # the max consumes the product, so no later add can contract it
            # into a fused multiply-add (the reference's guard)
            svc = torch.maximum(svc * fpo_scale[orow], zero)
        if executed is not None and s == 0:
            svc = torch.maximum(svc - executed, zero)
        total = total + torch.where(done, zero, svc)
        cdf = fpo_cum[orow] if with_po else fcum[row]
        nxt = (r2[:, None] > cdf).sum(dim=1)
        nxt = torch.clamp(nxt, max=U)
        new_done = done | (nxt >= U)
        if track:
            # entry into `nxt` happens when the current unit completes — at
            # the just-updated total; min keeps the first entry (loops)
            enter = torch.nonzero((~done) & (nxt < U)).squeeze(1)
            col = nxt[enter]
            arrivals[enter, col] = torch.minimum(arrivals[enter, col],
                                                 total[enter])
        cur = torch.where(new_done, cur, nxt)
        done = new_done
    return (cur, total, done, arrivals) if track else (cur, total, done)
