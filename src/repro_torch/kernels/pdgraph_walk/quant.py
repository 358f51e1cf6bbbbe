"""Lossless 16-bit quantized walk tables for the plain (CPU) walk.

The port of the JAX package's ``kernels/pdgraph_walk/quant.py``.  The
counter RNG yields exactly 2**16 distinct values per uniform (``r = k *
2**-16`` with ``k`` the high or low 16 bits of one ``fmix32`` hash), so
every data-dependent lookup the walk makes from ``r`` / ``r2`` can be
precomputed EXACTLY over all 65,536 lattice points per (graph, unit) row:

* ``qsv[row, k]  = fsamples[row, floor((k * 2**-16) * counts[row])]`` —
  the demand sample the walk would gather for high bits ``k`` (float32,
  ``(G*U, 65536)``);
* ``icdf[row, k] = sum((k * 2**-16) > cum_trans[row, :])`` — the next
  unit the walk would derive for low bits ``k`` (uint8).

Each walk step is then two flat gathers instead of a gather chain and an
``(N, U+1)`` compare-reduce, and stays bit-identical to ``walk_phase_ref``
because every entry is the exact value its arithmetic gives for those
bits.  Per-app sample overrides change ``n_eff`` per app, so an override
walk takes the plain step (the caller gates).  Posterior walks use the
tables in mixed form: the service lookup still quantizes (the posterior
scale multiplies the same sample), while transitions compare against the
app's posterior CDF row as the plain step does.

Only the CPU walk reads them: the walk kernels on the card (K1, K2) do
not, and nothing builds them there.  PyTorch on the CPU has no ``>>`` for
``uint32``, so the lattice index is computed on the walk's int64 hash
values and masked.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch

from repro_torch.kernels.pdgraph_walk.ref import (GOLDEN, MASK32, U16_SCALE,
                                                  _mul32, fmix32)

_N_QUANT = 1 << 16
_ROWS_A_CHUNK = 16          # (G*U) rows compared against the CDF at once


def build_quant_tables(samples: torch.Tensor,      # (G, U, S) float32
                       counts: torch.Tensor,       # (G, U)
                       cum_trans: torch.Tensor     # (G, U, U+1) float32
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(qsv (G*U*65536,) float32, icdf (G*U*65536,) uint8)``."""
    G, U, S = samples.shape
    dev = samples.device
    fsv = samples.reshape(G * U, S).float()
    fcounts = counts.reshape(G * U).float()
    fcum = cum_trans.reshape(G * U, U + 1).float()
    r = torch.arange(_N_QUANT, device=dev).float() * U16_SCALE  # exact
    si = torch.floor(r[None, :] * fcounts[:, None]).long()
    rows = torch.arange(G * U, device=dev)[:, None]
    qsv = fsv.reshape(-1)[rows * S + si]                        # (GU, 65536)
    icdf = torch.cat([(r[None, :, None] > fcum[i:i + _ROWS_A_CHUNK, None, :]
                       ).sum(-1).to(torch.uint8)
                      for i in range(0, G * U, _ROWS_A_CHUNK)])
    return qsv.reshape(-1), icdf.reshape(-1)


# a few packed KBs by identity (the arena paths hold one PackedKB for the
# process lifetime); each entry keeps its samples tensor alive, so an id is
# never reused while it is a key
_CACHE: "OrderedDict[int, tuple]" = OrderedDict()
_CACHE_SIZE = 4


def quant_tables(samples, counts, cum_trans
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``build_quant_tables`` memoised by the identity of ``samples``."""
    key = id(samples)
    hit = _CACHE.get(key)
    if hit is None:
        hit = (build_quant_tables(samples, counts, cum_trans), samples)
        _CACHE[key] = hit
        if len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(key)
    return hit[0]


def walk_phase_quant(qsv: torch.Tensor,          # (G*U*65536,) float32
                     icdf: torch.Tensor,         # (G*U*65536,) uint8
                     cur: torch.Tensor, total: torch.Tensor,
                     done: torch.Tensor, gi: torch.Tensor, app: torch.Tensor,
                     stream: torch.Tensor, lane: torch.Tensor,
                     executed: Optional[torch.Tensor],
                     *, n_units: int, step0: int, n_steps: int,
                     lanes_per_app: int,
                     arrivals: Optional[torch.Tensor] = None,
                     stats: Optional[dict] = None,
                     fpo_cum: Optional[torch.Tensor] = None,    # (A*U, U+1)
                     fpo_scale: Optional[torch.Tensor] = None):  # (A*U,)
    """One walk phase over flat state through the quantized tables.

    Bit-identical to ``ref.walk_phase_ref`` without overrides: the same
    ``fmix32`` bits index the precomputed lookups.  Its arguments are
    ``walk_phase_ref``'s without the sample and override tables, plus the
    unit count; it stops once every walker is absorbed and keeps ``stats``
    as that function does.  Returns ``(cur, total, done[, arrivals])``."""
    U = n_units
    with_po = fpo_cum is not None
    track = arrivals is not None
    zero = torch.zeros((), dtype=torch.float32, device=total.device)
    for s in range(step0, step0 + n_steps):
        alive = int((~done).sum())
        if alive == 0:
            break
        if stats is not None:
            stats["walker_steps"] = stats.get("walker_steps", 0) + alive
            if "lane_steps" in stats:
                stats["lane_steps"] += (~done).to(stats["lane_steps"].dtype)
        ctr = (lane + s * lanes_per_app) & MASK32
        bits = fmix32((stream + _mul32(ctr, GOLDEN)) & MASK32)
        base = (gi * U + cur) * _N_QUANT
        svc = qsv[base + (bits >> 16)]
        if with_po:
            orow = app * U + cur
            # the max consumes the product, so no later add can contract it
            svc = torch.maximum(svc * fpo_scale[orow], zero)
        if executed is not None and s == 0:
            svc = torch.maximum(svc - executed, zero)
        total = total + torch.where(done, zero, svc)
        if with_po:
            r2 = (bits & 0xFFFF).to(torch.float32) * U16_SCALE
            nxt = (r2[:, None] > fpo_cum[orow]).sum(dim=1)
        else:
            nxt = icdf[base + (bits & 0xFFFF)].long()
        nxt = torch.clamp(nxt, max=U)
        new_done = done | (nxt >= U)
        if track:
            enter = torch.nonzero((~done) & (nxt < U)).squeeze(1)
            col = nxt[enter]
            arrivals[enter, col] = torch.minimum(arrivals[enter, col],
                                                 total[enter])
        cur = torch.where(new_done, cur, nxt)
        done = new_done
    return (cur, total, done, arrivals) if track else (cur, total, done)
