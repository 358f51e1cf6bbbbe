"""Public entry point of the fused PDGraph walk: walk → demand-histogram
rows → Gittins ranks (→ arrival-histogram rows), one call.

PyTorch counterpart of ``repro.kernels.pdgraph_walk.ops.pdgraph_walk_ranked``
with the same arguments and the same returned dict.  Dispatch follows the
device of the tables: a CUDA tensor launches the hand-written kernel
(``kernel.pdgraph_walk_fused_kernel``), a CPU tensor takes the plain PyTorch
version :func:`pdgraph_walk_ranked_plain`.  A CUDA input never falls back to
the plain version.

The plain version walks single-phase and stops once every walker is
absorbed (exact — absorbed walkers add ``0.0``), which takes the place of
the reference's phase compaction and of its quantized CPU step tables; the
spill count is therefore always 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.gittins import (f32, gittins_rank_core,
                                      to_histogram_rows)
from repro_torch.core.pdgraph import ARRIVAL_NEVER, _pow2_ceil
from repro_torch.kernels.pdgraph_walk import kernel as _kernel
from repro_torch.kernels.pdgraph_walk.ref import walk_phase_ref

_POSTERIOR_TODO = ("posterior-blended walk tables are not ported yet: "
                   "ROADMAP.md, modules to port, item 7")


def pad_rows(n: int, min_rows: int = 1) -> int:
    """Quantized dispatch-row padding: ``n`` rounded up to the next multiple
    of ``pow2_ceil(n) / 8`` (plain power of two at or below 64)."""
    n = max(n, min_rows, 1)
    p = _pow2_ceil(n)
    if n <= 64:
        return p
    q = p // 8
    return ((n + q - 1) // q) * q


def arrival_hists(arr: torch.Tensor, n_buckets: int):
    """Per-walker first-arrival times (A, W, U) -> per-(app, unit) arrival
    histograms ``(hist (A, U, nb), lo (A, U), span (A, U), n_reach (A, U))``
    — the counterpart of ``refresh_pipeline._arrival_hists``."""
    never = f32(ARRIVAL_NEVER, arr)
    reached = arr < f32(ARRIVAL_NEVER / 2, arr)              # (A, W, U)
    n_reach = reached.sum(dim=1).to(torch.float32)            # (A, U)
    lo = torch.where(reached, arr, never).amin(dim=1)         # (A, U)
    hi = torch.where(reached, arr, -never).amax(dim=1)
    span = torch.maximum(hi - lo, f32(1e-6, arr))
    scale = f32(n_buckets, arr) / span
    # unreached walkers are masked below; give them an in-range value so the
    # float -> int conversion never sees the sentinel
    arr_r = torch.where(reached, arr, lo[:, None, :])
    idx = ((arr_r - lo[:, None, :]) * scale[:, None, :]).to(torch.int32)
    idx = torch.clamp(idx, 0, n_buckets - 1)
    hist = torch.stack([((idx == b) & reached).sum(dim=1)
                        for b in range(n_buckets)], dim=-1)
    return hist.to(torch.float32), lo, span, n_reach


def pdgraph_walk_ranked_plain(samples, counts, cum_trans, graph_idx, start,
                              executed, streams, attained,
                              ov_samples=None, ov_counts=None, *,
                              valid=None, n_walkers: int = 512,
                              max_steps: int = 64, n_buckets: int = 10,
                              track_arrivals: bool = False,
                              with_rank: bool = True,
                              with_total: bool = False):
    """The plain PyTorch version of the fused walk, on any device.  Its
    dict also holds ``walker_steps``, the steps the walkers took before
    absorption (what the walk's work depends on)."""
    dev = samples.device
    A = graph_idx.shape[0]
    G, U, S = samples.shape
    W = n_walkers
    N = A * W
    flat_s = samples.reshape(G * U, S)
    flat_c = counts.reshape(G * U).to(torch.float32)
    flat_cum = cum_trans.reshape(G * U, U + 1)
    with_ov = ov_samples is not None
    fov_s = ov_samples.reshape(A * U, -1) if with_ov else None
    fov_c = ov_counts.reshape(A * U).to(torch.float32) if with_ov else None
    rep = lambda t: torch.repeat_interleave(t, W)  # noqa: E731
    gi = rep(graph_idx.to(torch.int64))
    app = rep(torch.arange(A, device=dev))
    lane = torch.arange(W, device=dev).repeat(A)
    done0 = (torch.zeros(N, dtype=torch.bool, device=dev) if valid is None
             else rep(~valid.to(torch.bool)))
    arr = (torch.full((N, U), ARRIVAL_NEVER, dtype=torch.float32, device=dev)
           if track_arrivals else None)
    stats = {"walker_steps": 0}
    out = walk_phase_ref(
        flat_s, flat_c, flat_cum, fov_s, fov_c,
        rep(start.to(torch.int64)),
        torch.zeros(N, dtype=torch.float32, device=dev), done0,
        gi, app, rep(streams.to(torch.int64)), lane,
        rep(executed.to(torch.float32)),
        step0=0, n_steps=max_steps, lanes_per_app=W, arrivals=arr,
        stats=stats)
    rem = out[1].reshape(A, W)
    att = attained.to(torch.float32)
    total = att[:, None] + torch.maximum(rem, f32(0.0, rem))
    res = {"total": total if with_total else None,
           "spill": torch.zeros((), dtype=torch.int32, device=dev),
           "probs": None, "edges": None, "ranks": None,
           "walker_steps": stats["walker_steps"]}
    if with_rank:
        probs, edges = to_histogram_rows(total, n_buckets)
        res.update(probs=probs, edges=edges,
                   ranks=gittins_rank_core(probs, edges, att))
    if track_arrivals:
        a_hist, a_lo, a_span, a_reach = arrival_hists(
            out[3].reshape(A, W, U), n_buckets)
        res.update(a_hist=a_hist, a_lo=a_lo, a_span=a_span, a_reach=a_reach)
    return res


def kernel_operands(samples, counts, cum_trans, graph_idx, start, executed,
                    streams, attained, ov_samples=None, ov_counts=None,
                    valid=None):
    """The operands of ``kernel.pdgraph_walk_fused_kernel``, in its order,
    converted to the dtypes and layouts it checks for."""
    A = graph_idx.shape[0]
    U = samples.shape[1]
    with_ov = ov_samples is not None
    dev = samples.device
    i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()  # noqa: E731
    fl = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    s64 = streams.to(device=dev, dtype=torch.int64)
    valid_u8 = (torch.ones(A, dtype=torch.uint8, device=dev) if valid is None
                else valid.to(device=dev, dtype=torch.uint8).contiguous())
    return (fl(samples), fl(counts), fl(cum_trans),
            fl(ov_samples.reshape(A * U, -1)) if with_ov else None,
            fl(ov_counts.reshape(A * U)) if with_ov else None,
            fl(attained), i32(start), i32(graph_idx),
            # uint32 bit patterns carried in an int32 tensor
            torch.where(s64 >= 2 ** 31, s64 - 2 ** 32, s64).to(torch.int32),
            fl(executed), valid_u8)


def pdgraph_walk_ranked(samples: torch.Tensor,     # (G, U, S) float32
                        counts: torch.Tensor,      # (G, U) int32
                        cum_trans: torch.Tensor,   # (G, U, U+1) float32
                        graph_idx: torch.Tensor,   # (A,)
                        start: torch.Tensor,       # (A,)
                        executed: torch.Tensor,    # (A,)
                        streams: torch.Tensor,     # (A,) int64 in [0, 2**32)
                        attained: torch.Tensor,    # (A,)
                        ov_samples: Optional[torch.Tensor] = None,  # (A,U,So)
                        ov_counts: Optional[torch.Tensor] = None,   # (A, U)
                        *, valid: Optional[torch.Tensor] = None,    # (A,) bool
                        n_walkers: int = 512, max_steps: int = 64,
                        n_buckets: int = 10,
                        track_arrivals: bool = False,
                        with_rank: bool = True, with_total: bool = False,
                        po_cum=None, po_scale=None):
    """One-pass walk → demand-histogram rows → Gittins ranks (→ arrival
    histogram rows).

    Returns a dict with ``probs (A, nb)``, ``edges (A, nb)``, ``ranks (A,)``
    (``None`` unless ``with_rank``), ``total (A, W)`` (``None`` unless
    ``with_total``), ``spill`` and, with ``track_arrivals``, ``a_hist
    (A, U, nb)``, ``a_lo / a_span / a_reach (A, U)``."""
    if po_cum is not None or po_scale is not None:
        raise NotImplementedError(_POSTERIOR_TODO)
    kw = dict(valid=valid, n_walkers=n_walkers, max_steps=max_steps,
              n_buckets=n_buckets, track_arrivals=track_arrivals,
              with_rank=with_rank, with_total=with_total)
    if samples.device.type == "cpu":
        return pdgraph_walk_ranked_plain(
            samples, counts, cum_trans, graph_idx, start, executed, streams,
            attained, ov_samples, ov_counts, **kw)
    out = _kernel.pdgraph_walk_fused_kernel(
        *kernel_operands(samples, counts, cum_trans, graph_idx, start,
                         executed, streams, attained, ov_samples, ov_counts,
                         valid),
        n_walkers=n_walkers, max_steps=max_steps, n_buckets=n_buckets,
        with_arrivals=track_arrivals, with_total=with_total)
    dev = samples.device
    A, U = graph_idx.shape[0], samples.shape[1]
    res = {"probs": out["probs"] if with_rank else None,
           "edges": out["edges"] if with_rank else None,
           "ranks": out["ranks"] if with_rank else None,
           "total": None,
           "spill": torch.zeros((), dtype=torch.int32, device=dev)}
    if with_total:
        rem = out["rem"]
        att = attained.to(device=dev, dtype=torch.float32)
        res["total"] = att[:, None] + torch.maximum(rem, f32(0.0, rem))
    if track_arrivals:
        st = out["arrstats"].reshape(A, U, n_buckets + 3)
        res.update(a_hist=st[..., :n_buckets], a_lo=st[..., n_buckets],
                   a_span=st[..., n_buckets + 1],
                   a_reach=st[..., n_buckets + 2])
    return res
