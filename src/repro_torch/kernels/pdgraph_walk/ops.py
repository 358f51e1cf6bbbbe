"""Public entry points of the PDGraph walk.

PyTorch counterpart of ``repro.kernels.pdgraph_walk.ops`` with the same
arguments and results:

* :func:`pdgraph_walk` — the walk alone: ``(A, W)`` remaining-service
  totals (and first-arrival times) with phase compaction between walk
  phases, the spilled-walker count surfaced.  Each phase of a CUDA input is
  one launch of the per-phase kernel (``kernel.pdgraph_walk_kernel``); a
  CPU input takes the plain version (``ref.walk_phase_ref``).
* :func:`pdgraph_walk_ranked` — walk → demand-histogram rows → Gittins
  ranks (→ arrival-histogram rows) in one call.  A CUDA input launches the
  fused kernel (``kernel.pdgraph_walk_fused_kernel``), single-phase; a CPU
  input takes :func:`pdgraph_walk_ranked_plain`, which compacts with
  :func:`walk_schedule` exactly as the reference's CPU twin does.

Compaction is exact — the counter RNG is indexed by (stream, original lane,
global step) — so single-phase and compacted walks return the same bits
unless a compaction stage spills, and then the spilled walkers keep their
partial totals and ``spill`` counts them, as in the reference.  A CUDA
input never falls back to a plain version.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.gittins import (f32, gittins_rank_core,
                                      to_histogram_rows)
from repro_torch.core.pdgraph import ARRIVAL_NEVER, _pow2_ceil
from repro_torch.kernels.pdgraph_walk import kernel as _kernel
from repro_torch.kernels.pdgraph_walk.quant import walk_phase_quant
from repro_torch.kernels.pdgraph_walk.ref import walk_phase_ref


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


def walk_schedule(compact_after: int, compact_shrink: int,
                  n_lanes: int) -> Tuple[Tuple[int, int], ...]:
    """Lane-count-gated multi-stage compaction schedule: three stages
    ``(12, 4), (28, 16), (44, 64)`` from 16,384 lanes up at the default
    knobs, the single ``(compact_after, compact_shrink)`` stage below; a
    tuned single stage gets one 4x-shrink tail stage; compaction switched
    off (shrink <= 1 or step <= 0) stays off."""
    if compact_shrink <= 1 or compact_after <= 0:
        return ((compact_after, compact_shrink),)      # off stays off
    if (compact_after, compact_shrink) != (16, 4):
        return ((compact_after, compact_shrink),
                (compact_after * 2, compact_shrink * 4))
    if n_lanes >= 16384:
        return ((12, 4), (28, 16), (44, 64))
    return ((compact_after, compact_shrink),)


def _stages(schedule: Sequence[Tuple[int, int]], max_steps: int,
            n_lanes: int):
    """The stages that stay on: ascending in step and shrink, inside
    ``(0, max_steps)``, each keeping at least 128 lanes; the others switch
    themselves off, as the reference's gate does."""
    stages = []
    prev_step, prev_shrink = 0, 1
    for step, shrink in schedule:
        if step <= prev_step or step >= max_steps:
            continue
        if shrink <= prev_shrink or n_lanes // shrink < 128:
            continue
        stages.append((step, shrink))
        prev_step, prev_shrink = step, shrink
    return stages


def _walk(samples, counts, cum_trans, graph_idx, start, executed, streams,
          ov_samples, ov_counts, *, valid, n_walkers, max_steps, schedule,
          track_arrivals, po_cum, po_scale, plain, stats=None, quant=None):
    """The compacted walk; each phase runs the kernel (``plain=False``,
    CUDA tensors) or ``walk_phase_ref`` — ``quant.walk_phase_quant`` where
    ``quant`` holds the quantized tables and no overrides are given.
    Returns ``(total (N,), arrivals (N, U) | None, spill)``."""
    dev = samples.device
    A = graph_idx.shape[0]
    G, U, S = samples.shape
    W = n_walkers
    N = A * W
    it = torch.int64 if plain else torch.int32
    fl = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    tables = (fl(samples), fl(counts), fl(cum_trans))
    with_ov = ov_samples is not None
    ov = ((fl(ov_samples.reshape(A * U, -1)), fl(ov_counts.reshape(A * U)))
          if with_ov else (None, None))
    po = ((fl(po_cum.reshape(A * U, U + 1)), fl(po_scale.reshape(A * U)))
          if po_cum is not None else (None, None))
    rep = lambda t, dt: torch.repeat_interleave(  # noqa: E731
        t.to(device=dev, dtype=dt), W)
    cur = rep(start, it)
    gi = rep(graph_idx, it)
    app = torch.arange(A, device=dev, dtype=it).repeat_interleave(W)
    lane = torch.arange(W, device=dev, dtype=it).repeat(A)
    stream = rep(streams, torch.int64)
    if not plain:                    # uint32 bit patterns in an int32 tensor
        stream = torch.where(stream >= 2 ** 31, stream - 2 ** 32,
                             stream).to(torch.int32)
    done = (torch.zeros(N, dtype=torch.bool, device=dev) if valid is None
            else rep(~valid.to(device=dev, dtype=torch.bool), torch.bool))
    total = torch.zeros(N, dtype=torch.float32, device=dev)
    ex = rep(executed, torch.float32)
    # first-arrival times: (N, U) for the plain walk, (U, N) for the kernel
    lane_dim = 0 if plain else 1
    arr = None
    if track_arrivals:
        shape = (N, U) if plain else (U, N)
        arr = torch.full(shape, ARRIVAL_NEVER, dtype=torch.float32,
                         device=dev)

    def phase(step0, n_steps):
        if plain and quant is not None and not with_ov:
            out = walk_phase_quant(
                *quant, cur, total, done, gi, app, stream, lane, ex,
                n_units=U, step0=step0, n_steps=n_steps, lanes_per_app=W,
                arrivals=arr, stats=stats, fpo_cum=po[0], fpo_scale=po[1])
        elif plain:
            out = walk_phase_ref(
                tables[0].reshape(G * U, S), tables[1].reshape(G * U),
                tables[2].reshape(G * U, U + 1), ov[0], ov[1], cur, total,
                done, gi, app, stream, lane, ex, step0=step0,
                n_steps=n_steps, lanes_per_app=W, arrivals=arr, stats=stats,
                fpo_cum=po[0], fpo_scale=po[1])
        else:
            out = _kernel.pdgraph_walk_kernel(
                *tables, *ov, *po, cur, total, done, gi, app, stream, lane,
                ex, arr, step0=step0, n_steps=n_steps, lanes_per_app=W,
                n_apps=A)
        return out if track_arrivals else out + (None,)

    spill = torch.zeros((), dtype=torch.int32, device=dev)
    unwind = []                      # (totals, arrivals, keep) per level
    seg_start = 0
    for step_b, shrink in _stages(schedule, max_steps, N) + [(max_steps,
                                                             None)]:
        cur, total, done, arr = phase(seg_start, step_b - seg_start)
        if shrink is None:
            break
        C = N // shrink
        keep = torch.argsort(done.to(torch.int32), stable=True)[:C]
        spill = spill + torch.clamp((~done).sum() - C, min=0).to(torch.int32)
        unwind.append((total, arr, keep))
        cur, done, gi, app = cur[keep], done[keep], gi[keep], app[keep]
        stream, lane, total = stream[keep], lane[keep], total[keep]
        if arr is not None:
            arr = arr.index_select(lane_dim, keep)
        ex = None                                         # step 0 only
        seg_start = step_b
    # unwind: each level's kept lanes take the deeper totals; spilled lanes
    # keep their partial (pre-compaction) totals
    for total_prev, arr_prev, keep in reversed(unwind):
        total_prev[keep] = total
        total = total_prev
        if arr is not None:
            arr = arr_prev.index_copy(lane_dim, keep, arr)
    if arr is not None and not plain:
        arr = arr.t()
    return total, arr, spill


def pdgraph_walk(samples: torch.Tensor,        # (G, U, S)
                 counts: torch.Tensor,         # (G, U)
                 cum_trans: torch.Tensor,      # (G, U, U+1)
                 graph_idx: torch.Tensor,      # (A,)
                 start: torch.Tensor,          # (A,)
                 executed: torch.Tensor,       # (A,)
                 streams: torch.Tensor,        # (A,) int64 in [0, 2**32)
                 ov_samples: Optional[torch.Tensor] = None,   # (A, U, So)
                 ov_counts: Optional[torch.Tensor] = None,    # (A, U)
                 *, valid: Optional[torch.Tensor] = None,     # (A,) bool
                 n_walkers: int = 512, max_steps: int = 64,
                 compact_after: int = 16, compact_shrink: int = 4,
                 compact_schedule: Optional[Sequence[Tuple[int, int]]] = None,
                 track_arrivals: bool = False,
                 po_cum: Optional[torch.Tensor] = None,       # (A, U, U+1)
                 po_scale: Optional[torch.Tensor] = None):    # (A, U)
    """Remaining-service totals for A apps: ``((A, W), spill)``, or
    ``((A, W), (A, W, U), spill)`` with ``track_arrivals``.

    ``compact_schedule`` is a tuple of ``(step, shrink)`` stages, each
    packing the surviving walkers into an ``N // shrink``-lane state at
    ``step``; ``None`` is ``((compact_after, compact_shrink),)``.  Stages
    that break monotonicity, reach ``max_steps`` or keep fewer than 128
    lanes switch themselves off.  ``valid`` marks real rows: padding rows
    start absorbed.  ``po_cum`` / ``po_scale`` switch on posterior sampling;
    on a CUDA input the walk then runs single-phase, as the reference's
    kernel path does."""
    plain = samples.device.type == "cpu"
    if compact_schedule is None:
        compact_schedule = ((compact_after, compact_shrink),)
    if po_cum is not None and not plain:
        compact_schedule = ()
    total, arr, spill = _walk(
        samples, counts, cum_trans, graph_idx, start, executed, streams,
        ov_samples, ov_counts, valid=valid, n_walkers=n_walkers,
        max_steps=max_steps, schedule=compact_schedule,
        track_arrivals=track_arrivals, po_cum=po_cum, po_scale=po_scale,
        plain=plain)
    A, W, U = graph_idx.shape[0], n_walkers, samples.shape[1]
    if track_arrivals:
        return total.reshape(A, W), arr.reshape(A, W, U), spill
    return total.reshape(A, W), spill


def pdgraph_walk_ranked_plain(samples, counts, cum_trans, graph_idx, start,
                              executed, streams, attained,
                              ov_samples=None, ov_counts=None, *,
                              valid=None, n_walkers: int = 512,
                              max_steps: int = 64, n_buckets: int = 10,
                              compact_schedule=None,
                              track_arrivals: bool = False,
                              with_rank: bool = True,
                              with_total: bool = False,
                              po_cum=None, po_scale=None, quant=None):
    """The plain PyTorch version of the fused walk, on any device.  It
    compacts with ``compact_schedule`` (``None``: :func:`walk_schedule` of
    the default knobs and the lane count, as the reference's CPU twin;
    ``()``: single-phase, as the kernel).  Its dict also holds ``walker_steps``, the
    steps the walkers took before absorption (what the walk's work depends
    on)."""
    A = graph_idx.shape[0]
    U = samples.shape[1]
    W = n_walkers
    if compact_schedule is None:
        compact_schedule = walk_schedule(16, 4, A * W)
    stats = {"walker_steps": 0}
    rem, arr, spill = _walk(
        samples, counts, cum_trans, graph_idx, start, executed, streams,
        ov_samples, ov_counts, valid=valid, n_walkers=W,
        max_steps=max_steps, schedule=compact_schedule,
        track_arrivals=track_arrivals, po_cum=po_cum, po_scale=po_scale,
        plain=True, stats=stats, quant=quant)
    rem = rem.reshape(A, W)
    att = attained.to(device=samples.device, dtype=torch.float32)
    total = att[:, None] + torch.maximum(rem, f32(0.0, rem))
    res = {"total": total if with_total else None, "spill": spill,
           "probs": None, "edges": None, "ranks": None,
           "walker_steps": stats["walker_steps"]}
    if with_rank:
        probs, edges = to_histogram_rows(total, n_buckets)
        res.update(probs=probs, edges=edges,
                   ranks=gittins_rank_core(probs, edges, att))
    if track_arrivals:
        a_hist, a_lo, a_span, a_reach = arrival_hists(
            arr.reshape(A, W, U), n_buckets)
        res.update(a_hist=a_hist, a_lo=a_lo, a_span=a_span, a_reach=a_reach)
    return res


def kernel_operands(samples, counts, cum_trans, graph_idx, start, executed,
                    streams, attained, ov_samples=None, ov_counts=None,
                    valid=None, po_cum=None, po_scale=None):
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
            fl(executed), valid_u8,
            fl(po_cum.reshape(A * U, U + 1)) if po_cum is not None else None,
            fl(po_scale.reshape(A * U)) if po_cum is not None else None)


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
                        po_cum: Optional[torch.Tensor] = None,  # (A, U, U+1)
                        po_scale: Optional[torch.Tensor] = None,  # (A, U)
                        quant: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None):
    """One-pass walk → demand-histogram rows → Gittins ranks (→ arrival
    histogram rows).

    Returns a dict with ``probs (A, nb)``, ``edges (A, nb)``, ``ranks (A,)``
    (``None`` unless ``with_rank``), ``total (A, W)`` (``None`` unless
    ``with_total``), ``spill`` (a host 0 on the kernel path) and, with ``track_arrivals``, ``a_hist
    (A, U, nb)``, ``a_lo / a_span / a_reach (A, U)``.  ``po_cum`` /
    ``po_scale`` switch on posterior sampling.  ``quant``: the quantized
    step tables (``quant.quant_tables``), which the CPU version reads where
    no overrides are given (the reference's CPU twin); the kernel does not
    read them."""
    if samples.device.type == "cpu":
        return pdgraph_walk_ranked_plain(
            samples, counts, cum_trans, graph_idx, start, executed, streams,
            attained, ov_samples, ov_counts, valid=valid,
            n_walkers=n_walkers, max_steps=max_steps, n_buckets=n_buckets,
            track_arrivals=track_arrivals, with_rank=with_rank,
            with_total=with_total, po_cum=po_cum, po_scale=po_scale,
            quant=quant)
    out = _kernel.pdgraph_walk_fused_kernel(
        *kernel_operands(samples, counts, cum_trans, graph_idx, start,
                         executed, streams, attained, ov_samples, ov_counts,
                         valid, po_cum, po_scale),
        n_walkers=n_walkers, max_steps=max_steps, n_buckets=n_buckets,
        with_arrivals=track_arrivals, with_total=with_total)
    dev = samples.device
    A, U = graph_idx.shape[0], samples.shape[1]
    res = {"probs": out["probs"] if with_rank else None,
           "edges": out["edges"] if with_rank else None,
           "ranks": out["ranks"] if with_rank else None,
           "total": None,
           # single-phase: nothing spills, and a host 0 costs the caller
           # no device read
           "spill": 0}
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
