"""Device-resident fused refresh pipeline (§3.3 hot path, Fig. 15).

PyTorch counterpart of ``repro.core.refresh_pipeline``, with its two
walkers:

* ``walker="pallas"``, the counter-RNG walk kernels: with
  ``rank_in_kernel=True`` (the default) one fused walk kernel (walk →
  histogram rows → rank → arrival rows) per dispatch; with
  ``rank_in_kernel=False`` the per-phase walk kernel with compaction
  between phases (``pdgraph_walk``), then histogram rows, ranks and
  arrival rows in PyTorch.  Both give the same bits unless a compaction
  stage spills.
* ``walker="threefry"``, the composed path's host-sample walker
  (:func:`repro_torch.core.pdgraph._mc_walk_batch`) keyed by the
  ``fold_in`` chain from ``base_key``, then the same reductions: the
  reference's threefry samples bit for bit, so the fused ranks match the
  composed and looped modes.

Either way the rows are scattered into the slot arena, every slot is
re-ranked in place and the prewarm triggers are derived on the device; only
small per-app results cross to the host.

* :func:`refresh_ranks_fused` — one fused refresh over a slot subset (the
  first tick and ``mode="fused"``).
* :func:`refresh_ranks_delta` — the delta tick: walk only the dirty slots,
  scatter their rows into the arena, re-rank every slot in place, and
  re-condition every prewarm trigger on the service attained since its
  walk.  With ``posterior`` each walked row's posterior row is blended with
  the prior into its walk tables (:mod:`repro_torch.core.posterior`).

On a CPU arena every kernel call takes its plain version, and the fused
walk (``rank_in_kernel``) steps through the lossless 16-bit lookup tables
of :mod:`repro_torch.kernels.pdgraph_walk.quant` where no overrides are
given, as the reference's CPU twin does, with the same bits.  The sharded
arena's tick lives in :mod:`repro_torch.core.refresh_mesh` and runs this
module's walk section once per shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.arena import QueueState
from repro_torch.core.gittins import (N_BUCKETS, f32, fma32,
                                      gittins_rank_core, row_sum,
                                      to_histogram_rows)
from repro_torch.core.pdgraph import ARRIVAL_NEVER, PackedKB, _mc_walk_batch
from repro_torch.core.policies import HOPELESS_Q, SUP_Q
from repro_torch.core.posterior import posterior_tables, prior_mean
from repro_torch.kernels.pdgraph_walk.ops import (arrival_hists,
                                                  pdgraph_walk,
                                                  pdgraph_walk_ranked)
from repro_torch.kernels.pdgraph_walk.quant import quant_tables
from repro_torch.kernels.pdgraph_walk.ref import walker_streams


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None], -1)[..., 0]``."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _triggers_from_hists(hist, lo, span, n_reach, n_walkers, delta,
                         uc, class_warmup, K, stretch):
    """Arrival histograms -> per-(app, backend-class) prewarm triggers,
    conditioned on ``delta`` seconds of service attained since the walk.

    hist/lo/span/n_reach: (A, U, nb) / (A, U); delta, stretch: (A,);
    uc: (A, U, Kc) int class ids (-1 = none); class_warmup: (B,); K: knob.
    Returns ``(trigger (A, B), reach (A, B))`` with ARRIVAL_NEVER marking
    "do not prewarm" — the same float32 values as
    ``repro.core.refresh_pipeline._triggers_from_hists`` compiled by XLA on
    the CPU, which divides by the bucket count as a multiply by its
    reciprocal and fuses each ``x + y * z`` into one fused multiply-add;
    both are spelled out here (:func:`fma32`)."""
    n_buckets = hist.shape[-1]
    B = class_warmup.shape[0]
    zero, one = f32(0.0, hist), f32(1.0, hist)
    never = f32(ARRIVAL_NEVER, hist)
    K = f32(K, hist)
    denom = torch.maximum(n_reach, one)
    cdf = torch.cumsum(hist, dim=-1) / denom[..., None]     # (A, U, nb)
    width = span * f32(1.0 / n_buckets, hist)

    # survivor mass above delta: interpolated CDF at delta, exactly 0 when
    # delta <= lo so the delta=0 path multiplies/adds only exact values
    pos = (delta[:, None] - lo) / width                     # bucket units
    # clamp before the conversion: XLA's float -> int saturates, C's is
    # undefined out of range
    jb = torch.clamp(torch.clamp(pos, -1.0, float(n_buckets)).to(torch.int64),
                     0, n_buckets - 1)
    cdf_jb_prev = torch.where(jb > 0, _take(cdf, torch.clamp(jb - 1, min=0)),
                              zero)
    p_jb = _take(hist, jb) / denom
    frac_d = torch.clamp(pos - jb.to(torch.float32), 0.0, 1.0)
    cdf_at = torch.where(delta[:, None] <= lo, zero,
                         fma32(p_jb, frac_d, cdf_jb_prev))
    surv = torch.maximum(one - cdf_at, zero)

    p_reach = (n_reach * surv) / f32(n_walkers, hist)      # conditioned
    ok = p_reach >= K                                       # coverage gate
    q = torch.clamp(one - K / torch.maximum(p_reach, f32(1e-9, hist)),
                    0.0, 1.0)
    q_abs = fma32(surv, q, cdf_at)     # target mass in unconditioned coords

    # quantile: first bucket whose CDF reaches q_abs, linearly interpolated
    k = torch.argmax((cdf >= (q_abs[..., None] - f32(1e-7, hist)))
                     .to(torch.int32), dim=-1)              # (A, U)
    cdf_prev = torch.where(k > 0, _take(cdf, torch.clamp(k - 1, min=0)),
                           zero)
    p_k = _take(hist, k) / denom
    frac = torch.clamp((q_abs - cdf_prev) / torch.maximum(p_k,
                                                          f32(1e-9, hist)),
                       0.0, 1.0)
    qtile = fma32(k.to(torch.float32) + frac, width, lo)    # (A, U)
    qtile = (qtile - delta[:, None]) * stretch[:, None]

    # scatter-min into backend classes
    cand = qtile[..., None] - class_warmup[torch.clamp(uc, min=0)]
    gate = ok[..., None] & (uc >= 0)
    cls = uc[..., None] == torch.arange(B, device=uc.device)  # (A,U,Kc,B)
    hit = cls & gate[..., None]
    trigger = torch.where(hit, cand[..., None], never).amin(dim=(1, 2))
    reach = torch.where(hit, p_reach[..., None, None], zero).amax(dim=(1, 2))
    return trigger, reach


def _quantile_rows(x_sorted: torch.Tensor, q: float) -> torch.Tensor:
    """Row-wise linear-interpolation quantile: ``lo + (hi - lo) * frac`` as
    one fused multiply-add, which is what XLA makes of the reference on the
    CPU (its optimization barrier does not stop the contraction there)."""
    n = x_sorted.shape[1]
    pos = q * (n - 1)
    k = int(np.floor(pos))
    lo = x_sorted[:, k]
    hi = x_sorted[:, min(k + 1, n - 1)]
    return fma32(hi - lo, f32(pos - k, x_sorted).expand_as(lo), lo)


def _triage_stats(total: torch.Tensor):
    """(P_sup, P_hopeless, mean) of each row of TOTAL demand samples; the
    mean sums in XLA's order (:func:`row_sum`) and scales by ``1 / W``, as
    XLA does."""
    srt = torch.sort(total, dim=1).values
    return (_quantile_rows(srt, SUP_Q), _quantile_rows(srt, HOPELESS_Q),
            row_sum(total) * f32(1.0 / total.shape[1], total))


@dataclass
class FusedRefresh:
    """Host-side results of one fused refresh over a slot subset (all
    row-aligned with the ``slots`` argument)."""
    ranks: np.ndarray                  # (A,)
    probs: np.ndarray                  # (A, n_buckets)
    edges: np.ndarray                  # (A, n_buckets)
    spill: int
    trigger: Optional[np.ndarray]      # (A, B) | None
    reach: Optional[np.ndarray]        # (A, B) | None
    sup: Optional[np.ndarray]          # (A,) | None  (with_triage)
    opt: Optional[np.ndarray]
    mean: Optional[np.ndarray]


@dataclass
class _Rows:
    """One dispatch's gathered, padded queue rows as device tensors."""
    gi: torch.Tensor
    start: torch.Tensor
    executed: torch.Tensor
    attained: torch.Tensor
    kid: np.ndarray
    rid: np.ndarray
    stretch: torch.Tensor
    ovs: Optional[torch.Tensor]
    ovc: Optional[torch.Tensor]
    valid: torch.Tensor


def _dispatch_rows(qs: QueueState, slots: np.ndarray) -> _Rows:
    """Padded row gather (power of two) and override-width trim, moved to
    the arena's device in one place."""
    gi, start, executed, attained, kid, rid, stretch, ovs, ovc = \
        qs.gather(slots)
    dev = qs.device
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    with_ov = qs.override_apps > 0
    return _Rows(
        gi=t(gi), start=t(start), executed=t(executed), attained=t(attained),
        kid=kid, rid=rid, stretch=t(stretch), ovs=t(ovs) if with_ov else None,
        ovc=t(ovc) if with_ov else None,
        valid=t(np.arange(len(gi)) < len(slots)))


def _prewarm_args(packed: PackedKB, prewarm_table):
    dev = packed.device
    return (torch.as_tensor(prewarm_table.unit_class, device=dev),
            torch.as_tensor(prewarm_table.warmup, device=dev))


def _walk(packed: PackedKB, rows: _Rows, *, walker, base_key, seed,
          rank_in_kernel, n_walkers, max_steps, n_buckets, with_prewarm,
          with_triage, with_rank=True, po_cum=None, po_scale=None,
          compact_schedule=None):
    """The walk section of every dispatch: queue rows -> the
    ``pdgraph_walk_ranked`` dict (``probs``, ``edges``, ``ranks``,
    ``total`` with triage, ``spill`` and the arrival rows with prewarming),
    from the fused walk or, with ``rank_in_kernel=False``, composed from a
    walk (``pdgraph_walk``, or the threefry walker from ``base_key``; the
    reference's ``_walk_total``) and the PyTorch reductions — the same bits
    unless a compaction stage spills.  The composition ranks only
    ``with_rank`` (the delta tick re-ranks every slot in place anyway) and
    compacts the per-phase walk with ``compact_schedule`` (``None``: its
    default single stage).  ``rows.kid`` / ``rows.rid`` are host arrays or
    tensors."""
    dev = packed.device
    if walker == "threefry":
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        out = _mc_walk_batch(
            packed.samples, packed.counts, packed.cum_trans, rows.gi,
            rows.start, rows.executed, base_key, t(rows.kid), t(rows.rid),
            rows.ovs, rows.ovc, n_walkers, max_steps,
            track_arrivals=with_prewarm, po_cum=po_cum, po_scale=po_scale)
        rem, arr = out if with_prewarm else (out, None)
        spill = 0
    elif rank_in_kernel:
        # the CPU walk's lookup tables; the kernel reads none
        quant = (quant_tables(packed.samples, packed.counts,
                              packed.cum_trans)
                 if dev.type == "cpu" and rows.ovs is None else None)
        return pdgraph_walk_ranked(
            packed.samples, packed.counts, packed.cum_trans, rows.gi,
            rows.start, rows.executed,
            walker_streams(seed, rows.kid, rows.rid, device=dev),
            rows.attained, rows.ovs, rows.ovc, valid=rows.valid,
            n_walkers=n_walkers, max_steps=max_steps, n_buckets=n_buckets,
            track_arrivals=with_prewarm, with_rank=True,
            with_total=with_triage, po_cum=po_cum, po_scale=po_scale,
            quant=quant)
    else:
        out = pdgraph_walk(
            packed.samples, packed.counts, packed.cum_trans, rows.gi,
            rows.start, rows.executed,
            walker_streams(seed, rows.kid, rows.rid, device=dev), rows.ovs,
            rows.ovc, valid=rows.valid, n_walkers=n_walkers,
            max_steps=max_steps, compact_schedule=compact_schedule,
            track_arrivals=with_prewarm, po_cum=po_cum, po_scale=po_scale)
        rem, arr, spill = out if with_prewarm else (out[0], None, out[1])
    total = rows.attained[:, None] + torch.maximum(rem, f32(0.0, rem))
    probs, edges = to_histogram_rows(total, n_buckets)
    res = {"probs": probs, "edges": edges,
           "ranks": (gittins_rank_core(probs, edges, rows.attained)
                     if with_rank else None),
           "total": total, "spill": spill}
    if with_prewarm:
        res.update(zip(("a_hist", "a_lo", "a_span", "a_reach"),
                       arrival_hists(arr, n_buckets)))
    return res


def _store_results(qs: QueueState, slots: np.ndarray, n_buckets: int,
                   n_classes, sup, opt, mean, trigger, reach) -> None:
    """Write one dispatch's per-slot results into the host mirrors."""
    qs.ensure_result_rows(n_buckets, n_classes)
    if sup is not None:
        qs.sup[slots] = sup
        qs.opt[slots] = opt
        qs.mean[slots] = mean
    if trigger is not None:
        qs.trig[slots] = trigger
        qs.reach[slots] = reach


def _host(t: Optional[torch.Tensor], n: Optional[int] = None):
    if t is None:
        return None
    a = t.cpu().numpy()
    return a if n is None else a[:n]


def _check_walker(walker: str, base_key, rank_in_kernel) -> None:
    if walker != "threefry":
        return
    if base_key is None:
        raise ValueError("walker='threefry' walks from base_key (the "
                         "scheduler's threefry.PRNGKey(seed)); got None")
    if rank_in_kernel:
        raise ValueError("rank_in_kernel=True requires walker='pallas' (the "
                         "'threefry' walker has no fused one-pass program)")


def refresh_ranks_fused(packed: PackedKB, qs: QueueState, seed, *,
                        base_key: Optional[torch.Tensor] = None,
                        slots: Optional[np.ndarray] = None,
                        n_walkers: int = 512, max_steps: int = 64,
                        n_buckets: int = N_BUCKETS, walker: str = "pallas",
                        prewarm_table=None, prewarm_k: float = 0.5,
                        with_triage: bool = False,
                        rank_in_kernel: Optional[bool] = None
                        ) -> FusedRefresh:
    """One fused refresh over a slot subset (default: every occupied slot).

    Returns host arrays; fresh triage scalars and prewarm trigger/reach
    rows also land in the store's host mirrors.  Does NOT bump refresh
    ids; callers bump after consuming.  ``rank_in_kernel`` (default on)
    selects the fused walk; ``False`` composes the per-phase walk with the
    reductions; ``walker="threefry"`` composes the threefry walk from
    ``base_key`` with them."""
    _check_walker(walker, base_key, rank_in_kernel)
    if slots is None:
        slots = qs.occupied()
    A = len(slots)
    if A == 0:
        z = np.zeros((0, n_buckets), np.float32)
        zs = np.zeros(0, np.float32)
        zt = (np.zeros((0, prewarm_table.n_classes), np.float32)
              if prewarm_table is not None else None)
        tri = zs if with_triage else None
        return FusedRefresh(zs, z, z, 0, zt, zt, tri, tri, tri)
    rows = _dispatch_rows(qs, slots)
    with_pw = prewarm_table is not None
    res = _walk(packed, rows, walker=walker, base_key=base_key, seed=seed,
                rank_in_kernel=rank_in_kernel is not False,
                n_walkers=n_walkers, max_steps=max_steps,
                n_buckets=n_buckets, with_prewarm=with_pw,
                with_triage=with_triage)
    sup = opt = mean = None
    if with_triage:
        sup, opt, mean = _triage_stats(res["total"])
    trigger = reach = None
    if with_pw:
        uc, wt = _prewarm_args(packed, prewarm_table)
        trigger, reach = _triggers_from_hists(
            res["a_hist"], res["a_lo"], res["a_span"], res["a_reach"],
            n_walkers, torch.zeros_like(rows.attained), uc[rows.gi.long()],
            wt, prewarm_k, rows.stretch)
    out = FusedRefresh(
        _host(res["ranks"], A), _host(res["probs"], A),
        _host(res["edges"], A), int(res["spill"]), _host(trigger, A),
        _host(reach, A),
        _host(sup, A), _host(opt, A), _host(mean, A))
    _store_results(qs, slots, n_buckets,
                   prewarm_table.n_classes if with_pw else None,
                   out.sup, out.opt, out.mean, out.trigger, out.reach)
    return out


@dataclass
class DeltaTick:
    """Results of one delta tick: arena-wide ranks plus the set of slots
    whose estimates were actually re-walked."""
    ranks: np.ndarray          # (capacity,) — index by slot id; holes garbage
    spill: int
    walked: np.ndarray         # slot ids re-walked (and scattered) this tick


def _retrigger_rows(qs: QueueState, walked: np.ndarray):
    """Arena-wide rows for the trigger re-conditioning: graph ids, service
    attained since each slot's last walk (0 for this tick's walked rows)
    and the stretch EWMA."""
    delta_all = qs.attained - qs.a_att
    if len(walked):
        delta_all[walked] = 0.0
    t = lambda a: torch.as_tensor(a, device=qs.device)  # noqa: E731
    return t(qs.graph_idx).long(), t(delta_all), t(qs.stretch)


def _posterior_rows(packed: PackedKB, qs: QueueState, walked: np.ndarray,
                    rows: _Rows, posterior):
    """Walk tables of the walked slots' posterior rows blended with their
    graphs' priors; padding rows gather the last slot's row (garbage, never
    scattered), as the reference clamps its out-of-bounds padding index."""
    qs.ensure_posterior_rows()
    idx = np.full(rows.gi.shape[0], qs.capacity - 1, np.int64)
    idx[:len(walked)] = walked
    gi = rows.gi.long()
    return posterior_tables(
        qs.post[torch.as_tensor(idx, device=qs.device)],
        packed.cum_trans[gi], prior_mean(packed.samples, packed.counts)[gi],
        branch_strength=posterior.branch_strength,
        demand_strength=posterior.demand_strength)


def refresh_ranks_delta(packed: PackedKB, qs: QueueState, seed, *,
                        walked: np.ndarray,
                        base_key: Optional[torch.Tensor] = None,
                        n_walkers: int = 512, max_steps: int = 64,
                        n_buckets: int = N_BUCKETS, walker: str = "pallas",
                        prewarm_table=None, prewarm_k: float = 0.5,
                        retrigger: bool = True,
                        with_triage: bool = False,
                        posterior=None,
                        rank_in_kernel: Optional[bool] = None) -> DeltaTick:
    """One delta tick over the slot store: walk ``walked`` (normally the
    drained dirty set), scatter their histogram rows into the device arena,
    re-rank every slot in place.  With an empty ``walked`` the tick is a
    pure rank-in-place — no walk at all.  ``retrigger=True`` (full ticks)
    re-conditions EVERY slot's prewarm triggers on the service attained
    since its walk; ``retrigger=False`` (event-path subset calls) computes
    walk-time triggers for the walked rows only.  ``posterior`` (a
    :class:`~repro_torch.core.posterior.PosteriorConfig`) blends each walked
    slot's device posterior row with the prior into its walk tables.
    ``walker="threefry"`` walks from ``base_key``.  Does NOT bump refresh
    ids; callers bump ``walked`` after consuming."""
    if qs.n_shards != 1:
        raise ValueError("refresh_ranks_delta serves 1-shard arenas; "
                         "mesh-sharded stores go through refresh_ranks_mesh")
    _check_walker(walker, base_key, rank_in_kernel)
    with_pw = prewarm_table is not None
    qs.ensure_result_rows(n_buckets,
                          prewarm_table.n_classes if with_pw else None,
                          arrivals=with_pw)
    att_all = torch.as_tensor(qs.attained, device=qs.device)
    D = len(walked)
    uc = wt = None
    if with_pw:
        uc, wt = _prewarm_args(packed, prewarm_table)
    sup = opt = mean = None
    trigger = reach = None
    spill = 0
    if D:
        rows = _dispatch_rows(qs, walked)
        po_cum = po_scale = None
        if posterior is not None:
            po_cum, po_scale = _posterior_rows(packed, qs, walked, rows,
                                               posterior)
        res = _walk(packed, rows, walker=walker, base_key=base_key,
                    seed=seed, rank_in_kernel=rank_in_kernel is not False,
                    n_walkers=n_walkers, max_steps=max_steps,
                    n_buckets=n_buckets, with_prewarm=with_pw,
                    with_triage=with_triage, with_rank=False, po_cum=po_cum,
                    po_scale=po_scale)
        spill = res["spill"]
        slot_t = torch.as_tensor(np.asarray(walked, np.int64),
                                 device=qs.device)
        # the walked rows' ranks are superseded by the arena-wide
        # rank-in-place below (same rows, same attained, same bits)
        qs.d_probs[slot_t] = res["probs"][:D]
        qs.d_edges[slot_t] = res["edges"][:D]
        if with_triage:
            sup, opt, mean = (_host(x, D) for x in
                              _triage_stats(res["total"]))
        if with_pw:
            qs.a_hist[slot_t] = res["a_hist"][:D]
            qs.a_lo[slot_t] = res["a_lo"][:D]
            qs.a_span[slot_t] = res["a_span"][:D]
            qs.a_reach[slot_t] = res["a_reach"][:D]
            if not retrigger:
                trigger, reach = _triggers_from_hists(
                    res["a_hist"], res["a_lo"], res["a_span"],
                    res["a_reach"], n_walkers,
                    torch.zeros_like(rows.attained), uc[rows.gi.long()], wt,
                    prewarm_k, rows.stretch)
    # rank-in-place: per-row math over the whole arena — bit-identical per
    # row to ranking the walked rows alone; holes rank garbage never read
    ranks = gittins_rank_core(qs.d_probs, qs.d_edges, att_all)
    if with_pw and retrigger:
        gi_all, delta_all, stretch_all = _retrigger_rows(qs, walked)
        trigger, reach = _triggers_from_hists(
            qs.a_hist, qs.a_lo, qs.a_span, qs.a_reach, n_walkers, delta_all,
            uc[gi_all], wt, prewarm_k, stretch_all)
    if with_pw and D:
        qs.a_att[walked] = qs.attained[walked]
    _store_results(qs, walked, n_buckets,
                   prewarm_table.n_classes if with_pw else None,
                   sup, opt, mean, None, None)
    if trigger is not None:
        if retrigger:
            qs.trig = _host(trigger).copy()      # whole-arena mirrors
            qs.reach = _host(reach).copy()
        else:
            qs.trig[walked] = _host(trigger, D)
            qs.reach[walked] = _host(reach, D)
    return DeltaTick(_host(ranks), int(spill), walked)
