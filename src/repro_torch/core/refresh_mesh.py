"""Mesh-sharded refresh backbone: the delta tick over a sharded slot arena.

PyTorch counterpart of ``repro.core.refresh_mesh``, on one device.
``RefreshMesh`` splits the slot arena into ``n_shards`` shards: shard *s*
owns every slot with ``slot % n_shards == s``, and its rows form the block
``[s * cap_s, (s + 1) * cap_s)`` of the arena's device rows (the
shard-major layout of :mod:`repro_torch.core.arena`).  Where the reference
runs one ``shard_map`` dispatch over a device mesh, the shards here are a
loop over those blocks of one arena on one device.  Each tick, shard *s*

1. walks ITS dirty rows: one launch of the fused walk kernel (K1,
   ``ops.pdgraph_walk_ranked``) or, with ``rank_in_kernel=False``, the
   per-phase walk (K2, ``ops.pdgraph_walk``) compacted on the shard's own
   schedule (``ops.walk_schedule`` of its padded walk rows times the
   walkers) — the streams are keyed by each app's (key id, refresh id),
   never by slot or shard, so placement changes no drawn bit;
2. writes the fresh demand and arrival histogram rows into ITS block (a
   view of the arena, written in place);
3. re-ranks ITS stale rows (walked ∪ rank-dirty) with ``gittins_rank_core``;
4. with prewarming, re-conditions ITS trigger rows on elapsed service.

Every stage after the walk is per-row math, so the rank, the triage
scalars and the trigger rows of all shards are computed in one call over
the concatenation of the shards' rows (the same bits as one call a shard).
The host reads the small results back once.  The **lane-balanced** tick
(``lane_balance``) walks rows round-robin instead of by owner when the
per-shard dirty counts diverge; each shard's packed result rows are then
concatenated in shard order — the one-device counterpart of the
reference's ``all_gather`` — and each shard writes exactly the rows whose
owner column is its own, read from the raw int32 bit patterns.

The mesh tick gives the same bits per slot as the single-arena delta tick
(``refresh_pipeline.refresh_ranks_delta``) at any shard count.  A CUDA
arena launches K1 or K2 for every shard that has walk rows and never falls
back to the plain walk; a shard with no walk rows launches nothing (its
arena rows, spill and results are unchanged by padding-only walks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arena import QueueState
from repro_torch.core.gittins import N_BUCKETS, gittins_rank_core
from repro_torch.core.pdgraph import PackedKB
from repro_torch.core.posterior import posterior_tables, prior_mean
from repro_torch.core.refresh_pipeline import (_check_walker, _Rows,
                                               _triage_stats,
                                               _triggers_from_hists, _walk)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.pdgraph_walk.ops import pad_rows, walk_schedule


class RefreshMesh:
    """A 1-D mesh of ``n_shards`` shards over one device's slot arena.

    ``n_shards`` must be a power of two.  The shards share ``device``
    (default ``cuda``; the caller asks for the CPU), so there is no device
    count to check.  ``n_shards=1`` runs the sharded tick on one block, the
    scaling baseline against the single-arena delta tick."""

    # id-keyed uploads kept before the oldest are evicted: a few KB
    # generations' worth (online refinement repacks the prewarm tables)
    _REP_CAP = 32

    def __init__(self, n_shards: int = 1, device: DeviceLike = None):
        if n_shards < 1 or n_shards & (n_shards - 1):
            raise ValueError(f"n_shards must be a power of two, got "
                             f"{n_shards}")
        self.n_shards = n_shards
        self.device = resolve_device(device)
        self._rep: dict = {}     # id -> (source ref, device copy)

    def replicated(self, arr: np.ndarray) -> torch.Tensor:
        """The device copy of a slow-changing host table (the prewarm
        tables), uploaded once per table instead of once per tick."""
        key = id(arr)
        ent = self._rep.get(key)
        if ent is None or ent[0] is not arr:
            ent = (arr, torch.as_tensor(arr, device=self.device))
            self._rep[key] = ent
            for k in list(self._rep)[:max(len(self._rep) - self._REP_CAP,
                                          0)]:
                del self._rep[k]
        return ent[1]


@dataclass
class MeshTick:
    """Results of one mesh tick.  ``ranks`` aligns with ``ranked`` (the
    stale slots re-ranked this tick); every other per-slot result lands in
    the store's host mirrors (``rank``/``sup``/``trig``/…)."""
    ranks: np.ndarray          # (R,) — row-aligned with `ranked`
    spill: int
    walked: np.ndarray         # slot ids re-walked this tick
    ranked: np.ndarray         # slot ids re-ranked this tick
    balanced: bool = False     # walked rows were assigned round-robin


# carrier column layout (the host packs, the shards unpack; int32 columns
# travel as raw float32 bit patterns, read back through .view(torch.int32))
_COL_GI, _COL_START, _COL_KID, _COL_RID, _COL_SCAT = range(5)
_COL_EXEC, _COL_ATT, _COL_STRETCH, _COL_RANK_ROW, _COL_RANK_ATT = range(5, 10)
_COL_OWNER = 10        # owner shard (slot % n) — read by balanced ticks only
_N_COLS = 11


def _partition(slots: np.ndarray, n: int, pad: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split ascending ``slots`` by shard residue into an (n, pad) matrix
    of global slot ids (-1 padding).  Returns (matrix, by_shard, counts)
    where ``by_shard`` is ``slots`` reordered shard-major (ascending within
    each shard) — the row-major order of the matrix's valid entries."""
    sh = slots % n
    order = np.argsort(sh, kind="stable")      # slots already ascending
    by_shard = slots[order]
    counts = np.bincount(sh, minlength=n)
    mat = np.full((n, pad), -1, np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(slots)) - offs[sh[order]]
    mat[sh[order], pos] = by_shard
    return mat, by_shard, counts


def _partition_rr(slots: np.ndarray, n: int, pad: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Round-robin (lane-balanced) partition: shard ``s`` walks
    ``slots[s::n]``, so per-shard counts differ by at most one whatever
    the residue skew.  Same return contract as :func:`_partition`; the
    walking shard is generally not the owner."""
    mat = np.full((n, pad), -1, np.int64)
    counts = np.zeros(n, np.int64)
    for s in range(n):
        rows = slots[s::n]
        mat[s, :len(rows)] = rows
        counts[s] = len(rows)
    by_shard = (np.concatenate([slots[s::n] for s in range(n)])
                if len(slots) else slots)
    return mat, by_shard, counts


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def refresh_ranks_mesh(packed: PackedKB, qs: QueueState, seed, *,
                       mesh: RefreshMesh, walked: np.ndarray,
                       ranked: Optional[np.ndarray] = None,
                       base_key: Optional[torch.Tensor] = None,
                       n_walkers: int = 512, max_steps: int = 64,
                       n_buckets: int = N_BUCKETS, walker: str = "pallas",
                       prewarm_table=None, prewarm_k: float = 0.5,
                       retrigger: bool = True, host_work=None,
                       with_triage: bool = False,
                       posterior=None,
                       rank_in_kernel: Optional[bool] = None,
                       lane_balance: Optional[float] = None) -> MeshTick:
    """One mesh tick: walk ``walked`` (shard-partitioned), write the rows
    into the sharded arena, re-rank ``ranked`` (default: the walked set)
    and read the small results back.  The same bits per slot as
    ``refresh_ranks_delta`` over the same sets on one shard.  Does NOT
    bump refresh ids; ``host_work`` (if given) runs after every shard's
    launches are enqueued and before the first read-back.

    ``posterior`` blends each walked slot's posterior row (in its owner's
    block) into its walk tables.  ``rank_in_kernel`` (default: on for
    ``walker="pallas"``) walks each shard with K1; ``False`` with K2 on the
    shard's compaction schedule; ``walker="threefry"`` walks from
    ``base_key``.  ``lane_balance`` assigns walked rows round-robin once
    ``max(per-shard dirty count) > (1 + lane_balance) * mean`` (never
    while ``posterior`` is on: posterior rows are owner-local)."""
    n = mesh.n_shards
    if qs.capacity % n or qs.n_shards != n:
        raise ValueError(f"store is laid out for {qs.n_shards} shards, "
                         f"mesh has {n}")
    if qs.device.type != mesh.device.type:
        raise ValueError(f"store is on {qs.device}, mesh on {mesh.device}")
    if rank_in_kernel is None:
        rank_in_kernel = walker == "pallas"
    _check_walker(walker, base_key, rank_in_kernel)
    with_pw = prewarm_table is not None
    with_po = posterior is not None
    qs.ensure_result_rows(n_buckets,
                          prewarm_table.n_classes if with_pw else None,
                          arrivals=with_pw)
    if with_po:
        qs.ensure_posterior_rows()
    dev = qs.device
    cap, cap_s = qs.capacity, qs.shard_capacity
    walked = np.asarray(walked, np.int64)
    ranked = walked if ranked is None else np.asarray(ranked, np.int64)

    wcounts = np.bincount(walked % n, minlength=n)
    rcounts = np.bincount(ranked % n, minlength=n)
    balanced = bool(lane_balance is not None and n > 1 and not with_po
                and len(walked) > 0
                and wcounts.max() > (1.0 + lane_balance)
                * max(len(walked) / n, 1.0))
    wmax = (int(np.ceil(len(walked) / n)) if balanced
            else int(wcounts.max()) if len(walked) else 1)
    # walk rows and rank rows pad on their own: a balanced tick walks
    # pad(|walked| / n) rows a shard even when one shard ranks them all
    Pw = pad_rows(max(wmax, 1))
    Pr = pad_rows(max(int(rcounts.max()) if len(ranked) else 1, 1))
    Pp = max(Pw, Pr)                     # carrier width
    wmat, w_by_shard, wn = (_partition_rr if balanced else _partition)(
        walked, n, Pw)
    rmat, r_by_shard, _ = _partition(ranked, n, Pr)

    wvalid = wmat >= 0
    widx = np.where(wvalid, wmat, 0)
    rvalid = rmat >= 0

    # ONE packed float32 carrier holds every per-row input (int32 columns as
    # raw bit patterns), uploaded in one copy from this fresh array.  Walk
    # columns live in the first Pw rows, rank columns in the first Pr; pad
    # rows of the rank columns get clamp-safe defaults (their ranks are
    # computed and discarded)
    U = qs.n_units
    carrier = np.empty((n, Pp, _N_COLS + U), np.float32)
    ci = carrier.view(np.int32)
    ci[:, :Pw, _COL_GI] = qs.graph_idx[widx]
    ci[:, :Pw, _COL_START] = qs.start[widx]
    ci[:, :Pw, _COL_KID] = qs.key_id[widx]
    ci[:, :Pw, _COL_RID] = qs.refresh_id[widx]
    ci[:, :Pw, _COL_SCAT] = np.where(wvalid, wmat // n, cap_s)
    carrier[:, :Pw, _COL_EXEC] = qs.executed[widx]
    carrier[:, :Pw, _COL_ATT] = qs.attained[widx]
    carrier[:, :Pw, _COL_STRETCH] = qs.stretch[widx]
    ci[:, :, _COL_RANK_ROW] = cap_s
    ci[:, :Pr, _COL_RANK_ROW] = np.where(rvalid, rmat // n, cap_s)
    carrier[:, :, _COL_RANK_ATT] = 0.0
    carrier[:, :Pr, _COL_RANK_ATT] = qs.attained[np.where(rvalid, rmat, 0)]
    ci[:, :Pw, _COL_OWNER] = np.where(wvalid, wmat % n, 0)
    ci[:, :Pw, _N_COLS:] = qs.ov_counts[widx]
    car = torch.from_numpy(carrier).to(dev)
    car_i = car.view(torch.int32)
    with_ov = qs.override_apps > 0
    ovs = (torch.from_numpy(qs.ov_samples[widx]).to(dev) if with_ov
           else None)

    uc = wt = None
    if with_pw:
        uc = mesh.replicated(prewarm_table.unit_class)
        wt = mesh.replicated(prewarm_table.warmup)
    pmean = prior_mean(packed.samples, packed.counts) if with_po else None
    # the shard's compaction schedule, sized by its walk lanes (K2 path)
    sched = walk_schedule(16, 4, Pw * n_walkers)

    # 1. each shard walks its rows: one K1 launch (or K2's phases) a shard
    walks = {}
    for s in range(n):
        if not wn[s]:
            continue                     # padding only: nothing to walk
        cw, cwi = car[s, :Pw], car_i[s, :Pw]
        scat = cwi[:, _COL_SCAT]
        rows = _Rows(gi=cwi[:, _COL_GI], start=cwi[:, _COL_START],
                     executed=cw[:, _COL_EXEC], attained=cw[:, _COL_ATT],
                     kid=cwi[:, _COL_KID], rid=cwi[:, _COL_RID],
                     stretch=cw[:, _COL_STRETCH],
                     ovs=ovs[s] if with_ov else None,
                     ovc=cwi[:, _N_COLS:] if with_ov else None,
                     valid=scat < cap_s)
        po_cum = po_scale = None
        if with_po:
            # the owner's block holds the rows; padding rows clamp to a
            # garbage row and their walks are never written
            blk = qs.post.narrow(0, s * cap_s, cap_s)
            gi = rows.gi.long()
            po_cum, po_scale = posterior_tables(
                blk[torch.clamp(scat.long(), max=cap_s - 1)],
                packed.cum_trans[gi], pmean[gi],
                branch_strength=posterior.branch_strength,
                demand_strength=posterior.demand_strength)
        walks[s] = (rows, _walk(
            packed, rows, walker=walker, base_key=base_key, seed=seed,
            rank_in_kernel=rank_in_kernel, n_walkers=n_walkers,
            max_steps=max_steps, n_buckets=n_buckets,
            with_prewarm=with_pw, with_triage=with_triage, with_rank=False,
            po_cum=po_cum, po_scale=po_scale, compact_schedule=sched))

    # 2. each shard writes its rows into its own block of the arena
    arena = [("d_probs", "probs"), ("d_edges", "edges")]
    if with_pw:
        arena += [("a_hist", "a_hist"), ("a_lo", "a_lo"),
                  ("a_span", "a_span"), ("a_reach", "a_reach")]
    if balanced:
        _scatter_balanced(qs, walks, arena, car, wcounts, n, cap_s)
    else:
        for s, (rows, res) in walks.items():
            k = int(wn[s])               # valid rows are each shard's prefix
            dst = car_i[s, :k, _COL_SCAT].long()
            for name, key in arena:
                getattr(qs, name).narrow(0, s * cap_s, cap_s).index_copy_(
                    0, dst, res[key][:k])

    # 3. every shard's stale rows, ranked in one call over their rows
    rr = torch.clamp(car_i[:, :Pr, _COL_RANK_ROW].long(), max=cap_s - 1)
    grow = (rr + torch.arange(n, device=dev)[:, None] * cap_s).reshape(-1)
    ranks = gittins_rank_core(qs.d_probs[grow], qs.d_edges[grow],
                              car[:, :Pr, _COL_RANK_ATT].reshape(-1))
    walk_shards = list(walks)
    triage = None
    if with_triage and walk_shards:
        triage = torch.stack(_triage_stats(torch.cat(
            [walks[s][1]["total"] for s in walk_shards])))
    trigger = reach = None
    if with_pw:
        if retrigger:
            # 4. (cap,) rows in device-row order: shard s's block is its own
            row_slots = qs.row_slots()
            delta_all = qs.attained - qs.a_att
            if len(walked):
                delta_all[walked] = 0.0
            rc = np.empty((3, cap), np.float32)
            rc[0].view(np.int32)[:] = qs.graph_idx[row_slots]
            rc[1] = delta_all[row_slots]
            rc[2] = qs.stretch[row_slots]
            rct = torch.from_numpy(rc).to(dev)
            trigger, reach = _triggers_from_hists(
                qs.a_hist, qs.a_lo, qs.a_span, qs.a_reach, n_walkers, rct[1],
                uc[rct[0].view(torch.int32).long()], wt, prewarm_k, rct[2])
        elif walk_shards:
            res = {k: torch.cat([walks[s][1][k] for s in walk_shards])
                   for k in ("a_hist", "a_lo", "a_span", "a_reach")}
            wrows = [walks[s][0] for s in walk_shards]
            gi = torch.cat([r.gi for r in wrows]).long()
            trigger, reach = _triggers_from_hists(
                res["a_hist"], res["a_lo"], res["a_span"], res["a_reach"],
                n_walkers, torch.zeros(gi.shape[0], dtype=torch.float32,
                                       device=dev), uc[gi], wt, prewarm_k,
                torch.cat([r.stretch for r in wrows]))
    if host_work is not None:
        host_work()                # overlaps the enqueued device work

    if with_pw:
        qs.a_att[walked] = qs.attained[walked]
    qs.rank[r_by_shard] = _host(ranks).reshape(n, Pr)[rvalid]
    wsel = wvalid[walk_shards]          # (k, Pw): the walking shards' rows
    if triage is not None:
        sup, opt, mean = _host(triage).reshape(3, len(walk_shards), Pw)
        qs.sup[w_by_shard] = sup[wsel]
        qs.opt[w_by_shard] = opt[wsel]
        qs.mean[w_by_shard] = mean[wsel]
    if trigger is not None:
        if retrigger:
            # (cap, B) in device-row order -> slot order
            rows = qs.device_rows(np.arange(cap, dtype=np.int64))
            qs.trig = _host(trigger)[rows]
            qs.reach = _host(reach)[rows]
        else:
            qs.trig[w_by_shard] = _host(trigger)[wsel.ravel()]
            qs.reach[w_by_shard] = _host(reach)[wsel.ravel()]
    spill = sum(int(res["spill"]) for _, res in walks.values())
    return MeshTick(qs.rank[ranked], spill, walked, ranked, balanced)


def _scatter_balanced(qs: QueueState, walks, arena, car: torch.Tensor,
                      wcounts, n: int, cap_s: int) -> None:
    """The balanced tick's return of result rows to their owners.  Each
    walking shard packs its result rows with their owner and owner-local
    row (the carrier's raw int32 bit patterns); the packs are concatenated
    in shard order (the reference's ``all_gather``); shard ``s`` then
    writes exactly the rows whose owner column is ``s`` (padding rows carry
    row ``cap_s`` and are never taken)."""
    packs = []
    for s, (_, res) in walks.items():
        D = res["probs"].shape[0]
        meta = car[s, :D, [_COL_OWNER, _COL_SCAT]]
        packs.append(torch.cat([meta] + [res[key].reshape(D, -1)
                                         for _, key in arena], 1))
    g = torch.cat(packs)                                  # (k*Pw, 2 + K)
    gi32 = g[:, :2].contiguous().view(torch.int32)
    owner, gscat = gi32[:, 0], gi32[:, 1]
    # rows grouped by owner (padding last), in gather order within an owner
    key = torch.where(gscat < cap_s, owner, torch.full_like(owner, n))
    order = torch.argsort(key, stable=True)
    off = np.concatenate([[0], np.cumsum(wcounts)])
    for s in range(n):
        if not wcounts[s]:
            continue
        sel = order[int(off[s]):int(off[s + 1])]
        dst = gscat[sel].long()
        rows = g[sel]
        col = 2
        for name, _ in arena:
            blk = getattr(qs, name).narrow(0, s * cap_s, cap_s)
            w = int(np.prod(blk.shape[1:]))
            blk.index_copy_(0, dst, rows[:, col:col + w].reshape(
                (-1,) + blk.shape[1:]))
            col += w
