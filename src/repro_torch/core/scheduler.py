"""HermesScheduler: the global queue manager (Fig. 4).

PyTorch counterpart of ``repro.core.scheduler``.  Holds the PDGraph
knowledge base, tracks per-application runtime state, refreshes priorities
at bucket-period granularity, performs online demand refinement on unit
completion, and emits prewarm signals or plans.  Hosts drive it through the
same ``on_*`` callbacks as the reference.

Refresh modes, as in the reference: ``looped`` walks one application at a
time and ``composed`` the whole stale set at once, both with the threefry
walker (:mod:`repro_torch.core.threefry`) keyed by
``fold_in(fold_in(PRNGKey(seed), key_id), refreshes)``, so they draw the
reference's samples bit for bit; the views carry the samples and the policy
ranks them on the host.  A bare ``HermesScheduler(kb)`` runs ``composed``
(``looped`` with ``batched=False``), as the reference does.  ``fused`` and
``fused_delta`` (``SimConfig``'s default) refresh through the device slot
arena: the counter-RNG walk kernels, or ``walker="threefry"``.  Policies
that need raw demand samples (``srpt_mean``, ``oracle``) take the host-
sample walk in every mode (one batched walk unless ``batched=False``).

The arena and the walks live on ``device`` (default ``cuda``; the caller
asks for the CPU explicitly, and construction raises when ``cuda`` is asked
for without a card).  ``RefreshConfig(rank_in_kernel=False)`` composes the
per-phase walk with the reductions; ``posterior`` (a ``PosteriorConfig``,
``fused_delta`` only) learns branch mixes and unit demands online.
``mesh_shards`` splits the arena into shards on the same device
(:mod:`repro_torch.core.refresh_mesh`): each tick walks every shard's dirty
rows and re-ranks only the stale ones, the same bits as the single arena;
``lane_balance`` walks a skewed dirty set round-robin.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import correlation as C
from repro_torch.core import threefry
from repro_torch.core.arena import build_queue_state
from repro_torch.core.pdgraph import (PDGraph, mc_service_samples_batch,
                                      pack_graphs)
from repro_torch.core.policies import (AppView, GittinsPolicy, Policy,
                                       VTCPolicy, make_policy)
from repro_torch.core.posterior import (END, Observation, PosteriorConfig,
                                        PosteriorState, row_width)
from repro_torch.core.prewarm import (PrewarmPlan, PrewarmSignal,
                                      build_prewarm_table)
from repro_torch.core.refresh_config import RefreshConfig
from repro_torch.core.refresh_mesh import RefreshMesh, refresh_ranks_mesh
from repro_torch.core.refresh_pipeline import (refresh_ranks_delta,
                                               refresh_ranks_fused)
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class AppRuntime:
    app_id: str
    app_name: str
    tenant: str
    arrival: float
    deadline: Optional[float] = None
    current_unit: Optional[str] = None
    unit_start: float = 0.0
    attained: float = 0.0                 # total service received (sec)
    attained_in_unit: float = 0.0
    done: bool = False
    overrides: Dict[str, np.ndarray] = field(default_factory=dict)
    view: Optional[AppView] = None
    oracle_remaining: Optional[float] = None
    key_id: int = 0                       # stable per-app RNG stream id
    refreshes: int = 0                    # per-app view-refresh counter
    queue_stretch: float = 1.0            # observed wall/service EWMA (§3.4)


class HermesScheduler:
    def __init__(self, knowledge_base: Dict[str, PDGraph],
                 policy: str = "gittins", *,
                 t_in: float = 1e-4, t_out: float = 2e-3,
                 K: float = 0.5, n_buckets: int = 10,
                 refine: bool = True, prewarm: bool = True,
                 mc_walkers: int = 512, seed: int = 0,
                 batched: bool = True,
                 refresh: Optional[RefreshConfig] = None,
                 warmup_table: Optional[Dict[str, float]] = None,
                 posterior: Optional[PosteriorConfig] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.kb = knowledge_base
        self.policy: Policy = make_policy(policy) if policy != "gittins" \
            else make_policy(policy, n_buckets=n_buckets)
        self.t_in, self.t_out = t_in, t_out
        self.K = K
        self.n_buckets = n_buckets
        self.refine = refine
        self.prewarm_enabled = prewarm
        self.mc_walkers = mc_walkers
        self._mc_walkers_base = mc_walkers
        if refresh is None:
            # bare construction keeps the reference's default: ``batched``
            # picks composed vs looped (SimConfig defaults to fused_delta)
            rc = dataclasses.replace(
                RefreshConfig(), mode="composed" if batched else "looped")
        else:
            rc = refresh
        self.refresh_config = rc
        self.mode = rc.mode
        self.batched = self.mode != "looped"
        self.delta_full_threshold = rc.delta_full_threshold
        self.queue_delay_correction = rc.queue_delay_correction
        # mesh sharding: the arena split into mesh_shards shards on this
        # device, walked and ranked shard by shard (the same bits as the
        # single arena); None keeps the single-arena delta tick
        self.refresh_mesh: Optional[RefreshMesh] = None
        if rc.mesh_shards is not None:
            self.refresh_mesh = RefreshMesh(rc.mesh_shards,
                                            device=self.device)
        self._stretch_alpha = 0.3       # queue-wait EWMA smoothing
        self.walker = rc.walker
        self.rank_in_kernel = rc.rank_in_kernel
        self.lane_balance = rc.lane_balance
        if hasattr(self.policy, "vectorized"):
            self.policy.vectorized = self.batched
        self.apps: Dict[str, AppRuntime] = {}
        # live subset of `apps`: the refresh tick iterates only this
        self._live: Dict[str, AppRuntime] = {}
        self._seed = seed
        self._base_key = threefry.PRNGKey(seed, device=self.device)
        self._app_seq = itertools.count()
        self._packed = None               # (kb versions, PackedKB) cache
        self._qstate = None               # device slot arena (lazy)
        self.fused_spill = 0
        self.warmup_table = warmup_table  # per-key warm-up cost overrides
        self._prewarm_tab = None          # (kb token, PrewarmTable) cache
        self.prewarm_plan: Optional[PrewarmPlan] = None   # last fused plan
        # mesh ticks with Gittins: app_id -> rank, updated only for the
        # re-ranked slots each tick; callers get a shallow copy
        self._mesh_ranks: Optional[Dict[str, float]] = None
        self._mesh_ranks_qs = None        # owning QueueState (invalidation)
        self.backend_slowdown: Dict[str, float] = {}
        # online posterior learning: observations buffer on the host and
        # fold into per-graph statistics at the next delta tick, which
        # writes each about-to-walk slot's device row right before its walk
        if posterior is not None and self.mode != "fused_delta":
            raise ValueError(
                "posterior learning rides the delta tick's walked-slot "
                f"scatter; it requires mode='fused_delta' (got {self.mode!r})")
        self.posterior = posterior
        self._post_state: Optional[PosteriorState] = \
            PosteriorState() if posterior is not None else None
        self._post_pending: List[Observation] = []
        self._post_cache: Dict[str, np.ndarray] = {}   # name -> (U, U+3) row
        self._post_cache_token = None
        for g in self.kb.values():
            C.apply_masks(g)

    # ------------------------------------------------------------ internals
    def _app_key(self, app: AppRuntime):
        """Deterministic per-(app, refresh) key — mode-independent, so the
        looped and batched paths draw bit-identical samples."""
        k = threefry.fold_in(self._base_key, app.key_id)
        return threefry.fold_in(k, app.refreshes)

    def _packed_kb(self):
        versions = tuple(sorted((n, g.version) for n, g in self.kb.items()))
        if self._packed is None or self._packed[0] != versions:
            self._packed = (versions, pack_graphs(self.kb, self.t_in,
                                                  self.t_out, self.device))
        return self._packed[1]

    def _fused_active(self) -> bool:
        """The fused pipeline computes Gittins ranks AND the composite
        policies' triage quantiles on device, so it engages for every
        fused-capable policy in a fused mode; anything else needs raw
        host-side demand samples and takes the composed path."""
        return self.mode in ("fused", "fused_delta") and \
            bool(getattr(self.policy, "fused_capable", False))

    def _delta_active(self) -> bool:
        return self.mode == "fused_delta" and self._fused_active()

    @property
    def _with_triage(self) -> bool:
        return type(self.policy) is not GittinsPolicy

    @property
    def prewarm_batched(self) -> bool:
        return self.prewarm_enabled and self._fused_active()

    def _prewarm_table(self):
        from repro_torch.core.hermeslet import warmup_time_for
        packed = self._packed_kb()
        token = self._packed[0]
        if self._prewarm_tab is None or self._prewarm_tab[0] != token:
            tab = build_prewarm_table(
                self.kb, packed,
                lambda k: warmup_time_for(k, self.warmup_table))
            self._prewarm_tab = (token, tab)
        return self._prewarm_tab[1]

    def take_prewarm_plan(self) -> Optional[PrewarmPlan]:
        """Hand the last fused-dispatch PrewarmPlan to the host exactly
        once; None when nothing was planned since the last take."""
        plan, self.prewarm_plan = self.prewarm_plan, None
        return plan

    def _ensure_qstate(self):
        packed = self._packed_kb()
        token = self._packed[0]
        if self._qstate is None or self._qstate.kb_token != token:
            self._qstate = build_queue_state(
                packed, list(self._live.values()), kb_token=token,
                n_shards=(self.refresh_mesh.n_shards if self.refresh_mesh
                          else 1))
        return self._qstate

    def _qstate_if_current(self):
        if self._qstate is None:
            return None
        packed = self._packed_kb()
        if self._qstate.kb_token != self._packed[0]:
            self._qstate = None
            return None
        return packed

    def _total_samples(self, app: AppRuntime) -> np.ndarray:
        """TOTAL demand distribution = attained + MC(remaining)."""
        g = self.kb[app.app_name]
        rem = g.mc_service_samples(
            self._app_key(app), self.t_in, self.t_out,
            start_unit=app.current_unit,
            executed_in_unit=app.attained_in_unit,
            unit_sample_override=app.overrides or None,
            n_walkers=self.mc_walkers, device=self.device)
        app.refreshes += 1
        return app.attained + np.maximum(rem, 0.0)

    def _make_view(self, app: AppRuntime, samples: np.ndarray) -> None:
        app.view = AppView(app_id=app.app_id, tenant=app.tenant,
                           arrival=app.arrival, attained=app.attained,
                           total_samples=samples, deadline=app.deadline,
                           oracle_remaining=app.oracle_remaining)

    def _refresh_view(self, app: AppRuntime) -> None:
        self._make_view(app, self._total_samples(app))

    def _refresh_views(self, apps: List[AppRuntime]) -> None:
        """Refresh many views at once: one batched walk for the whole set
        instead of one per application (``looped`` walks them one by
        one)."""
        if not apps:
            return
        if not self.batched or len(apps) == 1:
            for a in apps:
                self._refresh_view(a)
            return
        packed = self._packed_kb()
        gi = np.asarray([packed.graph_index[a.app_name] for a in apps],
                        np.int32)
        start = np.asarray(
            [packed.unit_index[g][a.current_unit] if a.current_unit
             else packed.entry[g] for g, a in zip(gi, apps)], np.int32)
        rem = mc_service_samples_batch(
            packed, self._base_key,
            graph_idx=gi, start=start,
            executed=np.asarray([a.attained_in_unit for a in apps]),
            key_ids=np.asarray([a.key_id for a in apps], np.int32),
            refresh_ids=np.asarray([a.refreshes for a in apps], np.int32),
            overrides=[a.overrides or None for a in apps],
            n_walkers=self.mc_walkers)
        total = np.maximum(rem, 0.0)
        # float32 addend: bit-identical to the looped path's
        # `attained + np.maximum(rem, 0.0)` float32 scalar promotion
        total += np.asarray([a.attained for a in apps],
                            np.float32)[:, None]
        for a, row in zip(apps, total):
            a.refreshes += 1
            self._make_view(a, row)

    def _refresh_views_fused(self, apps: List[AppRuntime],
                             now: float) -> None:
        """Fused refresh: one kernel launch re-estimates, bucketizes and
        ranks the stale set; views carry the histogram rows and the device
        rank, never the sample matrix."""
        if not apps:
            return
        qs = self._ensure_qstate()
        slots = np.asarray([qs.slot[a.app_id] for a in apps], np.int64)
        tab = self._prewarm_table() if self.prewarm_batched else None
        out = refresh_ranks_fused(
            self._packed[1], qs, self._seed, base_key=self._base_key,
            slots=slots, n_walkers=self.mc_walkers,
            n_buckets=self.n_buckets, walker=self.walker,
            prewarm_table=tab, prewarm_k=self.K,
            with_triage=self._with_triage,
            rank_in_kernel=self.rank_in_kernel)
        self.fused_spill += out.spill
        if tab is not None:
            self._stash_plan(PrewarmPlan.from_store(qs, slots, now, tab))
        triage = out.sup is not None
        for i, a in enumerate(apps):
            a.refreshes += 1
            a.view = AppView(app_id=a.app_id, tenant=a.tenant,
                             arrival=a.arrival, attained=a.attained,
                             total_samples=None, deadline=a.deadline,
                             oracle_remaining=a.oracle_remaining,
                             hist=(out.probs[i], out.edges[i]),
                             fused_rank=float(out.ranks[i]),
                             demand_sup=float(out.sup[i]) if triage else None,
                             demand_opt=float(out.opt[i]) if triage else None,
                             demand_mean=float(out.mean[i]) if triage
                             else None)
        qs.bump_refresh(slots)
        qs.clear_dirty(slots)

    def _priorities_delta(self, now: float,
                          app_ids: Optional[List[str]] = None
                          ) -> Dict[str, float]:
        """The delta tick: drain the dirty set, walk ONLY those slots (full
        re-walk past the dirty-fraction threshold), re-rank from the
        persisted device histograms, and serve every live rank from the
        store.  Full ticks are the repack boundary and, with prewarming,
        re-condition every trigger row on elapsed service.  Event-path
        subset calls walk only the dirty slots the event touched."""
        qs = self._ensure_qstate()
        if len(qs) == 0:
            return {}
        full = app_ids is None
        if full:
            qs.maybe_repack()
            live = list(self._live.values())
            walked = qs.take_dirty()
            if len(walked) >= self.delta_full_threshold * len(qs):
                walked = qs.occupied()
        else:
            live = [self.apps[i] for i in app_ids
                    if i in self.apps and not self.apps[i].done]
            req = {qs.slot[a.app_id] for a in live}
            walked = np.asarray(sorted(qs.dirty_in(req)), np.int64)
            qs.clear_dirty(req)
        if self.posterior is not None:
            self._posterior_flush(qs, walked)
        tab = self._prewarm_table() if self.prewarm_batched else None
        if self.refresh_mesh is not None:
            return self._priorities_mesh(qs, live, walked, now, tab, full)
        tick = refresh_ranks_delta(
            self._packed[1], qs, self._seed, base_key=self._base_key,
            walked=walked, n_walkers=self.mc_walkers,
            n_buckets=self.n_buckets, walker=self.walker,
            prewarm_table=tab, prewarm_k=self.K, retrigger=full,
            with_triage=self._with_triage, posterior=self.posterior,
            rank_in_kernel=self.rank_in_kernel)
        self.fused_spill += tick.spill
        if full:
            qs.take_rank_dirty()     # arena-wide re-rank covered everyone
        if tab is not None:
            plan_slots = qs.occupied() if full else walked
            if len(plan_slots):
                self._stash_plan(PrewarmPlan.from_store(qs, plan_slots,
                                                        now, tab))
        if len(walked):
            qs.bump_refresh(walked)
            for s in walked:
                self.apps[qs.ids[int(s)]].refreshes += 1
        return self._ranks_from_store(qs, live, tick.ranks, now)

    def _priorities_mesh(self, qs, live: List[AppRuntime],
                         walked: np.ndarray, now: float, tab,
                         full: bool) -> Dict[str, float]:
        """The mesh tick: walk each shard's dirty rows and re-rank each
        shard's *stale* rows (walked ∪ progressed); every other live rank
        is served from the store's host rank mirror.  With plain Gittins
        the consumption is an incremental dict, O(churn) a tick."""
        within = None if full else {qs.slot[a.app_id] for a in live}
        stale = qs.take_rank_dirty(within)
        stale.update(int(s) for s in walked)
        ranked = np.asarray(sorted(stale), np.int64)

        def bookkeeping():
            # overlapped with the device work (the refresh ids were
            # already packed into the tick's carrier)
            if len(walked):
                qs.bump_refresh(walked)
                for s in walked:
                    self.apps[qs.ids[int(s)]].refreshes += 1

        tick = refresh_ranks_mesh(
            self._packed[1], qs, self._seed, mesh=self.refresh_mesh,
            walked=walked, ranked=ranked, base_key=self._base_key,
            n_walkers=self.mc_walkers, n_buckets=self.n_buckets,
            walker=self.walker, prewarm_table=tab, prewarm_k=self.K,
            retrigger=full, host_work=bookkeeping,
            with_triage=self._with_triage, posterior=self.posterior,
            rank_in_kernel=self.rank_in_kernel,
            lane_balance=self.lane_balance)
        self.fused_spill += tick.spill
        if tab is not None:
            plan_slots = qs.occupied() if full else walked
            if len(plan_slots):
                self._stash_plan(PrewarmPlan.from_store(qs, plan_slots,
                                                        now, tab))
        if type(self.policy) is GittinsPolicy:
            # only the re-ranked slots touch the cached dict (retires prune
            # it in _retire; a store rebuild resets it).  Event-path subset
            # ticks update it too: they re-walk slots and drain their marks
            cache = self._mesh_ranks
            if cache is not None and self._mesh_ranks_qs is qs:
                for s, r in zip(ranked.tolist(), tick.ranks.tolist()):
                    cache[qs.ids[s]] = r
            if not full:
                slots = np.asarray([qs.slot[a.app_id] for a in live],
                                   np.int64)
                ids = [qs.ids[s] for s in slots.tolist()]
                return dict(zip(ids, qs.rank[slots].tolist()))
            if cache is None or self._mesh_ranks_qs is not qs:
                occ = qs.occupied()
                cache = dict(zip([qs.ids[s] for s in occ.tolist()],
                                 qs.rank[occ].tolist()))
                self._mesh_ranks, self._mesh_ranks_qs = cache, qs
            return dict(cache)
        return self._ranks_from_store(qs, live, qs.rank, now)

    def _ranks_from_store(self, qs, live: List[AppRuntime],
                          ranks_row: np.ndarray, now: float
                          ) -> Dict[str, float]:
        """Policy consumption straight off store columns (device ranks and
        triage mirrors gathered per slot)."""
        if not live:
            return {}
        n = len(live)
        slots = np.asarray([qs.slot[a.app_id] for a in live], np.int64)
        ids = [a.app_id for a in live]
        g = np.asarray(ranks_row[slots], np.float32)
        if type(self.policy) is GittinsPolicy:
            return dict(zip(ids, g.tolist()))
        if getattr(self.policy, "columns_capable", False) \
                and self._with_triage:
            attained = np.fromiter((a.attained for a in live),
                                   np.float64, count=n)
            deadline = np.fromiter(
                (np.inf if a.deadline is None else a.deadline
                 for a in live), np.float64, count=n)
            ranks = self.policy.ranks_columns(
                now, g=g,
                sup=qs.sup[slots].astype(np.float64),
                opt=qs.opt[slots].astype(np.float64),
                mean=qs.mean[slots].astype(np.float64),
                attained=attained, deadline=deadline)
            return dict(zip(ids, (float(r) for r in ranks)))
        triage = self._with_triage
        for a, s in zip(live, slots.tolist()):
            v = a.view
            if v is None:
                v = AppView(app_id=a.app_id, tenant=a.tenant,
                            arrival=a.arrival, attained=a.attained,
                            total_samples=None, deadline=qs.get_deadline(s),
                            oracle_remaining=a.oracle_remaining)
                a.view = v
            v.attained = a.attained
            v.fused_rank = float(ranks_row[s])
            if triage:
                v.demand_sup = float(qs.sup[s])
                v.demand_opt = float(qs.opt[s])
                v.demand_mean = float(qs.mean[s])
        ranks = self.policy.ranks([a.view for a in live], now)
        return {a.app_id: float(r) for a, r in zip(live, ranks)}

    def _posterior_flush(self, qs, walked: np.ndarray) -> None:
        """Fold the pending observations into the per-graph statistics and
        write ``row := graph stats`` for every about-to-walk slot, so a
        slot's device row always equals its graph's posterior as of its
        last walk (admitted slots are dirty, hence walked, hence written
        before they are ever sampled)."""
        if self._post_pending:
            for name in self._post_state.fold(self._post_pending):
                self._post_cache.pop(name, None)
            self._post_pending = []
        if len(walked) == 0:
            return
        packed = self._packed_kb()
        if self._post_cache_token != self._packed[0]:
            # KB repack: the packed unit order may have moved
            self._post_cache = {}
            self._post_cache_token = self._packed[0]
        U = qs.n_units
        vals = np.empty((len(walked), U, row_width(U)), np.float32)
        for i, s in enumerate(np.asarray(walked).tolist()):
            name = self.apps[qs.ids[int(s)]].app_name
            row = self._post_cache.get(name)
            if row is None:
                uidx = packed.unit_index[packed.graph_index[name]]
                order = sorted(uidx, key=uidx.get)
                row = self._post_state.graph_row(name, order, U)
                self._post_cache[name] = row
            vals[i] = row
        qs.update_posterior_rows(np.asarray(walked, np.int64), vals)

    def _stash_plan(self, plan: PrewarmPlan) -> None:
        """Accumulate plans until the host takes them (newest trigger per
        (app, class) wins; dead apps pruned)."""
        if len(plan) == 0:
            return
        prev = self.prewarm_plan
        if prev is None or len(prev) == 0:
            self.prewarm_plan = plan
            return
        self.prewarm_plan = prev.merge(plan, self._live.__contains__)

    # -------------------------------------------------------------- events
    def on_arrival(self, app_id: str, app_name: str, now: float, *,
                   tenant: str = "default",
                   deadline: Optional[float] = None) -> None:
        self.on_arrivals([(app_id, app_name, tenant, deadline)], now)

    def _qstate_set_unit(self, app: AppRuntime, unit: Optional[str]) -> None:
        packed = self._qstate_if_current()
        if packed is None or app.app_id not in self._qstate.slot:
            return
        g = packed.graph_index[app.app_name]
        idx = packed.unit_index[g][unit] if unit else int(packed.entry[g])
        self._qstate.set_unit(app.app_id, idx)

    def on_unit_start(self, app_id: str, unit: str, now: float) -> None:
        app = self.apps[app_id]
        app.current_unit = unit
        app.unit_start = now
        app.attained_in_unit = 0.0
        self._qstate_set_unit(app, unit)

    def on_progress(self, app_id: str, service_delta: float) -> None:
        app = self.apps[app_id]
        app.attained += service_delta
        app.attained_in_unit += service_delta
        if app.view is not None:
            app.view.attained = app.attained
            app.view.fused_rank = None
        if self._qstate is not None and app_id in self._qstate.slot:
            self._qstate.add_progress(app_id, service_delta)
        if isinstance(self.policy, VTCPolicy):
            self.policy.account(app.tenant, service_delta)

    def on_unit_finish(self, app_id: str, unit: str,
                       observed: Dict[str, float], now: float,
                       next_unit: Optional[str]) -> None:
        """Online refinement: condition every downstream unit's demand on
        the just-observed execution (bucket-join + filter, §3.2).  With
        posterior learning the completion also feeds the unit's observed
        model-space service and the taken branch to the statistics."""
        app = self.apps[app_id]
        g = self.kb[app.app_name]
        if self.posterior is not None:
            svc = C.observed_service(observed, self.t_in, self.t_out)
            self._post_pending.append((app.app_name, unit, "demand", svc))
            self._post_pending.append(
                (app.app_name, unit, "branch",
                 next_unit if next_unit is not None else END))
        if self.refine:
            qs_packed = self._qstate_if_current()
            prefix = unit + "|"
            for name, node in g.units.items():
                if name == unit:
                    continue
                if not any(k.startswith(prefix) and v
                           for k, v in node.corr_mask.items()):
                    continue
                cond = C.conditional_samples(g, unit, name, observed,
                                             self.t_in, self.t_out)
                if cond is not None:
                    app.overrides[name] = cond
                    if qs_packed is not None and \
                            app_id in self._qstate.slot:
                        uidx = qs_packed.unit_index[
                            qs_packed.graph_index[app.app_name]]
                        if name in uidx:
                            self._qstate.set_override(app_id, uidx[name],
                                                      cond)
        if next_unit is None:
            self._retire(app)
        else:
            app.current_unit = next_unit
            app.unit_start = now
            app.attained_in_unit = 0.0
            self._qstate_set_unit(app, next_unit)
        if not app.done:
            app.view = None          # stale: re-estimated on next priorities()

    def on_app_complete(self, app_id: str) -> None:
        self._retire(self.apps[app_id])

    def _retire(self, app: AppRuntime) -> None:
        app.done = True
        app.current_unit = None
        app.view = None
        app.overrides.clear()
        self._live.pop(app.app_id, None)
        if self._mesh_ranks is not None:
            self._mesh_ranks.pop(app.app_id, None)
        if self._qstate is not None:
            self._qstate.retire(app.app_id)

    def on_app_shed(self, app_id: str) -> None:
        """Admission control dropped this application: retire its slot and
        demand state exactly once."""
        app = self.apps.get(app_id)
        if app is None or app.done:
            return
        self._retire(app)

    def on_requeue(self, app_id: str, now: float) -> None:
        """A re-queued orphan unit re-entered the waiting queue: re-walk its
        estimate on the next delta tick."""
        app = self.apps.get(app_id)
        if app is None or app.done:
            return
        app.view = None
        if self._qstate is not None:
            self._qstate.mark_dirty(app_id)

    def set_walker_cap(self, cap: Optional[int]) -> None:
        """Load-adaptive degradation: cap the walker depth (``None``
        restores it), floored to a power of two."""
        if cap is None:
            self.mc_walkers = self._mc_walkers_base
            return
        cap = max(int(cap), 1)
        cap = 1 << (cap.bit_length() - 1)
        self.mc_walkers = min(self._mc_walkers_base, cap)

    def observe_unit_completion(self, app_id: str, unit: str,
                                service_s: float, *,
                                wall_s: Optional[float] = None,
                                backend: Optional[str] = None,
                                slowdown: Optional[float] = None) -> None:
        """Observation feed for hosts that execute units outside
        ``on_unit_finish``: ``service_s`` feeds the posterior demand
        statistics, ``wall_s`` the queueing-delay stretch, ``backend`` +
        ``slowdown`` the straggler estimate.  Each leg is a no-op when its
        feature is off."""
        if backend is not None and slowdown is not None:
            self.observe_backend_slowdown(backend, slowdown)
        if wall_s is not None:
            self.observe_queue_wait(app_id, max(wall_s - service_s, 0.0),
                                    service_s)
        if self.posterior is None:
            return
        app = self.apps.get(app_id)
        if app is None:
            return
        self._post_pending.append(
            (app.app_name, unit, "demand", float(service_s)))

    def observe_branch_taken(self, app_id: str, unit: str,
                             next_unit: Optional[str]) -> None:
        """Posterior branch feed: the application finished ``unit`` and
        moved to ``next_unit`` (None = terminal).  No-op without posterior
        learning."""
        if self.posterior is None:
            return
        app = self.apps.get(app_id)
        if app is None:
            return
        self._post_pending.append(
            (app.app_name, unit, "branch",
             next_unit if next_unit is not None else END))

    def observe_backend_slowdown(self, backend_id: str,
                                 slowdown: float) -> None:
        if slowdown <= 1.0:
            self.backend_slowdown.pop(backend_id, None)
        else:
            self.backend_slowdown[backend_id] = float(slowdown)

    def service_slowdown(self, kind: Optional[str] = None) -> float:
        vals = [v for k, v in self.backend_slowdown.items()
                if kind is None or k.startswith(kind)]
        return max(vals) if vals else 1.0

    def demand_triage(self, app_id: str) -> Optional[Tuple[float, float]]:
        """(attained service, optimistic TOTAL demand) of one application,
        or ``None`` before its first view refresh."""
        from repro_torch.core.policies import HOPELESS_Q
        app = self.apps.get(app_id)
        if app is None or app.done or app.view is None:
            return None
        v = app.view
        if v.demand_opt is not None:
            return app.attained, float(v.demand_opt)
        if v.total_samples is not None:
            return app.attained, float(np.quantile(v.total_samples,
                                                   HOPELESS_Q))
        return None

    def set_oracle(self, app_id: str, remaining: float) -> None:
        app = self.apps[app_id]
        app.oracle_remaining = remaining
        if app.view is not None:
            app.view.oracle_remaining = remaining

    # ------------------------------------------------------------ decisions
    def priorities(self, now: float,
                   app_ids: Optional[List[str]] = None) -> Dict[str, float]:
        """Rank live applications (lower = run first), optionally only the
        ``app_ids`` subset."""
        if self._delta_active():
            return self._priorities_delta(now, app_ids)
        if app_ids is None:
            live = list(self._live.values())
        else:
            live = [self.apps[i] for i in app_ids
                    if i in self.apps and not self.apps[i].done]
        if getattr(self.policy, "view_free", False):
            if not live:
                return {}
            ranks = self.policy.ranks(live, now)
            return {a.app_id: float(r) for a, r in zip(live, ranks)}
        if self._fused_active():
            stale = [a for a in live if a.view is None]
            self._refresh_views_fused(stale, now)
        else:
            stale = [a for a in live
                     if a.view is None or a.view.total_samples is None]
            self._refresh_views(stale)
        views = [a.view for a in live]
        if not views:
            return {}
        ranks = self.policy.ranks(views, now)
        return {a.app_id: float(r) for a, r in zip(live, ranks)}

    def priorities_arrays(self, now: float,
                          app_ids: Optional[List[str]] = None
                          ) -> Tuple[List[str], np.ndarray]:
        """Array-facing twin of :meth:`priorities`: ``(app_ids, ranks)``
        with the ranks as one float64 vector."""
        if getattr(self.policy, "view_free", False):
            if app_ids is None:
                live = list(self._live.values())
            else:
                live = [self.apps[i] for i in app_ids
                        if i in self.apps and not self.apps[i].done]
            if not live:
                return [], np.zeros(0)
            return ([a.app_id for a in live],
                    np.asarray(self.policy.ranks(live, now), np.float64))
        d = self.priorities(now, app_ids)
        return list(d), np.fromiter(d.values(), np.float64, count=len(d))

    def on_arrivals(self, items: List[tuple], now: float) -> None:
        """Batch admission: ``items`` of ``(app_id, app_name, tenant,
        deadline)``, admitted in order through one ``admit_many``."""
        packed = self._qstate_if_current()
        rows = []
        for app_id, app_name, tenant, deadline in items:
            g = self.kb[app_name]
            app = AppRuntime(app_id=app_id, app_name=app_name, tenant=tenant,
                             arrival=now, deadline=deadline,
                             current_unit=g.entry, unit_start=now,
                             key_id=next(self._app_seq))
            self.apps[app_id] = app
            self._live[app_id] = app
            if packed is not None:
                gi = packed.graph_index[app_name]
                rows.append((app_id, gi, int(packed.entry[gi]),
                             app.key_id, deadline))
        if rows:
            self._qstate.admit_many(rows)

    def refresh_tick(self, now: float, *,
                     resample: bool = False) -> Dict[str, float]:
        """The bucket-tick refresh: re-rank the whole queue (``resample``
        re-draws every live estimate outside delta mode)."""
        if resample and not self._delta_active():
            for a in self._live.values():
                a.view = None
        return self.priorities(now)

    def observe_queue_wait(self, app_id: str, wait_s: float,
                           service_s: float) -> None:
        """Queueing-delay correction feed (§3.4 refinement): per-app EWMA
        of the wall/service stretch.  No-op unless enabled."""
        if not self.queue_delay_correction:
            return
        app = self.apps.get(app_id)
        if app is None or app.done:
            return
        if service_s <= 1e-3:
            return
        obs = min((max(wait_s, 0.0) + service_s) / service_s, 100.0)
        app.queue_stretch += self._stretch_alpha * (obs - app.queue_stretch)
        if self._qstate is not None and app_id in self._qstate.slot:
            self._qstate.set_stretch(app_id, app.queue_stretch)

    def prewarm_signals(self, app_id: str, now: float,
                        warmup_time_of, is_warm) -> List[PrewarmSignal]:
        if not self.prewarm_enabled:
            return []
        app = self.apps[app_id]
        if app.done or app.current_unit is None:
            return []
        g = self.kb[app.app_name]
        return list(PrewarmPlan.one_hop(
            g, app_id, app.current_unit, app.unit_start, now, self.K,
            warmup_time_of, is_warm, self.t_in, self.t_out).signals())
