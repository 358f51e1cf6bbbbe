"""PDGraph-based backend prewarming (§3.4).

For a running unit with completion-time distribution T_c, a cold downstream
backend with branch probability p_s and warm-up duration t_p, and the
*expected prewarming effectiveness* knob K:

    p_e = p_s * P(t_c > t_s + t_p)

* if p_s < K          -> never prewarm (can't reach effectiveness K)
* else fire at the latest t_s with p_e = K, i.e.
      t_s = start + Quantile_{T_unit}(1 - K/p_s) - t_p
  (clipped at `now`; a smaller K = more aggressive = earlier trigger and more
  potential waste — the Fig. 14 trade-off.)

:class:`PrewarmPlan` is the single planning API.  Every way of producing
prewarm decisions is a constructor on it, and merging is a method:

* ``PrewarmPlan.from_store(store, slots, now, table)`` — batched device
  plan (fused refresh mode): the fused refresh walk records per-walker
  first-arrival times into every unit; the pipeline reduces them on device
  into per-(app, backend-class) arrival histograms and trigger quantiles,
  generalizing the one-hop branch probability p_s to the full reach
  probability over ALL downstream units.  ``PrewarmTable`` packs the
  unit -> warmable-backend-class mapping and per-class warm-up durations
  into device constants; this constructor reads the store's persisted
  trigger rows — no per-application host loop anywhere on the tick path.
* ``PrewarmPlan.from_triggers(app_ids, trigger, p_reach, now, table)`` —
  the same reduction from an explicit ``(A, B)`` device trigger matrix.
* ``PrewarmPlan.one_hop(graph, app_id, ...)`` — the original per-app
  immediate-successor planner, retained for the looped/composed refresh
  modes and as the closed-form oracle the batched plan is tested against.
* ``plan.merge(other, is_live)`` — dedup two plans on (app, class), newest
  trigger winning, dead apps pruned.

The former module-level entry points (``plan_from_store``,
``plan_from_triggers``, ``plan_prewarms``, ``merge_plans``) remain as
deprecated wrappers for one release.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pdgraph import ARRIVAL_NEVER, PDGraph, PackedKB


def quantile(samples: Sequence[float], q: float) -> float:
    s = np.asarray(samples, np.float64)
    if len(s) == 0:
        return 0.0
    return float(np.quantile(s, np.clip(q, 0.0, 1.0)))


def prewarm_trigger_time(unit_duration_samples: Sequence[float],
                         unit_start: float, now: float,
                         p_s: float, t_p: float, K: float) -> Optional[float]:
    """Absolute time to fire the prewarm signal, or None (don't prewarm).

    The duration distribution is conditioned on t_c > now (the unit is still
    running), mirroring the Gittins-style posterior update.
    """
    if p_s < K or t_p <= 0:
        return None if p_s < K else now
    s = np.asarray(unit_duration_samples, np.float64)
    if len(s) == 0:
        return now
    elapsed = max(now - unit_start, 0.0)
    tail = s[s > elapsed]
    if len(tail) == 0:
        return now  # unit outlived history; warm immediately
    # want P(t_c > t_s + t_p) = K/p_s  ->  remaining quantile at 1 - K/p_s
    q = 1.0 - K / p_s
    rem = np.quantile(tail - elapsed, np.clip(q, 0.0, 1.0))
    return max(now, now + float(rem) - t_p)


@dataclass
class PrewarmSignal:
    fire_at: float
    resource_key: str        # BackendSpec.resource_key() of the cold backend
    backend_kind: str        # llm | docker | dnn
    app_id: str
    unit: str                # downstream unit the warm-up is for
    p_s: float


def plan_prewarms(graph: PDGraph, app_id: str, current_unit: str,
                  unit_start: float, now: float, K: float,
                  warmup_time_of, is_warm, t_in: float, t_out: float
                  ) -> List[PrewarmSignal]:
    """Deprecated: use :meth:`PrewarmPlan.one_hop` (and its ``signals()``)."""
    _deprecated("plan_prewarms", "PrewarmPlan.one_hop(...).signals()")
    return list(PrewarmPlan.one_hop(graph, app_id, current_unit, unit_start,
                                    now, K, warmup_time_of, is_warm,
                                    t_in, t_out).signals())


def _deprecated(old: str, new: str) -> None:
    import warnings
    warnings.warn(f"repro.core.prewarm.{old} is deprecated; use {new}",
                  DeprecationWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# Batched device-resident planning (rides the fused refresh dispatch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PrewarmTable:
    """Unit -> warmable-backend-class mapping packed as device constants.

    A *backend class* is one distinct warmable resource key across the whole
    knowledge base (``kv:CG.plan``, ``lora:coder``, ``docker:python:...``).
    ``unit_class`` aligns with the PackedKB unit tables, so the fused
    pipeline can scatter per-(app, unit) arrival quantiles into
    per-(app, class) triggers without any host mapping step.  Docker keys
    stay unqualified here; the host qualifies them per application when
    executing the plan (container identity is (image, app))."""
    classes: Tuple[str, ...]     # (B,) resource keys
    kinds: Tuple[str, ...]       # (B,) backend kind per class
    unit_class: np.ndarray       # (G, U, Kc) int32 class ids, -1 = none
    warmup: np.ndarray           # (B,) float32 warm-up seconds per class

    @property
    def n_classes(self) -> int:
        return len(self.classes)


def build_prewarm_table(kb: Dict[str, PDGraph], packed: PackedKB,
                        warmup_time_of) -> PrewarmTable:
    """Pack every warmable resource key in the KB into a PrewarmTable
    aligned with ``packed``'s (G, U) unit tables."""
    per_unit: Dict[Tuple[int, int], Tuple[str, ...]] = {}
    kind_of: Dict[str, str] = {}
    for name in packed.names:
        g = packed.graph_index[name]
        uidx = packed.unit_index[g]
        for uname, node in kb[name].units.items():
            keys = node.backend.resource_keys()
            per_unit[(g, uidx[uname])] = keys
            for k in keys:
                kind_of[k] = node.backend.kind
    classes = tuple(sorted(kind_of))
    cid = {k: i for i, k in enumerate(classes)}
    G = len(packed.names)
    U = packed.n_units
    Kc = max((len(v) for v in per_unit.values()), default=1) or 1
    unit_class = np.full((G, U, Kc), -1, np.int32)
    for (g, u), keys in per_unit.items():
        for j, k in enumerate(keys):
            unit_class[g, u, j] = cid[k]
    warmup = np.asarray([warmup_time_of(k) for k in classes], np.float32)
    return PrewarmTable(classes=classes, kinds=tuple(kind_of[k] for k in classes),
                        unit_class=unit_class, warmup=warmup)


@dataclass
class PrewarmPlan:
    """A set of prewarm decisions: M (application, backend-class) triggers.

    The single prewarm-planning API (see module docstring): construct via
    :meth:`from_store` / :meth:`from_triggers` (batched device paths) or
    :meth:`one_hop` (legacy host path), combine via :meth:`merge`, and
    execute via :meth:`signals`.  ``fire_at`` is absolute; ``p_reach`` is
    the probability that the app ever needs the class (the MC reach
    probability for the batched paths, one-hop branch probability for
    ``one_hop``).  ``units`` names the downstream unit a trigger is for —
    the batched paths plan per backend class across ALL downstream units,
    recorded as ``"*"``."""
    app_ids: List[str]           # (M,)
    resource_keys: List[str]     # (M,) unqualified class keys
    kinds: List[str]             # (M,)
    fire_at: np.ndarray          # (M,) float64 absolute seconds
    p_reach: np.ndarray          # (M,) float32
    units: Optional[List[str]] = None   # (M,) downstream unit, "*" = any

    def __len__(self) -> int:
        return len(self.app_ids)

    def unit_of(self, i: int) -> str:
        return self.units[i] if self.units is not None else "*"

    def signals(self):
        for i in range(len(self.app_ids)):
            yield PrewarmSignal(fire_at=float(self.fire_at[i]),
                                resource_key=self.resource_keys[i],
                                backend_kind=self.kinds[i],
                                app_id=self.app_ids[i], unit=self.unit_of(i),
                                p_s=float(self.p_reach[i]))

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_store(cls, store, slots: np.ndarray, now: float,
                   table: "PrewarmTable") -> "PrewarmPlan":
        """Build one tick's plan from the slot store's persisted trigger rows.

        ``store`` is a :class:`repro.core.arena.QueueState`; ``slots`` names
        the rows whose ``trig``/``reach`` mirrors are fresh — the walked rows
        after an event-path refresh, or the WHOLE occupied set after a full
        delta/mesh tick (retriggering re-conditions every slot's trigger on
        elapsed service each tick).  This is also the cross-shard merge point
        of the mesh path: every shard's trigger rows land in the same host
        mirror, so one call assembles the mesh-wide plan — no per-application
        loop, no per-shard plan objects."""
        slots = np.asarray(slots, np.int64)
        app_ids = [store.ids[int(s)] for s in slots]
        return cls.from_triggers(app_ids, store.trig[slots],
                                 store.reach[slots], now, table)

    @classmethod
    def from_triggers(cls, app_ids: Sequence[str], trigger: np.ndarray,
                      p_reach: np.ndarray, now: float,
                      table: "PrewarmTable") -> "PrewarmPlan":
        """Vectorized (A, B) trigger matrix -> PrewarmPlan.

        ``trigger`` holds device-computed fire times relative to ``now``
        (>= ``ARRIVAL_NEVER/2`` meaning "do not prewarm"); negative relative
        triggers clip to `now` (warm-up can no longer finish in time but
        partial overlap still helps — same clip as the one-hop planner)."""
        trigger = np.asarray(trigger)
        a_idx, b_idx = np.nonzero(trigger < ARRIVAL_NEVER / 2)
        fire = now + np.maximum(trigger[a_idx, b_idx], 0.0)
        return cls(
            app_ids=[app_ids[a] for a in a_idx],
            resource_keys=[table.classes[b] for b in b_idx],
            kinds=[table.kinds[b] for b in b_idx],
            fire_at=np.asarray(fire, np.float64),
            p_reach=np.asarray(p_reach)[a_idx, b_idx].astype(np.float32))

    @classmethod
    def one_hop(cls, graph: PDGraph, app_id: str, current_unit: str,
                unit_start: float, now: float, K: float,
                warmup_time_of, is_warm, t_in: float, t_out: float
                ) -> "PrewarmPlan":
        """The legacy host planner: triggers for the cold backends of
        ``current_unit``'s *immediate* successors only, from the closed-form
        §3.4 quantile (``warmup_time_of(resource_key) -> seconds``;
        ``is_warm(key) -> bool``).  Retained for the looped/composed refresh
        modes and as the oracle the batched plan is tested against."""
        cur = graph.units[current_unit]
        dur = cur.service_samples(t_in, t_out)
        ids: List[str] = []
        keys: List[str] = []
        kinds: List[str] = []
        fires: List[float] = []
        p: List[float] = []
        units: List[str] = []
        for nxt, p_s in cur.next_probs().items():
            if nxt == "$end":
                continue
            unit = graph.units[nxt]
            for key in unit.backend.resource_keys():
                if is_warm(key):
                    continue
                t_p = warmup_time_of(key)
                fire = prewarm_trigger_time(dur, unit_start, now, p_s, t_p, K)
                if fire is not None:
                    ids.append(app_id)
                    keys.append(key)
                    kinds.append(unit.backend.kind)
                    fires.append(fire)
                    p.append(p_s)
                    units.append(nxt)
        return cls(app_ids=ids, resource_keys=keys, kinds=kinds,
                   fire_at=np.asarray(fires, np.float64),
                   p_reach=np.asarray(p, np.float32), units=units)

    # ----------------------------------------------------------------- merge
    def merge(self, plan: "PrewarmPlan", is_live) -> "PrewarmPlan":
        """Merge ``plan`` into this one, deduplicating on (app, class) with
        the NEWER trigger winning (later refreshes carry fresher arrival
        estimates) and pruning apps for which ``is_live(app_id)`` is False.
        The scheduler stashes successive per-tick/per-event plans through
        this, so the stash stays bounded by live-apps x classes however many
        refreshes land between two host takes."""
        merged: Dict[tuple, tuple] = {}
        for p in (self, plan):
            for i in range(len(p)):
                if is_live(p.app_ids[i]):
                    merged[(p.app_ids[i], p.resource_keys[i])] = \
                        (p.kinds[i], p.fire_at[i], p.p_reach[i],
                         p.unit_of(i))
        keys = list(merged)
        return PrewarmPlan(
            app_ids=[a for a, _ in keys],
            resource_keys=[k for _, k in keys],
            kinds=[merged[k][0] for k in keys],
            fire_at=np.asarray([merged[k][1] for k in keys], np.float64),
            p_reach=np.asarray([merged[k][2] for k in keys], np.float32),
            units=[merged[k][3] for k in keys])


def plan_from_store(store, slots: np.ndarray, now: float,
                    table: PrewarmTable) -> PrewarmPlan:
    """Deprecated: use :meth:`PrewarmPlan.from_store`."""
    _deprecated("plan_from_store", "PrewarmPlan.from_store")
    return PrewarmPlan.from_store(store, slots, now, table)


def plan_from_triggers(app_ids: Sequence[str], trigger: np.ndarray,
                       p_reach: np.ndarray, now: float,
                       table: PrewarmTable) -> PrewarmPlan:
    """Deprecated: use :meth:`PrewarmPlan.from_triggers`."""
    _deprecated("plan_from_triggers", "PrewarmPlan.from_triggers")
    return PrewarmPlan.from_triggers(app_ids, trigger, p_reach, now, table)


def merge_plans(prev: PrewarmPlan, plan: PrewarmPlan,
                is_live) -> PrewarmPlan:
    """Deprecated: use :meth:`PrewarmPlan.merge`."""
    _deprecated("merge_plans", "PrewarmPlan.merge")
    return prev.merge(plan, is_live)
