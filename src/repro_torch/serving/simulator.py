"""Discrete-event cluster simulator for paper-scale scheduling experiments.

Models: slot-based LLM engines (continuous batching abstracted as N
concurrent request slots), docker and DNN tool pools, warmable contents
(KV prefixes / LoRA / images / tool models) via HermesLet, bucket-period
priority refresh with preemption at bucket boundaries, and PDGraph-driven
prewarming.  The scheduler under test is the real ``HermesScheduler`` — the
simulator only supplies ground truth (pre-sampled trajectories) and time.

Two host engines share one drain loop (``SimConfig.engine``):

* ``calendar`` (default) — the array-native engine: a bucketed calendar
  queue over numpy arrays for events, vectorized ``lexsort`` waiting
  queues, batch admission (``HermesScheduler.on_arrivals`` →
  ``QueueState.admit_many``) and ranks consumed as one vector per refresh
  (``priorities_arrays``) scattered into a dense host rank column.
* ``heap`` — the seed's ``heapq`` event loop, per-app rank dicts and
  heap waiting queues.  **Deprecated**, as in the reference: constructing
  ``SimConfig(engine="heap")`` emits a :class:`DeprecationWarning`; it is
  kept as the bit-equivalence oracle of the calendar engine.

Both engines produce identical completion orders and ``SimResult`` stats
for the same trace.

This is the PyTorch counterpart of ``repro.serving.simulator``, host code
kept line for line; the scheduler's slot arena and walk kernel run on
``SimConfig.device`` (default ``cuda``).  ``warmup_model`` derives the
LLM-side warm-up costs from ``repro_torch.configs`` as the reference does,
for every configuration of its registry.
"""
from __future__ import annotations

import itertools
import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.apps.spec import trajectory_service
from repro_torch.apps.suite import T_IN, T_OUT
from repro_torch.apps.workload import AppInstance
from repro_torch.core.admission import (ADMIT, DEFER, SHED_DEFER_EXPIRED,
                                  SHED_HOPELESS_ENQUEUE, SHED_HOPELESS_MIDRUN,
                                  SHED_PRESSURE_REJECT, AdmissionConfig,
                                  AdmissionController, DegradeConfig,
                                  DegradeState)
from repro_torch.core.hermeslet import HermesLet
from repro_torch.core.pdgraph import PDGraph
from repro_torch.core.posterior import PosteriorConfig
from repro_torch.core.refresh_config import RefreshConfig
from repro_torch.core.scheduler import HermesScheduler
from repro_torch.runtime.fault_tolerance import (BackendStragglerWatchdog,
                                           FailureInjector, HeartbeatRegistry,
                                           requeue_backoff)
from repro_torch.serving.backends import Backend, FaultConfig, build_pools
from repro_torch.serving.events import (ENGINES, make_event_queue,
                                       make_wait_queue)


@dataclass
class SimConfig:
    n_llm_slots: int = 16
    n_docker_slots: int = 32   # containers run host-side (64-core testbed)
    n_dnn_slots: int = 3
    bucket_s: float = 1.0
    t_in: float = T_IN
    t_out: float = T_OUT
    policy: str = "gittins"
    K: float = 0.5
    refine: bool = True
    prewarm_mode: str = "hermes"    # hermes | epwq | lru
    preemptive: bool = True
    kv_capacity: int = 16
    lora_capacity: int = 10
    docker_capacity: int = 32
    dnn_capacity: int = 2
    mc_walkers: int = 256
    n_buckets: int = 10
    seed: int = 0
    # host event engine: "calendar" = the array-native calendar-queue
    # engine (the default and only supported engine); "heap" = the seed's
    # heapq loop — DEPRECATED, kept as the bit-equivalence oracle
    # (selecting it warns)
    engine: str = "calendar"
    # priority-refresh pipeline configuration: ONE validated RefreshConfig
    # (mode / walker / mesh_shards / delta_full_threshold /
    # queue_delay_correction — see repro_torch.core.refresh_config)
    refresh: Optional[RefreshConfig] = None
    # epwq prefetch window: how many upcoming trajectory units (starting at
    # the one being spawned) get their backend keys prefetched when tasks
    # enqueue.  1 = the CachedAttention-style current-unit-only baseline.
    epwq_window: int = 1
    # backend-pool cold/warm model: per-key warm-up seconds override the
    # Fig. 2 defaults; `warmup_model` derives the LLM-side (kv/lora) costs
    # from the repro.configs model zoo (explicit warmup_table entries win);
    # `keep_alive_s` is the speculative keep-alive eviction idle threshold
    warmup_table: Optional[Dict[str, float]] = None
    warmup_model: Optional[str] = None
    keep_alive_s: Optional[float] = None
    # overload survival (all three default OFF, leaving the simulator
    # bit-identical to the pre-pool behavior):
    #   faults    — split backend classes into pools of named members and
    #               drive a deterministic FaultEvent plan through them
    #               (crash/slow/recover + heartbeat orphan re-queue);
    #   admission — SLO-class deadline-aware admission/shedding with
    #               per-tenant fairness (repro.core.admission);
    #   degrade   — hysteresis pressure latch capping MC walker depth and
    #               routing best-effort LLM units to the small config
    faults: Optional[FaultConfig] = None
    admission: Optional[AdmissionConfig] = None
    degrade: Optional[DegradeConfig] = None
    # online posterior learning (repro_torch.core.posterior): unit
    # completions self-observe through on_unit_finish and fold into the
    # arena's posterior rows at the next delta tick.  None (default) keeps
    # the frozen prior; a PosteriorConfig requires fused_delta mode.
    posterior: Optional[PosteriorConfig] = None
    # where the scheduler's slot arena and walk kernel run: None = "cuda";
    # "cpu" runs the plain PyTorch versions
    device: Optional[str] = None
    # a torch.distributed process group of refresh.mesh_shards ranks: each
    # rank runs this simulation replicated and holds one arena shard
    process_group: Optional[Any] = None

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown sim engine {self.engine!r}; "
                             f"known: {ENGINES}")
        if self.engine == "heap":
            import warnings
            warnings.warn(
                "SimConfig(engine='heap') is deprecated and will be removed "
                "in the next release; the array-native engine='calendar' "
                "(the default) is the supported engine. The heap loop is "
                "retained only as the slow-tier bit-equivalence oracle.",
                DeprecationWarning, stacklevel=3)
        if self.refresh is None:
            self.refresh = RefreshConfig()


@dataclass(eq=False)   # identity equality: tasks are unique live objects,
class SimTask:         # and pool membership tests must not scan field-wise
    task_id: int
    app_id: str
    unit: str
    kind: str                  # llm | docker | dnn
    service: float
    keys: Tuple[str, ...]
    submitted: float
    remaining: float = 0.0
    running: bool = False
    ready_at: float = 0.0      # warm-up gate when running cold
    last_credit: float = 0.0
    epoch: int = 0             # invalidates stale completion events
    backend: Optional[Backend] = None   # pool member currently running it
    attempts: int = 0          # crash-orphan re-queue attempts (backoff key)
    wall_s: float = 0.0        # wall seconds actually run (straggler ratio)

    def __post_init__(self):
        self.remaining = self.service


@dataclass
class AppSim:
    inst: AppInstance
    unit_idx: int = 0
    open_tasks: int = 0
    finished: Optional[float] = None
    true_remaining: float = 0.0
    slo: str = "standard"
    shed_reason: Optional[str] = None
    initial_remaining: float = 0.0
    units_done: int = 0


@dataclass
class SimResult:
    acts: Dict[str, float]
    app_names: Dict[str, str]
    dsr: Dict[str, bool]
    ddl_class: Dict[str, str]
    cache_stats: Dict[str, Dict[str, float]]
    policy_time_s: float
    policy_calls: int
    makespan: float
    # cold-start consequences the caches can't see: stall seconds charged
    # to task starts, cold-hit counts, prewarm signals scheduled
    stall_stats: Dict[str, float] = field(default_factory=dict)
    # app ids in completion order (ties resolved by event order) — parity
    # with the reference compares this list verbatim
    completion_order: List[str] = field(default_factory=list)
    # overload-survival outcomes: SLO class of every application seen
    # (admitted or not), terminal shed reasons, completed units per app,
    # and the fault/admission/degradation counters
    slo: Dict[str, str] = field(default_factory=dict)
    shed: Dict[str, str] = field(default_factory=dict)
    units_done: Dict[str, int] = field(default_factory=dict)
    true_demand: Dict[str, float] = field(default_factory=dict)
    fault_stats: Dict[str, float] = field(default_factory=dict)
    admission_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)
    degrade_stats: Dict[str, float] = field(default_factory=dict)

    @property
    def prewarm_stats(self) -> Dict[str, float]:
        """Stall accounting + warm-cache aggregates in one view.  The cache
        sums are DERIVED from ``cache_stats`` here (single source) so the
        two can never disagree."""
        agg = {k: float(sum(c[k] for c in self.cache_stats.values()))
               for k in ("hits", "misses", "spec_loads", "spec_used",
                         "wasted_warm_s")}
        agg.update(self.stall_stats)
        return agg

    def act_values(self) -> np.ndarray:
        return np.asarray(sorted(self.acts.values()))

    def mean_act(self) -> float:
        return float(np.mean(list(self.acts.values()))) if self.acts else 0.0

    def p95_act(self) -> float:
        v = self.act_values()
        return float(np.percentile(v, 95)) if len(v) else 0.0

    def dsr_ratio(self, cls: Optional[str] = None) -> float:
        items = [(k, ok) for k, ok in self.dsr.items()
                 if cls is None or self.ddl_class.get(k) == cls]
        return (sum(ok for _, ok in items) / len(items)) if items else 0.0

    def goodput(self) -> float:
        """SLO-attaining completions per second of makespan: an application
        counts when it completed AND met its deadline (deadline-free
        applications count at completion).  Shed and timed-out work earns
        nothing — this is the metric shedding is graded on."""
        ok = sum(1 for a in self.acts if self.dsr.get(a, True))
        return ok / self.makespan if self.makespan > 0 else 0.0

    def goodput_service_s(self) -> float:
        """Useful service seconds delivered per second of makespan: the
        true demand of every SLO-attaining completion (capacity spent on
        shed or hopeless work does not count)."""
        if self.makespan <= 0:
            return 0.0
        tot = sum(self.true_demand.get(a, 0.0) for a in self.acts
                  if self.dsr.get(a, True))
        return tot / self.makespan

    def slo_attainment(self, cls: Optional[str] = None) -> float:
        """Fraction of ALL offered applications of the class (admitted,
        shed, or unfinished) that completed within their deadline."""
        apps = [a for a, c in self.slo.items() if cls is None or c == cls]
        if not apps:
            return 0.0
        ok = sum(1 for a in apps if a in self.acts and self.dsr.get(a, True))
        return ok / len(apps)


class ClusterSim:
    def __init__(self, kb: Dict[str, PDGraph], cfg: SimConfig):
        self.kb = kb
        self.cfg = cfg
        self.engine = cfg.engine
        warmup = {}
        if cfg.warmup_model:
            from repro_torch.core.hermeslet import warmup_table_from_model
            warmup.update(warmup_table_from_model(cfg.warmup_model))
        if cfg.warmup_table:
            warmup.update(cfg.warmup_table)
        self.warmup_table = warmup or None
        self.sched = HermesScheduler(
            kb, policy=cfg.policy, t_in=cfg.t_in, t_out=cfg.t_out, K=cfg.K,
            n_buckets=cfg.n_buckets, refine=cfg.refine,
            prewarm=(cfg.prewarm_mode == "hermes"),
            mc_walkers=cfg.mc_walkers, seed=cfg.seed,
            refresh=cfg.refresh,
            warmup_table=self.warmup_table,
            posterior=cfg.posterior, device=cfg.device,
            process_group=cfg.process_group)
        self.let = HermesLet(kv_capacity=cfg.kv_capacity,
                             lora_capacity=cfg.lora_capacity,
                             docker_capacity=cfg.docker_capacity,
                             dnn_capacity=cfg.dnn_capacity,
                             warmup_table=self.warmup_table,
                             keep_alive_s=cfg.keep_alive_s)
        self.slots = {"llm": cfg.n_llm_slots, "docker": cfg.n_docker_slots,
                      "dnn": cfg.n_dnn_slots}
        # fault-injected backend pools: each class splits into named
        # members (default one member per class = the classic monolithic
        # slot count, bit-identical behavior); the FailureInjector drives
        # the deterministic crash/slow/recover plan, the HeartbeatRegistry
        # detects dead members at tick granularity, and the straggler
        # watchdog feeds observed per-backend slowdown into the
        # scheduler's demand model
        fc = cfg.faults
        self.pools = build_pools(self.slots,
                                 fc.backend_counts() if fc else None)
        self.injector = FailureInjector(plan=fc.events) if fc else None
        self.heartbeats = HeartbeatRegistry(
            timeout_s=fc.heartbeat_timeout_s,
            clock=lambda: self.now) if fc else None
        self.watchdog = BackendStragglerWatchdog(
            threshold=fc.straggler_threshold,
            flag_after=fc.straggler_flag_after,
            clear_after=fc.straggler_clear_after) if fc else None
        self.admission = (AdmissionController(cfg.admission)
                          if cfg.admission is not None else None)
        self.degrade = (DegradeState(cfg.degrade)
                        if cfg.degrade is not None else None)
        self._inflight: Dict[str, SimTask] = {}  # heartbeat req id -> task
        self._shed: Dict[str, str] = {}          # app id -> shed reason
        self._defers: Dict[str, int] = {}        # app id -> defer count
        self._priors: Dict[str, Tuple[float, float]] = {}
        self._waiting_service = {k: 0.0 for k in self.slots}
        self.fault_counts = {"crashes": 0, "orphaned": 0, "requeued": 0,
                             "recovered": 0, "slow_events": 0,
                             "lost_service_s": 0.0}
        self._remaining = 0
        self._ai_next = 0
        # running pools are insertion-ordered dicts: iteration order matches
        # the seed's append/remove list exactly, but retire is O(1) instead
        # of an O(slots) field-wise list scan per completion
        self.running: Dict[str, Dict[SimTask, None]] = \
            {k: {} for k in self.slots}
        # waiting queues hold (rank_key, task) with keys snapshotted at push
        # time; keys go stale when ranks refresh, so full refreshes re-key
        # and rebuild each queue — a heapify of Python tuples on the heap
        # engine, one vectorized gather + lexsort on the calendar engine
        self.waiting = {k: make_wait_queue(self.engine) for k in self.slots}
        self.apps: Dict[str, AppSim] = {}
        self.events = make_event_queue(self.engine, bucket_s=cfg.bucket_s)
        self._tid = itertools.count()
        self.now = 0.0
        self.rng = np.random.default_rng(cfg.seed + 1)
        self.policy_time = 0.0
        self.policy_calls = 0
        # rank store: the heap engine keeps the seed's per-app dict; the
        # calendar engine keeps a dense float64 column indexed by a stable
        # per-app host index (assigned at arrival) that rank vectors from
        # priorities_arrays scatter into and waiting-queue rebuilds gather
        # from — no per-app boxing anywhere on the tick path
        self._ranks: Dict[str, float] = {}
        self._app_ai: Dict[str, int] = {}
        self._rank_arr = np.full(1024, np.inf)
        self._completions: List[str] = []
        self._prewarm_fired: Dict[Tuple[str, str, str], float] = {}
        # backend cold/warm consequences (surfaced in SimResult.prewarm_stats)
        self.coldstart_stall_s = 0.0   # task wall time spent waiting on loads
        self.coldstart_events = 0      # task starts that hit a cold backend
        self.prewarm_pushed = 0        # prewarm signals scheduled
        # mid-run progress credit is observable only through preemption,
        # progress-dependent ranks, demand-driven prewarm, or the overload
        # machinery's attained-service reads (see _on_tick)
        self._tick_credit = (cfg.preemptive
                             or cfg.prewarm_mode == "hermes"
                             or fc is not None
                             or self.admission is not None
                             or self.degrade is not None
                             or not getattr(self.sched.policy,
                                            "static_ranks", False))

    # ----------------------------------------------------------- event glue
    def _push(self, t: float, kind: str, payload=None):
        self.events.push(t, kind, payload)

    # -------------------------------------------------------------- running
    def run(self, instances: List[AppInstance]) -> SimResult:
        """Drive the trace to completion."""
        for inst in instances:
            self._push(inst.arrival, "arrival", inst)
        self._push(self.cfg.bucket_s, "tick", None)
        if self.injector is not None:
            for pool in self.pools.values():
                for b in pool:
                    self.heartbeats.beat(b.backend_id)
            for ev in self.injector.pending():
                self._push(ev.t, "fault", None)
        self._remaining = len(instances)

        while len(self.events) and self._remaining > 0:
            # micro-batch: drain EVERY event with this timestamp, then run
            # one rank refresh + one reschedule for the whole batch instead
            # of one per popped event (same-t arrivals/completions are the
            # norm under bursty traces and slot-width unit fan-out).
            t, batch = self.events.next_batch()
            self.now = max(self.now, t)
            touched: List[str] = []
            full_refresh = False
            spawns: List[AppSim] = []
            i, n = 0, len(batch)
            while i < n:
                kind, payload = batch[i]
                if kind == "arrival":
                    # consecutive arrivals admit as ONE batch (index-array
                    # admission on the slot store); handler order within
                    # the micro-batch is unchanged
                    j = i + 1
                    while j < n and batch[j][0] == "arrival":
                        j += 1
                    self._on_arrivals([p for _, p in batch[i:j]],
                                      touched, spawns)
                    i = j
                    continue
                if kind == "task_done":
                    task, epoch = payload
                    if task.epoch == epoch and task.running:
                        done = self._on_task_done(task, touched, spawns)
                        self._remaining -= int(done)
                elif kind == "prewarm":
                    self.let.prewarm(payload, self.now)
                elif kind == "fault":
                    for ev in self.injector.due(self.now):
                        self._apply_fault(ev)
                elif kind == "requeue":
                    self._on_requeue(payload, touched)
                elif kind == "deferred_arrival":
                    self._on_arrivals([payload], touched, spawns)
                elif kind == "tick":
                    self._on_tick()
                    full_refresh = True
                    if self._remaining > 0:
                        self._push(self.now + self.cfg.bucket_s, "tick", None)
                i += 1
            if full_refresh:
                self._refresh_ranks(touched=list(dict.fromkeys(touched)))
            elif touched:
                self._refresh_ranks(list(dict.fromkeys(touched)))
            for sim in spawns:          # enqueue with freshly-computed ranks
                if sim.finished is None:
                    self._spawn_unit(sim)
            self._reschedule()

        self.let.finalize(self.now)
        stall_stats = {
            "coldstart_stall_s": self.coldstart_stall_s,
            "coldstart_events": float(self.coldstart_events),
            "prewarm_pushed": float(self.prewarm_pushed),
        }
        return SimResult(
            acts={a: s.finished - s.inst.arrival
                  for a, s in self.apps.items() if s.finished is not None},
            app_names={a: s.inst.app_name for a, s in self.apps.items()},
            dsr={a: (s.inst.deadline is None or
                     (s.finished is not None and s.finished <= s.inst.deadline))
                 for a, s in self.apps.items() if s.inst.deadline is not None},
            ddl_class={a: s.inst.ddl_class for a, s in self.apps.items()},
            cache_stats=self.let.stats(),
            policy_time_s=self.policy_time,
            policy_calls=self.policy_calls,
            makespan=self.now,
            stall_stats=stall_stats,
            completion_order=list(self._completions),
            slo={a: s.slo for a, s in self.apps.items()},
            shed=dict(self._shed),
            units_done={a: s.units_done for a, s in self.apps.items()},
            true_demand={a: s.initial_remaining
                         for a, s in self.apps.items()},
            fault_stats=self._fault_stats(),
            admission_stats=(self.admission.stats()
                             if self.admission is not None else {}),
            degrade_stats=(self.degrade.stats()
                           if self.degrade is not None else {}))

    def _fault_stats(self) -> Dict[str, float]:
        if self.injector is None:
            return {}
        out = {k: float(v) for k, v in self.fault_counts.items()}
        out["straggler_flag_events"] = float(self.watchdog.flag_events)
        out["backends_dead"] = float(
            sum(1 for p in self.pools.values() for b in p if not b.alive))
        return out

    # --------------------------------------------------------------- events
    def _on_arrivals(self, insts: List[AppInstance], touched: List[str],
                     spawns: List[AppSim]):
        """Admit a same-timestamp arrival burst: per-app host bookkeeping,
        then ONE batched scheduler admission (``on_arrivals`` →
        ``admit_many``).  Equivalent to admitting one at a time in order."""
        from repro_torch.apps.spec import coldstart_overhead
        from repro_torch.apps.suite import SUITE
        if self.admission is not None:
            insts = [inst for inst in insts if self._admit(inst)]
            if not insts:
                return
        for inst in insts:
            sim = AppSim(inst=inst, slo=getattr(inst, "slo", "standard"))
            # true demand incl. expected cold starts (what the oracle of a
            # real system would know about wall cost)
            sim.true_remaining = trajectory_service(
                inst.trajectory, self.cfg.t_in, self.cfg.t_out)
            base_name = inst.app_name.split("#")[0]
            if base_name in SUITE:
                sim.true_remaining += coldstart_overhead(SUITE[base_name],
                                                         inst.trajectory,
                                                         self.warmup_table)
            sim.initial_remaining = sim.true_remaining
            self.apps[inst.app_id] = sim
            if self.engine == "calendar":
                # a monotone counter, NOT len(_app_ai): a deferred app
                # re-admits under its old id and must get a FRESH dense
                # index (len() would alias it with the next admission)
                ai = self._app_ai[inst.app_id] = self._ai_next
                self._ai_next += 1
                if ai >= len(self._rank_arr):
                    grown = np.full(2 * len(self._rank_arr), np.inf)
                    grown[:ai] = self._rank_arr
                    self._rank_arr = grown
        self.sched.on_arrivals(
            [(i.app_id, i.app_name, i.tenant, i.deadline) for i in insts],
            self.now)
        for inst in insts:
            sim = self.apps[inst.app_id]
            self.sched.set_oracle(inst.app_id, sim.true_remaining)
            if self.cfg.prewarm_mode == "hermes":
                # application viewpoint: arrival IS the signal for the entry
                # unit's backends (p_s = 1) — start loads in parallel with
                # the queue wait instead of at slot assignment
                g = self.kb[inst.app_name]
                for key in g.units[g.entry].backend.resource_keys():
                    self.let.prewarm(self._qualify(key, inst.app_id),
                                     self.now)
            touched.append(inst.app_id)
            spawns.append(sim)

    def _qualify(self, key: str, app_id: str) -> str:
        """Docker containers are per-application-run (the paper's code-exec
        model): the warmable identity is (image, app)."""
        return f"{key}@{app_id}" if key.startswith("docker:") else key

    # ------------------------------------------------- admission / shedding
    def _pressure(self) -> float:
        """Queue pressure: waiting LLM service seconds over live LLM
        capacity = estimated drain time of the backlog in service units."""
        cap = max(self.pools["llm"].capacity(), 1)
        return max(self._waiting_service.get("llm", 0.0), 0.0) / cap

    def _demand_prior(self, app_name: str) -> Tuple[float, float]:
        """(mean, optimistic/P10) prior of total service demand per app
        name — what a serving front door knows before any MC refresh ran.
        Names outside the suite get (0, 0): unknown apps are never shed at
        enqueue (synthetic-KB tests admit everything)."""
        cached = self._priors.get(app_name)
        if cached is not None:
            return cached
        import zlib

        from repro_torch.apps.spec import sample_trajectory
        from repro_torch.apps.suite import SUITE
        base = app_name.split("#")[0]
        if base in SUITE:
            rng = np.random.default_rng(
                (self.cfg.seed * 2654435761 + zlib.crc32(base.encode()))
                % (2 ** 32))
            draws = np.asarray(
                [trajectory_service(sample_trajectory(SUITE[base], rng),
                                    self.cfg.t_in, self.cfg.t_out)
                 for _ in range(64)])
            prior = (float(draws.mean()), float(np.percentile(draws, 10)))
        else:
            prior = (0.0, 0.0)
        self._priors[app_name] = prior
        return prior

    def _admit(self, inst: AppInstance) -> bool:
        """Enqueue-time admission: returns True when the instance should be
        admitted now; sheds and deferrals are fully handled here."""
        adm = self.admission
        slo = getattr(inst, "slo", "standard")
        mean_d, opt_d = self._demand_prior(inst.app_name)
        sd = self.sched.service_slowdown("llm")   # straggler-stretched
        pressure = self._pressure()
        est_wait = pressure * sd
        decision = adm.admit(inst.app_id, inst.tenant, slo,
                             deadline=inst.deadline, now=self.now,
                             opt_demand=opt_d * sd, mean_demand=mean_d,
                             est_wait=est_wait, pressure=pressure)
        if decision == ADMIT:
            return True
        if decision == DEFER:
            k = self._defers.get(inst.app_id, 0) + 1
            self._defers[inst.app_id] = k
            retry = self.now + requeue_backoff(k, adm.cfg.defer_backoff_s,
                                               adm.cfg.defer_backoff_cap_s)
            if k <= adm.cfg.max_defers and \
                    (inst.deadline is None or retry < inst.deadline):
                self._push(retry, "deferred_arrival", inst)
                return False
            reason = SHED_DEFER_EXPIRED
        elif adm.spec(slo).shed_hopeless and adm.hopeless(
                inst.deadline, self.now, opt_d * sd, extra_wait=est_wait):
            reason = SHED_HOPELESS_ENQUEUE
        else:
            reason = SHED_PRESSURE_REJECT
        self._shed_at_enqueue(inst, reason)
        return False

    def _shed_at_enqueue(self, inst: AppInstance, reason: str) -> None:
        """Terminal shed before admission: the app is recorded (for SLO
        attainment accounting) but never reaches the scheduler."""
        sim = AppSim(inst=inst, slo=getattr(inst, "slo", "standard"))
        sim.shed_reason = reason
        self.apps[inst.app_id] = sim
        self._shed[inst.app_id] = reason
        self._remaining -= 1

    def _drop_tasks(self, app_id: str) -> None:
        """Remove every queued and running task of one application: eager
        waiting-queue discard plus preemption-without-requeue; the epoch
        bumps turn any in-flight completion events into no-ops."""
        only = {app_id}
        for kind, wq in self.waiting.items():
            for t in wq.discard(only):
                self._waiting_service[kind] -= t.remaining
                t.epoch += 1
        for kind, pool in self.running.items():
            for t in [t for t in pool if t.app_id == app_id]:
                t.running = False
                t.epoch += 1
                del pool[t]
                self._release_backend(t)
        # crash-orphaned tasks awaiting re-queue drop at the requeue guard

    def _shed_app(self, app_id: str, reason: str) -> None:
        """Mid-run terminal shed: tasks dropped, arena slot retired exactly
        once, fairness account debited, the app never completes."""
        sim = self.apps.get(app_id)
        if sim is None or sim.finished is not None or app_id in self._shed:
            return
        self._shed[app_id] = reason
        sim.shed_reason = reason
        self._drop_tasks(app_id)
        if self.admission is not None:
            self.admission.note_exit(app_id)
        self.sched.on_app_shed(app_id)
        self._ranks.pop(app_id, None)
        self._remaining -= 1

    def _defer_midrun(self, app_id: str) -> None:
        """Non-terminal mid-run deferral of a zero-progress application:
        its tasks and arena slot are released and the ORIGINAL instance
        re-enters admission after a capped backoff (or sheds terminally
        when the defer budget / deadline lapses)."""
        sim = self.apps.get(app_id)
        if sim is None or sim.finished is not None or app_id in self._shed:
            return
        adm = self.admission
        k = self._defers.get(app_id, 0) + 1
        self._defers[app_id] = k
        retry = self.now + requeue_backoff(k, adm.cfg.defer_backoff_s,
                                           adm.cfg.defer_backoff_cap_s)
        inst = sim.inst
        self._drop_tasks(app_id)
        self.sched.on_app_shed(app_id)
        self._ranks.pop(app_id, None)
        del self.apps[app_id]
        if k <= adm.cfg.max_defers and \
                (inst.deadline is None or retry < inst.deadline):
            self._push(retry, "deferred_arrival", inst)
        else:
            self._shed_at_enqueue(inst, SHED_DEFER_EXPIRED)

    def _tick_admission(self) -> None:
        """Mid-run sweep: hopeless apps shed terminally; zero-progress
        best-effort work of over-share tenants defers under pressure.  The
        optimistic total comes from the arena's device triage scalar when
        the fused pipeline maintains one, else the per-name prior."""
        pressure = self._pressure()
        rows = []
        for app_id, sim in self.apps.items():
            if sim.finished is not None or app_id in self._shed:
                continue
            # the SAME instance-level estimate the policies' hopeless gate
            # reads (MC demand conditioned on actual progress); the
            # name-level prior only covers apps with no view yet
            triage = self.sched.demand_triage(app_id)
            if triage is not None:
                attained, opt_total = triage
            else:
                attained = max(sim.initial_remaining - sim.true_remaining,
                               0.0)
                _, opt_total = self._demand_prior(sim.inst.app_name)
            rows.append((app_id, sim.inst.tenant, sim.slo,
                         sim.inst.deadline, attained, opt_total,
                         sim.inst.arrival))
        shed_ids, defer_ids = self.admission.midrun_sheds(rows, self.now,
                                                          pressure)
        for app_id in shed_ids:
            self._shed_app(app_id, SHED_HOPELESS_MIDRUN)
        for app_id in defer_ids:
            self._defer_midrun(app_id)

    # ------------------------------------------------------- fault handling
    def _release_backend(self, task: SimTask) -> None:
        b = task.backend
        if b is None:
            return
        b.running -= 1
        task.backend = None
        if self.heartbeats is not None:
            self.heartbeats.complete(b.backend_id, str(task.task_id))
            self._inflight.pop(str(task.task_id), None)

    def _apply_fault(self, ev) -> None:
        pool = self.pools.get(ev.pool)
        if pool is None:
            return
        b = pool[ev.backend]
        if ev.kind == "crash":
            if not b.alive:
                return
            b.alive = False
            b.crashes += 1
            self.fault_counts["crashes"] += 1
            for task in [t for t in self.running[ev.pool]
                         if t.backend is b]:
                self._orphan(task)
        elif ev.kind == "slow":
            self.fault_counts["slow_events"] += 1
            mine = [t for t in self.running[ev.pool] if t.backend is b]
            for t in mine:
                self._credit(t)            # progress so far at the old rate
            b.slowdown = float(ev.slowdown)
            for t in mine:                 # re-time the remaining work
                t.epoch += 1
                self._push(max(self.now, t.ready_at)
                           + t.remaining * b.slowdown,
                           "task_done", (t, t.epoch))
        elif ev.kind == "recover":
            self.fault_counts["recovered"] += 1
            if not b.alive and self.heartbeats is not None:
                # a recovery races detection: any orphans the reaper never
                # saw are re-queued now (recovery IS the detection)
                info = self.heartbeats.engines.get(b.backend_id)
                for rid in sorted(info.inflight) if info else []:
                    info.inflight.discard(rid)
                    self._requeue_later(rid)
            was_slow = b.alive and b.slowdown > 1.0
            mine = ([t for t in self.running[ev.pool] if t.backend is b]
                    if was_slow else [])
            for t in mine:
                self._credit(t)
            b.alive = True
            b.slowdown = 1.0
            if self.heartbeats is not None:
                self.heartbeats.beat(b.backend_id)
            for t in mine:
                t.epoch += 1
                self._push(max(self.now, t.ready_at) + t.remaining,
                           "task_done", (t, t.epoch))

    def _orphan(self, task: SimTask) -> None:
        """A crash killed the member under a running task: progress since
        the last credit is lost (at-least-once redo), the stale completion
        event dies on the epoch bump, and the heartbeat reaper re-queues
        the unit after detection + capped exponential backoff."""
        start = max(task.last_credit, task.ready_at)
        lost_wall = max(self.now - start, 0.0)
        sd = task.backend.slowdown if task.backend is not None else 1.0
        self.fault_counts["lost_service_s"] += lost_wall / sd
        self.fault_counts["orphaned"] += 1
        task.running = False
        task.epoch += 1
        task.attempts += 1
        del self.running[task.kind][task]
        if task.backend is not None:
            task.backend.running -= 1
            task.backend = None
        # the id stays in the dead member's heartbeat inflight set so
        # reap_dead() surfaces it once the timeout lapses

    def _requeue_later(self, rid: str) -> None:
        task = self._inflight.pop(rid, None)
        if task is None:
            return
        fc = self.cfg.faults
        delay = requeue_backoff(task.attempts, fc.requeue_backoff_s,
                                fc.requeue_backoff_cap_s)
        self.fault_counts["requeued"] += 1
        self._push(self.now + delay, "requeue", task)

    def _on_requeue(self, task: SimTask, touched: List[str]) -> None:
        """At-least-once re-entry of an orphaned unit.  Idempotent by
        construction: the task object carries its credited remaining
        service, the epoch bump at orphan time killed the stale completion
        event, and shed/finished apps drop here."""
        app = self.apps.get(task.app_id)
        if app is None or app.finished is not None \
                or task.app_id in self._shed:
            return
        self.sched.on_requeue(task.app_id, self.now)
        self._enqueue(task)
        touched.append(task.app_id)

    def _tick_faults(self) -> None:
        for pool in self.pools.values():
            for b in pool:
                if b.alive:
                    self.heartbeats.beat(b.backend_id)
        for rid in self.heartbeats.reap_dead():
            self._requeue_later(rid)

    def _spawn_unit(self, sim: AppSim):
        unit, obs = sim.inst.trajectory[sim.unit_idx]
        g = self.kb[sim.inst.app_name]
        backend = g.units[unit].backend
        self.sched.on_unit_start(sim.inst.app_id, unit, self.now)
        if backend.kind == "llm":
            per_task = obs["in"] * self.cfg.t_in + obs["out"] * self.cfg.t_out
            n = int(obs["par"])
            if self.degrade is not None and self.degrade.active:
                degradable = (self.admission.spec(sim.slo).degradable
                              if self.admission is not None
                              else sim.slo == "best_effort")
                if degradable:
                    # route this unit's decodes to the smaller config: less
                    # true service to burn, tracked so goodput accounting
                    # can attribute the saved seconds to degradation
                    full = per_task
                    per_task /= self.degrade.speedup
                    saved = (full - per_task) * n
                    self.degrade.degraded_units += n
                    self.degrade.saved_service_s += saved
                    sim.true_remaining = max(sim.true_remaining - saved, 0.0)
                    self.sched.set_oracle(sim.inst.app_id,
                                          sim.true_remaining)
        else:
            per_task, n = obs["dur"], 1
        sim.open_tasks = n
        keys = tuple(self._qualify(k, sim.inst.app_id)
                     for k in backend.resource_keys())
        for _ in range(n):
            task = SimTask(task_id=next(self._tid), app_id=sim.inst.app_id,
                           unit=unit, kind=backend.kind, service=per_task,
                           keys=keys, submitted=self.now)
            self._enqueue(task)
        if self.cfg.prewarm_mode == "epwq":
            # prefetch for queued requests only, looking `epwq_window`
            # trajectory units ahead (window=1: the spawned unit alone —
            # the CachedAttention-style baseline)
            stop = min(sim.unit_idx + max(self.cfg.epwq_window, 1),
                       len(sim.inst.trajectory))
            for j in range(sim.unit_idx, stop):
                u_j = g.units[sim.inst.trajectory[j][0]]
                for key in u_j.backend.resource_keys():
                    key = self._qualify(key, sim.inst.app_id)
                    if not self.let.is_present(key):
                        self.let.prewarm(key, self.now)
        self._plan_prewarms(sim.inst.app_id)

    def _plan_prewarms(self, app_id: str):
        """Legacy per-app one-hop planning — only for the non-fused refresh
        modes; in fused mode the batched PrewarmPlan from the refresh
        dispatch covers every downstream unit (``_apply_prewarm_plan``)."""
        if self.cfg.prewarm_mode != "hermes" or self.sched.prewarm_batched:
            return
        sigs = self.sched.prewarm_signals(
            app_id, self.now, self.let.warmup_time,
            lambda k: self.let.is_present(self._qualify(k, app_id)))
        self._push_signals(sigs)

    def _apply_prewarm_plan(self):
        """Consume the batched PrewarmPlan computed inside the last fused
        refresh dispatch (one plan per tick, all apps at once)."""
        plan = self.sched.take_prewarm_plan()
        if plan is not None:
            self._push_signals(plan.signals())

    def _push_signals(self, sigs):
        # dedupe per (app, unit, key) so each tick's recomputed triggers
        # don't flood the event queue, with two escape hatches: the tag
        # expires one keep-alive after the recorded fire time (a key evicted
        # after long idle can be re-prewarmed on unit revisits), and a
        # CORRECTED earlier trigger always goes through (fresher estimates
        # pull the fire time in; the stale later event becomes a join no-op)
        keep_alive = self.let.caches["kv"].spec_evict_idle_s
        for s in sigs:
            key = self._qualify(s.resource_key, s.app_id)
            tag = (s.app_id, s.unit, key)
            fire = max(s.fire_at, self.now)
            last = self._prewarm_fired.get(tag)
            if last is not None and fire >= last - 1e-9 \
                    and self.now <= last + keep_alive:
                continue
            self._prewarm_fired[tag] = fire if last is None \
                else min(last, fire)
            self.prewarm_pushed += 1
            self._push(fire, "prewarm", key)

    def _credit(self, task: SimTask):
        if not task.running:
            return
        start = max(task.last_credit, task.ready_at)
        delta = max(self.now - start, 0.0)
        if delta > 0:
            task.wall_s += delta
            # wall seconds convert to service seconds at the member's rate
            # (division by 1.0 is exact: fault-free runs stay bit-identical)
            sd = task.backend.slowdown if task.backend is not None else 1.0
            svc = delta / sd
            task.remaining = max(task.remaining - svc, 0.0)
            self.sched.on_progress(task.app_id, svc)
            sim = self.apps[task.app_id]
            sim.true_remaining = max(sim.true_remaining - svc, 0.0)
            self.sched.set_oracle(task.app_id, sim.true_remaining)
        task.last_credit = self.now

    def _on_task_done(self, task: SimTask, touched: List[str],
                      spawns: List[AppSim]) -> bool:
        """Returns True when the whole application finished."""
        self._credit(task)
        task.running = False
        del self.running[task.kind][task]
        b = task.backend
        self._release_backend(task)
        if b is not None:
            b.note_completion(task.service, task.wall_s)
        if self.watchdog is not None and b is not None and task.service > 0:
            flagged = self.watchdog.observe(b.backend_id,
                                            task.wall_s / task.service)
            self.sched.observe_backend_slowdown(
                b.backend_id,
                self.watchdog.slowdown(b.backend_id) if flagged else 1.0)
        sim = self.apps[task.app_id]
        sim.open_tasks -= 1
        if sim.open_tasks > 0:
            return False
        # unit complete
        sim.units_done += 1
        unit, obs = sim.inst.trajectory[sim.unit_idx]
        sim.unit_idx += 1
        nxt = (sim.inst.trajectory[sim.unit_idx][0]
               if sim.unit_idx < len(sim.inst.trajectory) else None)
        self.sched.on_unit_finish(task.app_id, unit, obs, self.now, nxt)
        if nxt is None:
            sim.finished = self.now
            self._completions.append(task.app_id)
            self._ranks.pop(task.app_id, None)
            if self.admission is not None:
                self.admission.note_exit(task.app_id)
            return True
        touched.append(task.app_id)
        spawns.append(sim)
        return False

    def _on_tick(self):
        # per-tick progress crediting exists for readers of mid-run attained
        # service: preemption (task.remaining), rank policies whose priority
        # moves with progress, and the PDGraph prewarm planner's demand
        # views.  When none of those can read it — admission-fixed ranks,
        # non-preemptive, no demand-driven prewarm — each task's full credit
        # still lands at completion, so skip the O(running) sweep
        if not self._tick_credit:
            return
        for pool in self.running.values():
            for task in pool:
                self._credit(task)
        if self.injector is not None:
            self._tick_faults()
        if self.admission is not None:
            self._tick_admission()
        if self.degrade is not None:
            was = self.degrade.active
            if self.degrade.update(self._pressure()) != was:
                self.sched.set_walker_cap(
                    self.degrade.cfg.walker_cap
                    if self.degrade.active else None)

    def _refresh_ranks(self, app_ids=None, touched=None):
        """Full queue refresh on bucket ticks (stale waiting keys re-keyed
        and rebuilt; ``touched`` carries the app ids the batch's events hit
        so fast paths know what could have moved).  Between ticks, policies
        whose ranks depend only on the app's own state re-rank just the
        applications an event touched; policies with cross-app or
        time-dependent ranks (VTC counters, deadline slack) keep the seed's
        full re-rank on every event."""
        t0 = _time.perf_counter()
        policy = self.sched.policy
        subset = app_ids is not None and \
            getattr(policy, "independent_ranks", True)
        task_level = getattr(policy, "task_level", False)
        static = getattr(policy, "static_ranks", False) and \
            getattr(policy, "independent_ranks", True)
        if self.engine == "calendar":
            if subset:
                sel = app_ids
            elif static:
                # admission-fixed ranks: a full tick can only have NEW rows
                # to write (this batch's arrivals/transitions); everything
                # already in the column is final
                sel = touched or []
            else:
                sel = None
            if sel is None or sel:
                ids, ranks = self.sched.priorities_arrays(self.now, sel)
                if ids:
                    idx = np.fromiter((self._app_ai[i] for i in ids),
                                      np.int64, count=len(ids))
                    self._rank_arr[idx] = ranks
            if not subset and not task_level and not static:
                # task-level keys are rank-independent and static ranks are
                # push-time-final: those queues never need re-keying;
                # everyone else re-keys in one gather
                for wq in self.waiting.values():
                    wq.rebuild(self._rank_arr)
        else:
            if subset:
                self._ranks.update(self.sched.priorities(self.now,
                                                         app_ids=app_ids))
            else:
                self._ranks = self.sched.priorities(self.now)
                for wq in self.waiting.values():
                    wq.rebuild(self._task_rank)
        self.policy_time += _time.perf_counter() - t0
        self.policy_calls += 1
        if self.sched.prewarm_batched:
            self._apply_prewarm_plan()

    # ------------------------------------------------------------ scheduling
    def _task_rank(self, task: SimTask) -> Tuple[float, float, int]:
        if getattr(self.sched.policy, "task_level", False):
            return (task.submitted, task.task_id, 0)
        if self.engine == "calendar":
            r = float(self._rank_arr[self._app_ai[task.app_id]])
        else:
            r = self._ranks.get(task.app_id, np.inf)
        return (r, task.submitted, task.task_id)

    def _enqueue(self, task: SimTask):
        self._waiting_service[task.kind] += task.remaining
        ai = self._app_ai[task.app_id] if self.engine == "calendar" else -1
        self.waiting[task.kind].push(self._task_rank(task), task, ai)

    def _pop_live(self, wq, kind: str) -> Optional[SimTask]:
        """Pop the highest-priority waiting task that still belongs to a
        live application (shed apps discard their queue entries eagerly;
        this guard is the belt to that suspenders)."""
        while len(wq):
            task = wq.pop()
            self._waiting_service[kind] -= task.remaining
            if task.app_id in self._shed:
                continue
            return task
        return None

    def _start(self, task: SimTask) -> bool:
        b = self.pools[task.kind].place()
        if b is None:                  # every pool member dead or saturated
            self._enqueue(task)
            return False
        if self.cfg.refresh.queue_delay_correction:
            self.sched.observe_queue_wait(
                task.app_id, self.now - task.submitted, task.service)
        ready = self.now
        for key in task.keys:
            hit, key_ready = self.let.access(key, self.now)
            ready = max(ready, key_ready)
        if ready > self.now:           # cold (or still-loading) backend stall
            self.coldstart_stall_s += ready - self.now
            self.coldstart_events += 1
        task.running = True
        task.ready_at = ready
        task.last_credit = self.now
        task.epoch += 1
        task.backend = b
        b.running += 1
        if self.heartbeats is not None:
            self.heartbeats.assign(b.backend_id, str(task.task_id))
            self._inflight[str(task.task_id)] = task
        self.running[task.kind][task] = None
        # multiplication by 1.0 is exact: healthy members keep the event
        # times (and therefore every downstream tie-break) bit-identical
        self._push(ready + task.remaining * b.slowdown, "task_done",
                   (task, task.epoch))
        return True

    def _preempt(self, task: SimTask):
        self._credit(task)
        task.running = False
        task.epoch += 1
        del self.running[task.kind][task]
        self._release_backend(task)
        self._enqueue(task)

    def _reschedule(self):
        for kind in self.slots:
            wq = self.waiting[kind]
            # fill free slots (live capacity: dead members don't count)
            while len(wq) and \
                    len(self.running[kind]) < self.pools[kind].capacity():
                task = self._pop_live(wq, kind)
                if task is None or not self._start(task):
                    break
            if not self.cfg.preemptive or not len(wq):
                continue
            # preempt: lowest-priority running vs highest-priority waiting
            while len(wq):
                run = self.running[kind]
                victim = max(run, key=self._task_rank, default=None)
                if victim is None or victim.ready_at > self.now:
                    break
                if wq.peek_key() < self._task_rank(victim):
                    self._preempt(victim)
                    task = self._pop_live(wq, kind)
                    if task is None or not self._start(task):
                        break
                else:
                    break


def run_sim(kb: Dict[str, PDGraph], instances: List[AppInstance],
            cfg: SimConfig) -> SimResult:
    return ClusterSim(kb, cfg).run(instances)
