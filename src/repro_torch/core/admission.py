"""SLO-class admission, shedding, and load-adaptive degradation.

The hermes_ddl/lstf composite policies already compute a three-way triage on
device (SUP_Q worst-case and HOPELESS_Q optimistic demand quantiles per
application); this module turns that triage into an *admission* policy: an
application whose deadline is missed even at the optimistic quantile is a
lost cause, and serving it burns capacity that salvageable applications
need.  Under overload the scheduler therefore

* **sheds** hopeless applications — at enqueue (estimated queue wait plus
  optimistic demand already misses the deadline) or mid-run (progress and
  queue drift made it hopeless later);
* **defers** best-effort work beyond a tenant's fair share when queue
  pressure crosses a watermark — deferred applications re-enter admission
  after a capped exponential backoff (the arena slot is retired on shed and
  a fresh one admitted on requeue), so a flash crowd from one tenant queues
  behind everyone else instead of starving them;
* **degrades** gracefully: past a hysteresis pressure threshold the
  MC-refinement walker depth is capped and best-effort LLM units route to a
  smaller model config from the ``repro_torch.configs`` zoo, restoring full
  quality when pressure drains.

Three SLO classes ship by default (see ``DEFAULT_SLO_CLASSES``):

=============  ============  =============  ==============  ===========
class          admit          shed hopeless  pressure defer  degradable
=============  ============  =============  ==============  ===========
gold           always        never          never           no
standard       always        yes            never           no
best_effort    pressure-gated yes           yes (backoff)   yes
=============  ============  =============  ==============  ===========
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

GOLD = "gold"
STANDARD = "standard"
BEST_EFFORT = "best_effort"


@dataclass(frozen=True)
class SLOClassSpec:
    """Admission/shedding behavior of one SLO class.

    shed_hopeless
        Applications of this class whose deadline is infeasible even at the
        optimistic demand quantile are shed (terminal).
    admit_pressure_max
        New arrivals are rejected outright when queue pressure exceeds
        this (``inf`` = always admitted).
    deferrable
        Under pressure, zero-progress applications of this class beyond
        their tenant's fair share are shed *non-terminally* and re-enter
        admission after a backoff.
    degradable
        LLM units of this class may route to the smaller degrade config
        while the cluster is in the degraded regime.
    """
    name: str
    shed_hopeless: bool = True
    admit_pressure_max: float = float("inf")
    deferrable: bool = False
    degradable: bool = False


DEFAULT_SLO_CLASSES: Dict[str, SLOClassSpec] = {
    GOLD: SLOClassSpec(GOLD, shed_hopeless=False),
    STANDARD: SLOClassSpec(STANDARD, shed_hopeless=True),
    BEST_EFFORT: SLOClassSpec(BEST_EFFORT, shed_hopeless=True,
                              admit_pressure_max=8.0, deferrable=True,
                              degradable=True),
}


@dataclass(frozen=True)
class AdmissionConfig:
    """Admission/shedding knobs for :class:`AdmissionController`.

    pressure_watermark
        Queue pressure (waiting LLM service seconds over live capacity —
        i.e. estimated drain time in service units) past which fairness
        deferral engages.  Hopeless shedding is always on.
    fair_share_slack
        A tenant may hold up to ``slack x (live demand / active tenants)``
        before its deferrable applications are pushed out under pressure.
    defer_backoff_s / defer_backoff_cap_s / max_defers
        Capped exponential re-admission backoff; an application deferred
        more than ``max_defers`` times (or whose deadline lapses while
        parked) is shed terminally.
    hopeless_grace_s
        Slack below which an application counts as hopeless — 0 is the
        pure "optimistic quantile already misses" test; positive values
        shed earlier.
    """
    classes: Tuple[Tuple[str, SLOClassSpec], ...] = tuple(
        sorted(DEFAULT_SLO_CLASSES.items()))
    pressure_watermark: float = 2.0
    fair_share_slack: float = 1.5
    defer_backoff_s: float = 2.0
    defer_backoff_cap_s: float = 16.0
    max_defers: int = 3
    hopeless_grace_s: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "classes", tuple(self.classes))
        if self.pressure_watermark < 0:
            raise ValueError("pressure_watermark must be >= 0")
        if self.fair_share_slack < 1.0:
            raise ValueError("fair_share_slack must be >= 1.0")

    def class_table(self) -> Dict[str, SLOClassSpec]:
        return dict(self.classes)


# Shed reasons recorded per application (SimResult.shed values).
SHED_HOPELESS_ENQUEUE = "hopeless_enqueue"
SHED_HOPELESS_MIDRUN = "hopeless_midrun"
SHED_PRESSURE_REJECT = "pressure_reject"
SHED_DEFER_EXPIRED = "defer_expired"

ADMIT, SHED, DEFER = "admit", "shed", "defer"


@dataclass
class _TenantAccount:
    live_demand: float = 0.0     # admitted mean service seconds in flight
    admitted: int = 0
    shed: int = 0
    deferred: int = 0


class AdmissionController:
    """Deadline-aware admission with per-tenant fairness accounting.

    The host (simulator or serving loop) drives it with *demand estimates*:
    at enqueue these come from the per-app-name PDGraph prior; mid-run from
    the arena's device-computed triage scalars.  All estimates are service
    seconds; the host multiplies in any backend slowdown before calling.
    """

    def __init__(self, cfg: Optional[AdmissionConfig] = None):
        self.cfg = cfg or AdmissionConfig()
        self.classes = self.cfg.class_table()
        self.tenants: Dict[str, _TenantAccount] = {}
        # per-app live demand, so exits debit exactly what admission credited
        self._app_demand: Dict[str, Tuple[str, float]] = {}
        self.decisions: Dict[str, int] = {ADMIT: 0, SHED: 0, DEFER: 0}

    def spec(self, slo: str) -> SLOClassSpec:
        return self.classes.get(slo, self.classes[STANDARD])

    # ------------------------------------------------------------- accounting
    def _account(self, tenant: str) -> _TenantAccount:
        acct = self.tenants.get(tenant)
        if acct is None:
            acct = self.tenants[tenant] = _TenantAccount()
        return acct

    def note_admitted(self, app_id: str, tenant: str,
                      mean_demand: float) -> None:
        acct = self._account(tenant)
        acct.live_demand += mean_demand
        acct.admitted += 1
        self._app_demand[app_id] = (tenant, mean_demand)

    def note_exit(self, app_id: str) -> None:
        """Completion, terminal shed, or deferral: the app no longer holds
        live demand.  Idempotent — a second exit for the same id is a no-op
        (this is what keeps accounting stable across requeue races)."""
        rec = self._app_demand.pop(app_id, None)
        if rec is None:
            return
        tenant, demand = rec
        acct = self._account(tenant)
        acct.live_demand = max(acct.live_demand - demand, 0.0)

    def live_demand(self, tenant: str) -> float:
        acct = self.tenants.get(tenant)
        return acct.live_demand if acct else 0.0

    def fair_share(self) -> float:
        """Per-tenant fair share of the live admitted demand."""
        live = [a.live_demand for a in self.tenants.values()
                if a.live_demand > 0.0]
        if not live:
            return float("inf")
        return sum(live) / len(live)

    def over_share(self, tenant: str) -> bool:
        share = self.fair_share()
        if share == float("inf"):
            return False
        return self.live_demand(tenant) > self.cfg.fair_share_slack * share

    # -------------------------------------------------------------- decisions
    def hopeless(self, deadline: Optional[float], now: float,
                 opt_remaining: float, extra_wait: float = 0.0) -> bool:
        """True when even the optimistic (HOPELESS_Q) remaining demand plus
        any estimated wait overshoots the deadline."""
        if deadline is None:
            return False
        slack = deadline - now - max(opt_remaining, 0.0) - max(extra_wait, 0.0)
        return slack < self.cfg.hopeless_grace_s

    def admit(self, app_id: str, tenant: str, slo: str, *,
              deadline: Optional[float], now: float,
              opt_demand: float, mean_demand: float,
              est_wait: float, pressure: float) -> str:
        """Enqueue-time decision: ADMIT, SHED (terminal) or DEFER.

        ``opt_demand``/``mean_demand`` are prior estimates of this
        application's total service; ``est_wait`` the estimated queue wait
        before it first runs; ``pressure`` the current queue pressure.
        """
        spec = self.spec(slo)
        acct = self._account(tenant)
        if spec.shed_hopeless and self.hopeless(deadline, now, opt_demand,
                                                extra_wait=est_wait):
            acct.shed += 1
            self.decisions[SHED] += 1
            return SHED
        if pressure > spec.admit_pressure_max:
            acct.shed += 1
            self.decisions[SHED] += 1
            return SHED
        if (spec.deferrable and pressure > self.cfg.pressure_watermark
                and self.over_share(tenant)):
            acct.deferred += 1
            self.decisions[DEFER] += 1
            return DEFER
        self.decisions[ADMIT] += 1
        self.note_admitted(app_id, tenant, mean_demand)
        return ADMIT

    def midrun_sheds(self, rows: Sequence[tuple], now: float,
                     pressure: float) -> Tuple[List[str], List[str]]:
        """Mid-run sweep over live applications.

        ``rows`` is a sequence of ``(app_id, tenant, slo, deadline,
        attained, opt_total, arrival)`` with ``opt_total`` the optimistic
        estimate of TOTAL demand (attained + remaining, the arena triage
        scalar).  Returns ``(shed_ids, defer_ids)``:

        * shed — hopeless under the class rules (terminal);
        * defer — deferrable zero-progress work of over-share tenants,
          newest arrivals first, only while pressure holds above the
          watermark (the flash-crowd tail parks, the crowd's earlier
          admitted work keeps running).
        """
        shed: List[str] = []
        defer: List[str] = []
        defer_pool: List[tuple] = []
        for (app_id, tenant, slo, deadline, attained, opt_total,
             arrival) in rows:
            spec = self.spec(slo)
            opt_rem = max(opt_total - attained, 0.0)
            if spec.shed_hopeless and self.hopeless(deadline, now, opt_rem):
                shed.append(app_id)
                self._account(tenant).shed += 1
                continue
            if (spec.deferrable and attained <= 0.0
                    and pressure > self.cfg.pressure_watermark):
                defer_pool.append((arrival, app_id, tenant))
        if defer_pool:
            defer_pool.sort(reverse=True)        # newest first
            for arrival, app_id, tenant in defer_pool:
                if not self.over_share(tenant):
                    continue
                defer.append(app_id)
                self._account(tenant).deferred += 1
                self.note_exit(app_id)           # frees the tenant's share
        for app_id in shed:
            self.note_exit(app_id)
        return shed, defer

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {t: {"live_demand": a.live_demand, "admitted": a.admitted,
                    "shed": a.shed, "deferred": a.deferred}
                for t, a in sorted(self.tenants.items())}


# ---------------------------------------------------------------------------
# Load-adaptive degradation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DegradeConfig:
    """Hysteresis-gated quality degradation under queue pressure.

    Above ``high_watermark`` (estimated LLM drain time in service-seconds
    per slot) the cluster enters the degraded regime; it leaves below
    ``low_watermark``.  While degraded:

    * the scheduler's MC-refinement walker depth is capped at
      ``walker_cap`` (cheaper refresh ticks exactly when ticks are
      biggest);
    * LLM units of *degradable* SLO classes route to ``degrade_model``
      from the ``repro_torch.configs`` zoo — service time divides by the
      parameter-count ratio against ``base_model`` (decode cost is
      parameter-bound), clipped to ``max_speedup``.
    """
    high_watermark: float = 3.0
    low_watermark: float = 1.0
    walker_cap: Optional[int] = 64
    base_model: str = "llama3-8b"
    degrade_model: str = "qwen3-4b"
    llm_speedup: Optional[float] = None      # None: derive from the zoo
    max_speedup: float = 4.0

    def __post_init__(self):
        if not 0.0 <= self.low_watermark <= self.high_watermark:
            raise ValueError("need 0 <= low_watermark <= high_watermark, got "
                             f"{self.low_watermark} / {self.high_watermark}")
        if self.walker_cap is not None and self.walker_cap < 1:
            raise ValueError("walker_cap must be >= 1 walkers")

    def speedup(self) -> float:
        if self.llm_speedup is not None:
            return max(float(self.llm_speedup), 1.0)
        return degrade_speedup(self.base_model, self.degrade_model,
                               max_speedup=self.max_speedup)


def degrade_speedup(base_model: str, degrade_model: str, *,
                    max_speedup: float = 4.0) -> float:
    """Decode-time speedup from routing to the smaller config: the
    parameter-count ratio (decode FLOPs scale ~ params), clipped to
    [1, max_speedup] so an inverted pair never *slows* degraded work."""
    from repro_torch.config import get_config
    base = get_config(base_model).param_counts()["total"]
    small = get_config(degrade_model).param_counts()["total"]
    return float(min(max(base / max(small, 1.0), 1.0), max_speedup))


class DegradeState:
    """The hysteresis latch + degradation bookkeeping (host-side)."""

    def __init__(self, cfg: DegradeConfig):
        self.cfg = cfg
        self.active = False
        self.entered = 0             # raise transitions
        self.degraded_units = 0      # LLM units served by the small config
        self.saved_service_s = 0.0   # service seconds shaved off
        self._speedup: Optional[float] = None

    @property
    def speedup(self) -> float:
        if self._speedup is None:
            self._speedup = self.cfg.speedup()
        return self._speedup

    def update(self, pressure: float) -> bool:
        """Feed the latch one pressure sample; returns the active state."""
        if self.active:
            if pressure < self.cfg.low_watermark:
                self.active = False
        elif pressure > self.cfg.high_watermark:
            self.active = True
            self.entered += 1
        return self.active

    def stats(self) -> Dict[str, float]:
        return {"entered": float(self.entered),
                "degraded_units": float(self.degraded_units),
                "saved_service_s": self.saved_service_s,
                "speedup": self.speedup if self.degraded_units else 1.0}
