"""Workload generation.

Two regimes:

* **Closed window** (``make_workload``): a fixed population of applications
  submitted over a window with bursty MoonCake-like arrivals — the §5.1
  experiment shape.
* **Open arrival** (``make_open_workload``): an unbounded arrival *process*
  (Poisson, or bursty Gamma-renewal with a configurable coefficient of
  variation) running for a duration, with per-tenant traffic mixes and an
  optional ``target_load`` knob that back-solves the arrival rate from the
  suite's mean demand and the cluster's service capacity — the cluster-scale
  regime the Fig. 15 overhead argument is about.

Both attach the §5.1 size mix, optional per-app deadlines (1.2x/1.5x/2x true
execution, as in Fig. 11), and multi-tenant labels for the VTC baseline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.apps.spec import AppSpec, sample_trajectory, trajectory_service
from repro_torch.apps.suite import SUITE, sample_app_names


@dataclass
class AppInstance:
    app_id: str
    app_name: str
    tenant: str
    arrival: float
    trajectory: List[Tuple[str, Dict[str, float]]]
    deadline: Optional[float] = None
    ddl_class: str = ""
    # SLO class consumed by the admission controller (repro.core.admission):
    # "gold" | "standard" | "best_effort"
    slo: str = "standard"


def bursty_arrivals(n: int, window_s: float, rng: np.random.Generator,
                    burstiness: float = 0.7, n_bursts: int = 8) -> np.ndarray:
    """MoonCake-trace-style arrivals: a Poisson base layer plus concentrated
    bursts (the trace's visible arrival spikes)."""
    n_burst = int(n * burstiness)
    base = rng.uniform(0, window_s, n - n_burst)
    centers = rng.uniform(0, window_s, n_bursts)
    which = rng.choice(n_bursts, n_burst)
    burst = centers[which] + rng.exponential(window_s / (n_bursts * 12), n_burst)
    t = np.concatenate([base, np.clip(burst, 0, window_s)])
    return np.sort(t)


def make_workload(n_apps: int, window_s: float, *, seed: int = 0,
                  with_deadlines: bool = False,
                  t_in: float, t_out: float,
                  n_tenants: int = 8,
                  apps: Optional[Dict[str, AppSpec]] = None,
                  warmup_table: Optional[Dict[str, float]] = None
                  ) -> List[AppInstance]:
    rng = np.random.default_rng(seed)
    suite = apps or SUITE
    names = sample_app_names(n_apps, rng)
    times = bursty_arrivals(n_apps, window_s, rng)
    out: List[AppInstance] = []
    ddl_scales = [(1.2, "tight"), (1.5, "modest"), (2.0, "loose")]
    for i, (name, t) in enumerate(zip(names, times)):
        traj = sample_trajectory(suite[name], rng)
        inst = AppInstance(app_id=f"app{i:05d}", app_name=name,
                           tenant=f"tenant{i % n_tenants}",
                           arrival=float(t), trajectory=traj)
        if with_deadlines:
            scale, cls = ddl_scales[int(rng.integers(len(ddl_scales)))]
            base = trajectory_service(traj, t_in, t_out) \
                + _coldstart_overhead(suite[name], traj, warmup_table)
            inst.deadline = float(t + scale * base)
            inst.ddl_class = cls
        out.append(inst)
    return out


def _coldstart_overhead(app, traj, warmup_table=None) -> float:
    """Expected warm-up time on the critical path (the paper scales measured
    execution times, which include container starts / tool loads).
    ``warmup_table`` keeps deadline tightness consistent with a simulator
    running a non-default backend-pool warm-up table."""
    from repro_torch.apps.spec import coldstart_overhead
    return coldstart_overhead(app, traj, warmup_table)


# ---------------------------------------------------------------------------
# Open-arrival (cluster-scale) workloads
# ---------------------------------------------------------------------------

@dataclass
class TenantProfile:
    """One tenant's traffic share and application mix.

    ``app_mix`` maps application name -> weight; ``None`` uses the global
    §5.1 size mix.  ``deadline_frac`` is the fraction of this tenant's
    applications that carry deadlines (only used when the workload is built
    with deadlines enabled)."""
    name: str
    weight: float = 1.0
    app_mix: Optional[Dict[str, float]] = None
    deadline_frac: float = 1.0
    # every application this tenant submits carries this SLO class
    slo: str = "standard"


def open_arrivals(rate_per_s: float, duration_s: float,
                  rng: np.random.Generator, *,
                  process: str = "poisson", cv: float = 2.0) -> np.ndarray:
    """Arrival times of an open-loop renewal process on [0, duration).

    process="poisson": exponential inter-arrivals (cv = 1).
    process="gamma":   Gamma-renewal inter-arrivals with coefficient of
                       variation ``cv`` > 1 — bursty traffic (cv < 1 would be
                       smoother-than-Poisson; both are valid Gamma shapes).
    """
    if rate_per_s <= 0 or duration_s <= 0:
        return np.zeros(0)
    if process == "gamma" and cv <= 0:
        raise ValueError(f"gamma arrivals need cv > 0, got {cv}")
    mean_gap = 1.0 / rate_per_s
    out, t = [], 0.0
    # draw in chunks to avoid Python-level per-arrival loops
    chunk = max(int(rate_per_s * duration_s * 1.25) + 16, 64)
    while t < duration_s:
        if process == "poisson":
            gaps = rng.exponential(mean_gap, chunk)
        elif process == "gamma":
            shape = 1.0 / (cv * cv)
            gaps = rng.gamma(shape, mean_gap / shape, chunk)
        else:
            raise ValueError(f"unknown arrival process {process!r}")
        times = t + np.cumsum(gaps)
        out.append(times[times < duration_s])
        t = float(times[-1])
    return np.concatenate(out) if out else np.zeros(0)


def mean_service_demand(suite: Optional[Dict[str, AppSpec]] = None, *,
                        t_in: float, t_out: float, n_probe: int = 200,
                        seed: int = 0,
                        warmup_table: Optional[Dict[str, float]] = None
                        ) -> float:
    """Monte-Carlo estimate of E[service seconds] per application under the
    §5.1 mix (cold starts included) — the λ·E[S] side of the load equation."""
    rng = np.random.default_rng(seed)
    suite = suite or SUITE
    names = sample_app_names(n_probe, rng)
    tot = 0.0
    for name in names:
        traj = sample_trajectory(suite[name], rng)
        tot += trajectory_service(traj, t_in, t_out) \
            + _coldstart_overhead(suite[name], traj, warmup_table)
    return tot / max(n_probe, 1)


def make_open_workload(duration_s: float, *,
                       t_in: float, t_out: float,
                       rate_per_s: Optional[float] = None,
                       target_load: Optional[float] = None,
                       n_service_slots: int = 16,
                       process: str = "poisson", cv: float = 2.0,
                       tenants: Union[int, Sequence[TenantProfile]] = 8,
                       with_deadlines: bool = False,
                       seed: int = 0,
                       max_apps: Optional[int] = None,
                       apps: Optional[Dict[str, AppSpec]] = None,
                       warmup_table: Optional[Dict[str, float]] = None
                       ) -> List[AppInstance]:
    """Open-arrival workload: applications arrive by a renewal process for
    ``duration_s`` seconds.

    Exactly one of ``rate_per_s`` / ``target_load`` must be given.
    ``target_load`` is the offered load ρ = λ·E[S] / n_service_slots; the
    arrival rate is solved from the suite's mean demand so ρ≈0.8 keeps the
    cluster busy-but-stable and ρ>1 overloads it.

    ``tenants`` is either a tenant count (uniform weights, global app mix) or
    a list of :class:`TenantProfile` for skewed per-tenant traffic.
    """
    if (rate_per_s is None) == (target_load is None):
        raise ValueError("give exactly one of rate_per_s / target_load")
    rng = np.random.default_rng(seed)
    suite = apps or SUITE
    if rate_per_s is None:
        e_s = mean_service_demand(suite, t_in=t_in, t_out=t_out, seed=seed,
                                  warmup_table=warmup_table)
        rate_per_s = target_load * n_service_slots / max(e_s, 1e-9)
    times = open_arrivals(rate_per_s, duration_s, rng,
                          process=process, cv=cv)
    if max_apps is not None:
        times = times[:max_apps]

    if isinstance(tenants, int):
        profiles = [TenantProfile(name=f"tenant{i}")
                    for i in range(max(tenants, 1))]
    else:
        profiles = list(tenants)
    weights = np.asarray([max(p.weight, 0.0) for p in profiles], np.float64)
    weights = weights / weights.sum()

    # all categorical draws happen as whole-trace vectors up front (one
    # alias-table build per distribution instead of one per arrival — the
    # difference between seconds and minutes at 10^5+ arrivals); only the
    # inherently sequential per-app trajectory sampling stays in the loop
    n = len(times)
    prof_idx = (rng.choice(len(profiles), size=n, p=weights)
                if n else np.zeros(0, np.int64))
    names: List[Optional[str]] = [None] * n
    default = np.asarray([p.app_mix is None for p in profiles])[prof_idx] \
        if n else np.zeros(0, bool)
    k = int(default.sum())
    if k:
        drawn = iter(sample_app_names(k, rng))
        for i in np.nonzero(default)[0]:
            names[i] = next(drawn)
    for pi, prof in enumerate(profiles):
        if prof.app_mix is None:
            continue
        rows = np.nonzero(prof_idx == pi)[0]
        if not len(rows):
            continue
        mix_names = sorted(prof.app_mix)
        mix_w = np.asarray([prof.app_mix[m] for m in mix_names], np.float64)
        picks = rng.choice(len(mix_names), size=len(rows),
                           p=mix_w / mix_w.sum())
        for i, d in zip(rows, picks):
            names[i] = mix_names[d]

    ddl_scales = [(1.2, "tight"), (1.5, "modest"), (2.0, "loose")]
    if with_deadlines and n:
        ddl_frac = np.asarray([p.deadline_frac for p in profiles])[prof_idx]
        has_ddl = rng.uniform(size=n) < ddl_frac
        ddl_pick = rng.integers(len(ddl_scales), size=n)
    out: List[AppInstance] = []
    for i, t in enumerate(times):
        name = names[i]
        traj = sample_trajectory(suite[name], rng)
        inst = AppInstance(app_id=f"app{i:06d}", app_name=name,
                           tenant=profiles[prof_idx[i]].name,
                           arrival=float(t), trajectory=traj,
                           slo=profiles[prof_idx[i]].slo)
        if with_deadlines and has_ddl[i]:
            scale, cls = ddl_scales[int(ddl_pick[i])]
            base = trajectory_service(traj, t_in, t_out) \
                + _coldstart_overhead(suite[name], traj, warmup_table)
            inst.deadline = float(t + scale * base)
            inst.ddl_class = cls
        out.append(inst)
    return out


# ---------------------------------------------------------------------------
# Overload scenarios (flash crowds, diurnal load, SLO mixes)
# ---------------------------------------------------------------------------

def assign_slo_mix(insts: Sequence[AppInstance],
                   mix: Dict[str, float], *, seed: int = 0
                   ) -> List[AppInstance]:
    """Overwrite each instance's SLO class with an i.i.d. draw from
    ``mix`` (class -> weight); returns the same list for chaining."""
    rng = np.random.default_rng(seed)
    names = sorted(mix)
    w = np.asarray([max(mix[n], 0.0) for n in names], np.float64)
    picks = rng.choice(len(names), size=len(insts), p=w / w.sum())
    for inst, p in zip(insts, picks):
        inst.slo = names[p]
    return list(insts)


def make_flash_crowd_workload(duration_s: float, *,
                              t_in: float, t_out: float,
                              base_load: float = 0.8,
                              spike_mult: float = 10.0,
                              spike_start: float,
                              spike_dur: float,
                              n_service_slots: int = 16,
                              crowd_tenant: str = "crowd",
                              crowd_slo: str = "best_effort",
                              base_slo_mix: Optional[Dict[str, float]] = None,
                              with_deadlines: bool = True,
                              n_tenants: int = 4,
                              seed: int = 0,
                              apps: Optional[Dict[str, AppSpec]] = None,
                              warmup_table: Optional[Dict[str, float]] = None
                              ) -> List[AppInstance]:
    """A steady background trace plus one tenant's flash crowd.

    Background tenants offer ``base_load`` (ρ = λ·E[S]/slots) for the whole
    window with the given SLO mix; during ``[spike_start, spike_start +
    spike_dur)`` the ``crowd_tenant`` adds ``(spike_mult - 1)x`` the base
    arrival rate of ``crowd_slo`` traffic — total offered load inside the
    spike is ``spike_mult x base_load``.  This is the scenario the
    shedding/fairness machinery is graded on: one tenant's crowd must not
    starve the background tenants' deadline work.
    """
    if spike_mult < 1.0:
        raise ValueError(f"spike_mult must be >= 1, got {spike_mult}")
    base = make_open_workload(
        duration_s, t_in=t_in, t_out=t_out, target_load=base_load,
        n_service_slots=n_service_slots, tenants=n_tenants,
        with_deadlines=with_deadlines, seed=seed, apps=apps,
        warmup_table=warmup_table)
    if base_slo_mix:
        assign_slo_mix(base, base_slo_mix, seed=seed + 1)
    suite = apps or SUITE
    e_s = mean_service_demand(suite, t_in=t_in, t_out=t_out, seed=seed,
                              warmup_table=warmup_table)
    base_rate = base_load * n_service_slots / max(e_s, 1e-9)
    rng = np.random.default_rng(seed + 7919)
    times = spike_start + open_arrivals(base_rate * (spike_mult - 1.0),
                                        spike_dur, rng)
    names = sample_app_names(len(times), rng)
    crowd: List[AppInstance] = []
    for i, (t, name) in enumerate(zip(times, names)):
        traj = sample_trajectory(suite[name], rng)
        inst = AppInstance(app_id=f"crowd{i:06d}", app_name=name,
                           tenant=crowd_tenant, arrival=float(t),
                           trajectory=traj, slo=crowd_slo)
        if with_deadlines:
            svc = trajectory_service(traj, t_in, t_out) \
                + _coldstart_overhead(suite[name], traj, warmup_table)
            inst.deadline = float(t + 1.5 * svc)
            inst.ddl_class = "modest"
        crowd.append(inst)
    out = base + crowd
    out.sort(key=lambda a: (a.arrival, a.app_id))
    return out


def make_drifted_suite(apps: Optional[Dict[str, AppSpec]] = None, *,
                       demand_mult: float = 3.0,
                       drift_apps: Sequence[str] = ("FEV", "ALFWI", "KBQAV"),
                       p_repeat: float = 0.35,
                       repeat_cap: int = 3) -> Dict[str, AppSpec]:
    """The suite after a mid-run demand shift: the listed applications' true
    behavior changes while their names (and hence their frozen PDGraph
    priors) stay the same.

    Two drift axes, matching what posterior learning must recover from:

    * **unit demand** — LLM output lengths and non-LLM durations scale by
      ``demand_mult`` (only on the ``drift_apps`` subset: a *uniform* scale
      would barely reorder Gittins ranks, a subset scale must);
    * **branch mix** — each drifted unit self-repeats with probability
      ``p_repeat`` (up to ``repeat_cap`` extra visits), adding transition
      mass the frozen prior assigns zero probability.

    Non-drifted applications are passed through untouched (same objects), so
    their trajectories and profiling draws are unaffected by construction.
    """
    from dataclasses import replace
    suite = apps or SUITE
    unknown = [n for n in drift_apps if n not in suite]
    if unknown:
        raise ValueError(f"drift_apps not in suite: {unknown}")

    def _scaled(sampler, mult):
        if sampler is None or mult == 1.0:
            return sampler
        return lambda rng, ctx: mult * sampler(rng, ctx)

    def _repeating(base_next, unit_name):
        def f(rng: np.random.Generator, ctx) -> Optional[str]:
            # extra self-visits beyond the pre-drift single pass
            if (ctx["visits"].get(unit_name, 0) <= repeat_cap
                    and rng.uniform() < p_repeat):
                return unit_name
            return base_next(rng, ctx)
        return f

    out: Dict[str, AppSpec] = {}
    for name, app in suite.items():
        if name not in drift_apps:
            out[name] = app
            continue
        units = {}
        for uname, u in app.units.items():
            units[uname] = replace(
                u,
                out_len=_scaled(u.out_len, demand_mult),
                dur=_scaled(u.dur, demand_mult),
                next=_repeating(u.next, uname) if p_repeat > 0 else u.next)
        out[name] = replace(app, units=units)
    return out


def make_drift_workload(duration_s: float, *,
                        t_in: float, t_out: float,
                        shift_at: float,
                        base_load: Optional[float] = None,
                        rate_per_s: Optional[float] = None,
                        demand_mult: float = 3.0,
                        drift_apps: Sequence[str] = ("FEV", "ALFWI", "KBQAV"),
                        p_repeat: float = 0.35,
                        repeat_cap: int = 3,
                        n_service_slots: int = 16,
                        tenants: Union[int, Sequence[TenantProfile]] = 4,
                        with_deadlines: bool = False,
                        seed: int = 0,
                        apps: Optional[Dict[str, AppSpec]] = None,
                        warmup_table: Optional[Dict[str, float]] = None
                        ) -> List[AppInstance]:
    """A workload whose generating suite *shifts* at ``shift_at``: arrivals
    before the shift come from the original suite, arrivals after it from
    :func:`make_drifted_suite` (app *names* unchanged — only the ground
    truth behind them moves, so a frozen knowledge base silently goes
    stale).  The arrival *rate* is held constant across the shift — demand
    drift changes how heavy applications are, not how often users submit
    them — so offered load rises with the drifted demand, exactly the
    regime where a stale model's ordering mistakes cost ACT.

    Exactly one of ``base_load`` (ρ against the *pre-shift* suite, rate
    back-solved as in :func:`make_open_workload`) / ``rate_per_s`` must be
    given.  Post-shift instances get ``drift%06d`` ids (the pre-shift
    segment owns ``app%06d``); the combined trace is arrival-sorted.
    """
    if not 0.0 < shift_at < duration_s:
        raise ValueError(f"need 0 < shift_at < duration_s, got "
                         f"{shift_at} / {duration_s}")
    if (base_load is None) == (rate_per_s is None):
        raise ValueError("give exactly one of base_load / rate_per_s")
    if rate_per_s is None:
        e_s = mean_service_demand(apps, t_in=t_in, t_out=t_out, seed=seed,
                                  warmup_table=warmup_table)
        rate_per_s = base_load * n_service_slots / max(e_s, 1e-9)
    pre = make_open_workload(
        shift_at, t_in=t_in, t_out=t_out, rate_per_s=rate_per_s,
        n_service_slots=n_service_slots, tenants=tenants,
        with_deadlines=with_deadlines, seed=seed, apps=apps,
        warmup_table=warmup_table)
    drifted = make_drifted_suite(apps, demand_mult=demand_mult,
                                 drift_apps=drift_apps, p_repeat=p_repeat,
                                 repeat_cap=repeat_cap)
    post = make_open_workload(
        duration_s - shift_at, t_in=t_in, t_out=t_out,
        rate_per_s=rate_per_s, n_service_slots=n_service_slots,
        tenants=tenants, with_deadlines=with_deadlines, seed=seed + 6007,
        apps=drifted, warmup_table=warmup_table)
    for i, inst in enumerate(post):
        inst.app_id = f"drift{i:06d}"
        inst.arrival += shift_at
        if inst.deadline is not None:
            inst.deadline += shift_at
    out = pre + post
    out.sort(key=lambda a: (a.arrival, a.app_id))
    return out


def make_diurnal_workload(duration_s: float, *,
                          t_in: float, t_out: float,
                          peak_load: float = 1.5,
                          trough_load: float = 0.3,
                          period_s: Optional[float] = None,
                          n_service_slots: int = 16,
                          tenants: Union[int, Sequence[TenantProfile]] = 4,
                          with_deadlines: bool = True,
                          seed: int = 0,
                          apps: Optional[Dict[str, AppSpec]] = None,
                          warmup_table: Optional[Dict[str, float]] = None
                          ) -> List[AppInstance]:
    """Sinusoidal diurnal load between ``trough_load`` and ``peak_load``:
    a peak-rate Poisson stream thinned to the instantaneous rate (an exact
    construction for an inhomogeneous Poisson process).  One ``period_s``
    spans trough -> peak -> trough; the default is the whole window."""
    if not 0.0 <= trough_load <= peak_load:
        raise ValueError("need 0 <= trough_load <= peak_load, got "
                         f"{trough_load} / {peak_load}")
    period_s = float(period_s or duration_s)
    suite = apps or SUITE
    e_s = mean_service_demand(suite, t_in=t_in, t_out=t_out, seed=seed,
                              warmup_table=warmup_table)
    peak_rate = peak_load * n_service_slots / max(e_s, 1e-9)
    rng = np.random.default_rng(seed + 104729)
    times = open_arrivals(peak_rate, duration_s, rng)
    # rate(t)/peak in [trough/peak, 1]; phase puts the trough at t = 0
    mid = 0.5 * (peak_load + trough_load)
    amp = 0.5 * (peak_load - trough_load)
    rel = (mid - amp * np.cos(2.0 * np.pi * times / period_s)) / peak_load
    times = times[rng.uniform(size=len(times)) < rel]
    if isinstance(tenants, int):
        profiles = [TenantProfile(name=f"tenant{i}")
                    for i in range(max(tenants, 1))]
    else:
        profiles = list(tenants)
    weights = np.asarray([max(p.weight, 0.0) for p in profiles], np.float64)
    prof_idx = (rng.choice(len(profiles), size=len(times),
                           p=weights / weights.sum())
                if len(times) else np.zeros(0, np.int64))
    names = sample_app_names(len(times), rng)
    ddl_scales = [(1.2, "tight"), (1.5, "modest"), (2.0, "loose")]
    out: List[AppInstance] = []
    for i, t in enumerate(times):
        name = names[i]
        traj = sample_trajectory(suite[name], rng)
        prof = profiles[prof_idx[i]]
        inst = AppInstance(app_id=f"diur{i:06d}", app_name=name,
                           tenant=prof.name, arrival=float(t),
                           trajectory=traj, slo=prof.slo)
        if with_deadlines and rng.uniform() < prof.deadline_frac:
            scale, cls = ddl_scales[int(rng.integers(len(ddl_scales)))]
            svc = trajectory_service(traj, t_in, t_out) \
                + _coldstart_overhead(suite[name], traj, warmup_table)
            inst.deadline = float(t + scale * svc)
            inst.ddl_class = cls
        out.append(inst)
    return out
