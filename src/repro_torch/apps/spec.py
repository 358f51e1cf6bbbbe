"""Application templates for the workload suite.

An ``AppSpec`` is the *generator* of application instances: per trial it
samples a latent complexity ``z`` (shared across units — this induces the
cross-unit demand correlations that PDGraph's online refinement exploits) and
walks the unit graph sampling per-unit observations.  The same generator is
used for offline profiling (building PDGraphs) and for the simulator's ground
truth, mirroring the paper's recurring-application assumption.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pdgraph import BackendSpec, PDGraph, UnitNode

Ctx = Dict[str, object]  # {"z": float, "prev": obs dict, "visits": {...}}


@dataclass
class UnitSpec:
    name: str
    backend: BackendSpec
    in_len: Optional[Callable[[np.random.Generator, Ctx], float]] = None
    out_len: Optional[Callable[[np.random.Generator, Ctx], float]] = None
    par: Optional[Callable[[np.random.Generator, Ctx], float]] = None
    dur: Optional[Callable[[np.random.Generator, Ctx], float]] = None
    next: Callable[[np.random.Generator, Ctx], Optional[str]] = lambda r, c: None

    def sample_obs(self, rng: np.random.Generator, ctx: Ctx) -> Dict[str, float]:
        obs: Dict[str, float] = {}
        if self.backend.kind == "llm":
            obs["par"] = max(1, round(self.par(rng, ctx) if self.par else 1))
            obs["in"] = max(1, round(self.in_len(rng, ctx)))
            obs["out"] = max(1, round(self.out_len(rng, ctx)))
        else:
            obs["dur"] = max(0.01, float(self.dur(rng, ctx)))
        return obs


@dataclass
class AppSpec:
    name: str
    entry: str
    units: Dict[str, UnitSpec]
    size_class: str = "small"      # small | medium | large
    max_steps: int = 64

    def empty_pdgraph(self) -> PDGraph:
        nodes = {n: UnitNode(name=n, backend=u.backend)
                 for n, u in self.units.items()}
        return PDGraph(self.name, self.entry, nodes)


def sample_trajectory(app: AppSpec, rng: np.random.Generator
                      ) -> List[Tuple[str, Dict[str, float]]]:
    """One ground-truth run: ordered [(unit, obs)] with latent-z correlation."""
    ctx: Ctx = {"z": float(rng.uniform()), "prev": None, "visits": {},
                "by_unit": {}}
    traj: List[Tuple[str, Dict[str, float]]] = []
    unit = app.entry
    for _ in range(app.max_steps):
        if unit is None:
            break
        spec = app.units[unit]
        ctx["visits"][unit] = ctx["visits"].get(unit, 0) + 1
        obs = spec.sample_obs(rng, ctx)
        traj.append((unit, obs))
        ctx["prev"] = obs
        ctx["by_unit"][unit] = obs
        unit = spec.next(rng, ctx)
    return traj


def coldstart_overhead(app: AppSpec, traj,
                       warmup_table: Optional[Dict[str, float]] = None
                       ) -> float:
    """Expected warm-up time on the critical path of one trajectory.
    ``warmup_table`` overrides the Fig. 2 per-key defaults (the simulator's
    configurable backend pool passes its own)."""
    from repro_torch.core.hermeslet import warmup_time_for
    tot = 0.0
    for unit, _obs in traj:
        b = app.units[unit].backend
        if b.kind == "docker":
            tot += warmup_time_for(b.resource_keys()[0], warmup_table)
        elif b.kind == "dnn":
            tot += 0.3 * warmup_time_for(b.resource_keys()[0], warmup_table)
    return tot


def profile_app(app: AppSpec, n_trials: int, seed: int = 0,
                include_coldstart: bool = True,
                warmup_table: Optional[Dict[str, float]] = None) -> PDGraph:
    """Offline profiling (§3.2): run the generator n times, record each trial.

    Profiling runs measure wall durations, which on a fresh backend INCLUDE
    the cold start (the paper profiles on the real testbed) — so recorded
    non-LLM durations carry the container-start / tool-load cost
    (``warmup_table`` overrides the Fig. 2 per-key costs).
    """
    from repro_torch.core.hermeslet import warmup_time_for
    g = app.empty_pdgraph()
    rng = np.random.default_rng(seed)
    for _ in range(n_trials):
        traj = sample_trajectory(app, rng)
        if include_coldstart:
            adj = []
            for unit, obs in traj:
                b = app.units[unit].backend
                if b.kind == "docker" and "dur" in obs:
                    obs = dict(obs)
                    obs["dur"] += warmup_time_for(b.resource_keys()[0],
                                                  warmup_table)
                elif b.kind == "dnn" and "dur" in obs:
                    obs = dict(obs)
                    obs["dur"] += 0.3 * warmup_time_for(
                        b.resource_keys()[0], warmup_table)
                adj.append((unit, obs))
            traj = adj
        g.record_trial(traj)
    return g


def trajectory_service(traj, t_in: float, t_out: float) -> float:
    """Total true service demand of one trajectory (seconds)."""
    tot = 0.0
    for _name, obs in traj:
        if "dur" in obs:
            tot += obs["dur"]
        else:
            tot += obs["par"] * (obs["in"] * t_in + obs["out"] * t_out)
    return tot


# ---------------------------------------------------------------- samplers
def lognorm(mean: float, sigma: float = 0.4, z_weight: float = 0.0,
            prev_key: Optional[str] = None, prev_weight: float = 0.0):
    """Log-normal around `mean`, scaled by the latent z and optionally by the
    previous unit's observation (creates the Fig. 6 correlation structure)."""
    def f(rng: np.random.Generator, ctx: Ctx) -> float:
        base = mean * math.exp(rng.normal(-0.5 * sigma ** 2, sigma))
        if z_weight:
            base *= (1.0 - z_weight) + 2.0 * z_weight * float(ctx["z"])
        prev = ctx.get("prev")
        if prev_key and prev_weight and prev and prev_key in prev:
            base = (1 - prev_weight) * base + prev_weight * float(prev[prev_key])
        return base
    return f


def track(unit: str, key: str, scale: float = 1.0, jitter: float = 0.0,
          fallback: float = 1.0):
    """Mirror another (possibly non-adjacent) unit's observation — e.g.
    KBQAV's verify parallelism tracking generate-queries parallelism."""
    def f(rng: np.random.Generator, ctx: Ctx) -> float:
        prev = ctx.get("by_unit", {}).get(unit)
        base = float(prev[key]) * scale if prev and key in prev else fallback
        if jitter:
            base *= 1.0 + rng.normal(0, jitter)
        return base
    return f


def uniform(lo: float, hi: float, z_weight: float = 0.0):
    def f(rng, ctx):
        v = rng.uniform(lo, hi)
        if z_weight:
            v *= (1.0 - z_weight) + 2.0 * z_weight * float(ctx["z"])
        return v
    return f


def loop(next_unit: str, p_loop: float, exit_unit: Optional[str] = None,
         max_visits: int = 8, z_weight: float = 0.0, loop_from: Optional[str] = None):
    """Return `next_unit` with prob p (possibly z-scaled), else exit."""
    def f(rng: np.random.Generator, ctx: Ctx) -> Optional[str]:
        visits = ctx["visits"].get(loop_from or next_unit, 0)
        p = p_loop
        if z_weight:
            p = min(0.97, p * ((1.0 - z_weight) + 2.0 * z_weight * float(ctx["z"])))
        if visits < max_visits and rng.uniform() < p:
            return next_unit
        return exit_unit
    return f


def then(next_unit: Optional[str]):
    return lambda rng, ctx: next_unit


def branch(options: Sequence[Tuple[Optional[str], float]]):
    names = [o[0] for o in options]
    probs = np.asarray([o[1] for o in options], np.float64)
    probs = probs / probs.sum()

    def f(rng: np.random.Generator, ctx: Ctx) -> Optional[str]:
        return names[int(rng.choice(len(names), p=probs))]
    return f
