"""Fault tolerance + straggler mitigation for the training/serving runtime.

* ``StragglerWatchdog`` — per-step latency tracker; flags steps beyond
  `factor` x a rolling p90 (on real pods: triggers hot-spare swap / restart of
  the slow host; here: recorded + surfaced to the driver, unit-tested).
* ``BackendStragglerWatchdog`` — per-backend slow-node detector with
  flag/clear hysteresis; its slowdown estimate feeds the scheduler's demand
  model (the simulator's backend pool drives it from observed wall/service
  ratios of completed tasks).
* ``FailureInjector`` — deterministic fault injection for tests/drivers
  (``train.py --fail-at-step N`` exercises the restart path; the simulator
  schedules a ``FaultEvent`` plan through the same object).
* ``HeartbeatRegistry`` — serving-side liveness: engines heartbeat; requests
  owned by a dead engine are re-queued (at-least-once, idempotent by id).
* ``requeue_backoff`` — the capped exponential backoff every re-queue
  attempt waits before re-entering the waiting queue.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Set,
                    Tuple)


class StragglerWatchdog:
    def __init__(self, window: int = 50, factor: float = 2.0,
                 min_samples: int = 10):
        self.window = window
        self.factor = factor
        self.min_samples = min_samples
        self.times: Deque[float] = deque(maxlen=window)
        self.flagged: List[int] = []
        self.step = 0

    def record(self, step_time: float) -> bool:
        """Returns True if this step is a straggler."""
        self.step += 1
        is_straggler = False
        if len(self.times) >= self.min_samples:
            ts = sorted(self.times)
            p90 = ts[int(0.9 * (len(ts) - 1))]
            if step_time > self.factor * p90:
                self.flagged.append(self.step)
                is_straggler = True
        self.times.append(step_time)
        return is_straggler


class BackendStragglerWatchdog:
    """Per-backend slow-node detector with flag/clear hysteresis.

    Hosts feed one observation per completed task: the wall/service ratio
    on the backend that ran it (1.0 = full speed).  A backend is *flagged*
    after ``flag_after`` consecutive observations beyond ``threshold`` and
    *cleared* after ``clear_after`` consecutive normal ones — single noisy
    tasks neither raise nor drop the flag.  While flagged, ``slowdown()``
    returns the median of the recent over-threshold window as the demand
    model's per-backend stretch estimate; unflagged backends report 1.0.
    """

    def __init__(self, threshold: float = 1.5, flag_after: int = 3,
                 clear_after: int = 3, window: int = 16):
        if threshold <= 1.0:
            raise ValueError(f"threshold must exceed 1.0, got {threshold}")
        self.threshold = threshold
        self.flag_after = max(int(flag_after), 1)
        self.clear_after = max(int(clear_after), 1)
        self.window = max(int(window), 1)
        self._hot: Dict[str, int] = {}      # consecutive slow observations
        self._cool: Dict[str, int] = {}     # consecutive normal observations
        self._recent: Dict[str, Deque[float]] = {}
        self.flagged: Set[str] = set()
        self.flag_events = 0                # distinct raise transitions

    def observe(self, backend_id: str, ratio: float) -> bool:
        """Record one wall/service observation; returns the flag state."""
        rec = self._recent.setdefault(backend_id,
                                      deque(maxlen=self.window))
        if ratio > self.threshold:
            rec.append(ratio)
            self._hot[backend_id] = self._hot.get(backend_id, 0) + 1
            self._cool[backend_id] = 0
            if (self._hot[backend_id] >= self.flag_after
                    and backend_id not in self.flagged):
                self.flagged.add(backend_id)
                self.flag_events += 1
        else:
            self._hot[backend_id] = 0
            self._cool[backend_id] = self._cool.get(backend_id, 0) + 1
            if (self._cool[backend_id] >= self.clear_after
                    and backend_id in self.flagged):
                self.flagged.discard(backend_id)
                rec.clear()
        return backend_id in self.flagged

    def slowdown(self, backend_id: str) -> float:
        """Estimated service stretch for this backend (1.0 when unflagged)."""
        if backend_id not in self.flagged:
            return 1.0
        rec = sorted(self._recent.get(backend_id, ()))
        if not rec:
            return 1.0
        return float(rec[len(rec) // 2])


class SimulatedFailure(RuntimeError):
    pass


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled backend fault in a deterministic injection plan.

    kind
        ``crash``   — the backend dies (stops heartbeating, in-flight work
                      is orphaned and re-queued once the miss is detected);
        ``slow``    — the backend degrades to ``slowdown`` x service time;
        ``recover`` — the backend returns at full speed.
    pool / backend
        Which backend pool (``llm``/``docker``/``dnn``) and which member
        index inside it the fault hits.
    """
    t: float
    kind: str
    pool: str = "llm"
    backend: int = 0
    slowdown: float = 1.0

    def __post_init__(self):
        if self.kind not in ("crash", "slow", "recover"):
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             "known: ('crash', 'slow', 'recover')")
        if self.kind == "slow" and self.slowdown < 1.0:
            raise ValueError("slow faults need slowdown >= 1.0, "
                             f"got {self.slowdown}")


class FailureInjector:
    """Deterministic fault injection.

    Two driving styles share the object:

    * step-based (the training driver): ``maybe_fail(step)`` raises
      :class:`SimulatedFailure` at ``fail_at_step``;
    * plan-based (the serving simulator): construct with a ``plan`` of
      :class:`FaultEvent` and drain it with ``due(now)`` — each event is
      handed out exactly once, in time order.
    """

    def __init__(self, fail_at_step: Optional[int] = None,
                 fail_once: bool = True,
                 plan: Sequence[FaultEvent] = ()):
        self.fail_at_step = fail_at_step
        self.fail_once = fail_once
        self.fired = False
        self.plan: List[FaultEvent] = sorted(plan, key=lambda e: e.t)
        self._next = 0

    def maybe_fail(self, step: int) -> None:
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not (self.fail_once and self.fired)):
            self.fired = True
            raise SimulatedFailure(f"injected failure at step {step}")

    def pending(self) -> Tuple[FaultEvent, ...]:
        return tuple(self.plan[self._next:])

    def due(self, now: float) -> List[FaultEvent]:
        """Every scheduled fault with t <= now not yet handed out."""
        out: List[FaultEvent] = []
        while self._next < len(self.plan) and self.plan[self._next].t <= now:
            out.append(self.plan[self._next])
            self._next += 1
        return out


def requeue_backoff(attempt: int, base_s: float, cap_s: float) -> float:
    """Capped exponential backoff before re-queuing an orphaned unit:
    ``min(base * 2**(attempt-1), cap)`` for attempt >= 1 (attempt 0 — the
    first submission — waits nothing)."""
    if attempt <= 0:
        return 0.0
    return float(min(base_s * (2.0 ** (attempt - 1)), cap_s))


@dataclass
class EngineInfo:
    engine_id: str
    last_beat: float
    inflight: Set[str] = field(default_factory=set)


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.engines: Dict[str, EngineInfo] = {}

    def beat(self, engine_id: str) -> None:
        e = self.engines.setdefault(engine_id,
                                    EngineInfo(engine_id, self.clock()))
        e.last_beat = self.clock()

    def assign(self, engine_id: str, req_id: str) -> None:
        self.engines[engine_id].inflight.add(req_id)

    def complete(self, engine_id: str, req_id: str) -> None:
        self.engines[engine_id].inflight.discard(req_id)

    def reap_dead(self) -> List[str]:
        """Returns request ids orphaned by dead engines (to re-queue)."""
        now = self.clock()
        orphans: List[str] = []
        for eid in list(self.engines):
            e = self.engines[eid]
            if now - e.last_beat > self.timeout_s:
                orphans.extend(sorted(e.inflight))
                del self.engines[eid]
        return orphans
