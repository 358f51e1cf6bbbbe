"""Backend pools with crash/slow faults for the cluster simulator.

PRs 1–6 modeled each backend class (``llm`` / ``docker`` / ``dnn``) as one
monolithic slot count — nothing could fail.  This module splits each class
into a pool of named backend members (``llm0``, ``llm1``, …) that tasks are
placed on, so a :class:`~repro.runtime.fault_tolerance.FaultEvent` can take
one member down (crash: its slots leave capacity and its in-flight tasks are
orphaned) or degrade it (slow: service on it stretches by a slowdown
factor) without touching the rest of the pool.

Placement is deterministic — most-free-slots first, lowest index breaking
ties — and with the default single-member pools every task lands on member
0, so a fault-free run is bit-identical to the pre-pool simulator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.runtime.fault_tolerance import FaultEvent


@dataclass
class Backend:
    """One pool member: a named slice of a backend class's slots."""
    kind: str
    index: int
    slots: int
    alive: bool = True
    slowdown: float = 1.0          # service stretch while degraded (>= 1)
    running: int = 0               # tasks currently placed here
    crashes: int = 0
    # completion accounting (observation-path telemetry: the per-member
    # denominator behind observed wall/service stretch and demand drift)
    done_tasks: int = 0
    service_done_s: float = 0.0
    wall_done_s: float = 0.0

    @property
    def backend_id(self) -> str:
        return f"{self.kind}{self.index}"

    @property
    def free(self) -> int:
        return self.slots - self.running if self.alive else 0

    def note_completion(self, service_s: float, wall_s: float) -> None:
        """Record one finished task's service/wall seconds on this member."""
        self.done_tasks += 1
        self.service_done_s += float(service_s)
        self.wall_done_s += float(wall_s)

    def observed_stretch(self) -> float:
        """Lifetime wall/service ratio over completed tasks (1.0 when no
        completions yet)."""
        if self.service_done_s <= 0.0:
            return 1.0
        return self.wall_done_s / self.service_done_s


class BackendPool:
    """The members of one backend class, with deterministic placement.

    ``total_slots`` is divided across ``n_backends`` members (remainder
    slots go to the lowest indices), so pool capacity with every member
    alive equals the classic single-backend slot count exactly.
    """

    def __init__(self, kind: str, total_slots: int, n_backends: int = 1):
        n = max(int(n_backends), 1)
        if total_slots < n:
            raise ValueError(
                f"{kind}: {total_slots} slots cannot be split across "
                f"{n} backends (need at least one slot each)")
        base, extra = divmod(total_slots, n)
        self.kind = kind
        self.backends: List[Backend] = [
            Backend(kind=kind, index=i, slots=base + (1 if i < extra else 0))
            for i in range(n)]

    def __iter__(self):
        return iter(self.backends)

    def __getitem__(self, index: int) -> Backend:
        return self.backends[index]

    def capacity(self) -> int:
        return sum(b.slots for b in self.backends if b.alive)

    def alive(self) -> List[Backend]:
        return [b for b in self.backends if b.alive]

    def place(self) -> Optional[Backend]:
        """The member a new task runs on: most free slots, lowest index on
        ties; None when every live member is full (callers gate on pool
        capacity, so this only happens mid-crash)."""
        best: Optional[Backend] = None
        for b in self.backends:
            if not b.alive or b.free <= 0:
                continue
            if best is None or b.free > best.free:
                best = b
        return best

    def max_slowdown(self) -> float:
        live = [b.slowdown for b in self.backends if b.alive]
        return max(live) if live else 1.0


def build_pools(slots: Mapping[str, int],
                n_backends: Optional[Mapping[str, int]] = None
                ) -> Dict[str, BackendPool]:
    n_backends = n_backends or {}
    return {kind: BackendPool(kind, total, n_backends.get(kind, 1))
            for kind, total in slots.items()}


@dataclass(frozen=True)
class FaultConfig:
    """Fault-model knobs for :class:`repro.serving.simulator.ClusterSim`.

    events
        The deterministic :class:`FaultEvent` plan, driven through a
        ``FailureInjector``.
    n_backends
        Pool-member counts per backend class; unlisted classes stay
        monolithic (one member = the classic no-fault behavior).
    heartbeat_timeout_s
        A backend missing heartbeats for longer than this is declared dead
        and its in-flight units are orphaned (detection happens on the
        simulator's bucket ticks, so effective detection latency is
        ``timeout + O(bucket)``).
    requeue_backoff_s / requeue_backoff_cap_s
        Capped exponential backoff between orphan detection and re-queue:
        attempt k waits ``min(base * 2**(k-1), cap)``.
    straggler_*
        :class:`BackendStragglerWatchdog` tuning — threshold on the
        observed wall/service ratio, and the flag/clear hysteresis depths.
    """
    events: Tuple[FaultEvent, ...] = ()
    n_backends: Tuple[Tuple[str, int], ...] = (("llm", 4),)
    heartbeat_timeout_s: float = 2.0
    requeue_backoff_s: float = 0.25
    requeue_backoff_cap_s: float = 4.0
    straggler_threshold: float = 1.5
    straggler_flag_after: int = 3
    straggler_clear_after: int = 3

    def __post_init__(self):
        object.__setattr__(self, "events",
                           tuple(sorted(self.events, key=lambda e: e.t)))
        object.__setattr__(self, "n_backends", tuple(self.n_backends))
        if self.heartbeat_timeout_s <= 0:
            raise ValueError("heartbeat_timeout_s must be positive")
        if self.requeue_backoff_s < 0 or self.requeue_backoff_cap_s < 0:
            raise ValueError("requeue backoff seconds must be >= 0")

    def backend_counts(self) -> Dict[str, int]:
        return dict(self.n_backends)


def correlated_outage_plan(t: float, pool: str, backends: Sequence[int], *,
                           stagger_s: float = 0.0,
                           recover_after_s: Optional[float] = None
                           ) -> List[FaultEvent]:
    """A correlated multi-backend outage: the listed members of one pool
    crash together at ``t`` (optionally staggered — a cascading rack
    failure), and optionally all recover ``recover_after_s`` later."""
    out: List[FaultEvent] = []
    for i, b in enumerate(backends):
        at = t + i * stagger_s
        out.append(FaultEvent(t=at, kind="crash", pool=pool, backend=b))
        if recover_after_s is not None:
            out.append(FaultEvent(t=at + recover_after_s, kind="recover",
                                  pool=pool, backend=b))
    return out
