"""The cluster simulator's event engine.

The simulator's hot loop is *drain one timestamp's micro-batch, handle it,
refresh ranks once, reschedule once*.  The event queue exposes exactly that
contract:

* ``push(t, kind, payload)`` — schedule an event (never in the past);
* ``next_batch() -> (t, [(kind, payload), ...])`` — pop EVERY outstanding
  event whose timestamp equals the earliest one, in push order;
* ``len(q)`` — outstanding events.

``CalendarEventQueue`` is a bucketed calendar queue
(time wheel with an unbounded, sparse wheel): events land in
``floor(t / bucket_s)`` buckets as plain appends; a bucket is sorted ONCE
with a vectorized stable argsort when the clock reaches it, and batches are
then cut out of the sorted run with ``searchsorted`` — no per-event
comparison work, no log-factor tuple churn.  Pushes that land in the bucket
currently being drained (completion chains, immediate prewarms) go to a
*late* buffer that is settled into its own sorted run on the next drain;
equal-timestamp order across runs is push order because a run is always
created strictly after every earlier run's events were pushed.

The batch order equals that of a heap of ``(t, push seq)``: bucket order is
monotone in t, a stable sort on t within the bucket keeps ties in push
order, and late pushes follow in run creation order.

``ArrayWaitQueue`` is the matching waiting-queue structure: a sorted
structure of ``(r0, r1, r2)`` key columns over numpy arrays whose full
refresh (re-key every queued task after a rank tick) is one vectorized
gather + ``lexsort`` instead of O(Q) Python key calls + ``heapify`` — the
per-tick host cost that dominates 100k-app queues.  Between refreshes,
freshly pushed tasks sit in a small heap and pops take the min of the two
structures; key tuples are unique (the last component is the task id), so
the pop order is total and bit-identical to a plain heap of the same keys.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["CalendarEventQueue", "ArrayWaitQueue"]


class _Run:
    """One sorted run of a bucket's events (stable-sorted by t, so ties
    keep push order)."""
    __slots__ = ("times", "kinds", "payloads", "pos")

    def __init__(self, times: List[float], kinds: list, payloads: list):
        t = np.asarray(times, np.float64)
        order = np.argsort(t, kind="stable")
        self.times = t[order]
        self.kinds = [kinds[i] for i in order]
        self.payloads = [payloads[i] for i in order]
        self.pos = 0

    def __len__(self) -> int:
        return len(self.times) - self.pos

    def head(self) -> float:
        return self.times[self.pos]

    def take(self, t: float, out: list) -> int:
        """Append this run's events at exactly ``t`` (its head) to ``out``."""
        hi = int(np.searchsorted(self.times, t, side="right"))
        for i in range(self.pos, hi):
            out.append((self.kinds[i], self.payloads[i]))
        n = hi - self.pos
        self.pos = hi
        return n


class CalendarEventQueue:
    """Bucketed calendar queue (see module docstring).  ``bucket_s`` is the
    wheel pitch — the simulator uses its refresh bucket period, which keeps
    per-bucket populations near the per-tick event count."""

    # late-push runs accumulated past this are compacted into one
    _MAX_RUNS = 8

    def __init__(self, bucket_s: float = 1.0):
        if not bucket_s > 0.0:
            raise ValueError(f"bucket_s must be positive, got {bucket_s}")
        self._w = float(bucket_s)
        self._n = 0
        self._buckets: Dict[int, Tuple[list, list, list]] = {}
        self._bheap: List[int] = []      # outstanding bucket indices
        self._idx: Optional[int] = None  # bucket currently being drained
        self._runs: List[_Run] = []      # sorted runs of the current bucket
        # late pushes into the current bucket, in push order
        self._lt: List[float] = []
        self._lk: list = []
        self._lp: list = []

    def __len__(self) -> int:
        return self._n

    def push(self, t: float, kind: str, payload=None) -> None:
        t = float(t)
        self._n += 1
        idx = int(t // self._w)
        if idx == self._idx:
            self._lt.append(t)
            self._lk.append(kind)
            self._lp.append(payload)
            return
        b = self._buckets.get(idx)
        if b is None:
            b = self._buckets[idx] = ([], [], [])
            heapq.heappush(self._bheap, idx)
        b[0].append(t)
        b[1].append(kind)
        b[2].append(payload)

    def _compact(self) -> None:
        """Merge all live runs into one (concat in run-creation order, then
        stable sort: equal-t order across runs — which is push order — is
        preserved)."""
        times: List[float] = []
        kinds: list = []
        payloads: list = []
        for r in self._runs:
            times.extend(r.times[r.pos:].tolist())
            kinds.extend(r.kinds[r.pos:])
            payloads.extend(r.payloads[r.pos:])
        self._runs = [_Run(times, kinds, payloads)] if times else []

    def next_batch(self) -> Tuple[float, List[tuple]]:
        if self._lt:
            # settle the late buffer into its own run; every late event was
            # pushed after every event of every existing run, so run order
            # IS push order for equal timestamps
            self._runs.append(_Run(self._lt, self._lk, self._lp))
            self._lt, self._lk, self._lp = [], [], []
            if len(self._runs) > self._MAX_RUNS:
                self._compact()
        self._runs = [r for r in self._runs if len(r)]
        if not self._runs:
            # advance the wheel to the next outstanding bucket
            idx = heapq.heappop(self._bheap)
            times, kinds, payloads = self._buckets.pop(idx)
            self._idx = idx
            self._runs = [_Run(times, kinds, payloads)]
        t = min(r.head() for r in self._runs)
        batch: List[tuple] = []
        for r in self._runs:             # creation = push order across runs
            if len(r) and r.head() == t:
                self._n -= r.take(t, batch)
        return float(t), batch


class ArrayWaitQueue:
    """Array-native waiting queue (see module docstring).

    Entries carry a 3-component key ``(r0, r1, r2)`` — ``(rank, submitted,
    task_id)`` for app-level policies, ``(submitted, task_id, 0)`` for
    task-level ones — plus the app's dense host index so a full refresh can
    re-gather ``r0`` from the host rank column in one vectorized read.
    ``r2``/``r1`` contain the unique task id, so the order is total.
    """

    def __init__(self):
        # settled region: parallel arrays sorted ascending by key
        self._k0 = np.zeros(0)
        self._k1 = np.zeros(0)
        self._k2 = np.zeros(0)
        self._ai = np.zeros(0, np.int64)
        self._tasks: list = []
        self._pos = 0
        # fresh pushes since the last settle: a small heap of
        # (r0, r1, r2, app_index, task); keys are unique so the task object
        # is never compared
        self._fresh: List[tuple] = []

    def __len__(self) -> int:
        return (len(self._tasks) - self._pos) + len(self._fresh)

    def push(self, key: tuple, task, app_index: int = -1) -> None:
        r0, r1, r2 = key
        heapq.heappush(self._fresh, (r0, r1, r2, app_index, task))

    def _settled_key(self) -> Optional[tuple]:
        if self._pos >= len(self._tasks):
            return None
        i = self._pos
        return (self._k0[i], self._k1[i], self._k2[i])

    def peek_key(self) -> tuple:
        s = self._settled_key()
        f = self._fresh[0][:3] if self._fresh else None
        if f is None:
            return s
        return f if s is None or f < s else s

    def pop(self):
        s = self._settled_key()
        f = self._fresh[0][:3] if self._fresh else None
        if f is None or (s is not None and s < f):
            i = self._pos
            self._pos += 1
            task, self._tasks[i] = self._tasks[i], None   # free the slot
            return task
        return heapq.heappop(self._fresh)[4]

    def _gather(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray, list]:
        """All outstanding entries: settled rest first, then fresh in heap
        (arbitrary) order — the caller re-sorts, so intra-gather order only
        needs to be deterministic, which heap layout is for unique keys."""
        lo = self._pos
        k0 = self._k0[lo:]
        k1 = self._k1[lo:]
        k2 = self._k2[lo:]
        ai = self._ai[lo:]
        tasks = self._tasks[lo:]
        if self._fresh:
            k0 = np.concatenate([k0, [e[0] for e in self._fresh]])
            k1 = np.concatenate([k1, [e[1] for e in self._fresh]])
            k2 = np.concatenate([k2, [e[2] for e in self._fresh]])
            ai = np.concatenate(
                [ai, np.asarray([e[3] for e in self._fresh], np.int64)])
            tasks = tasks + [e[4] for e in self._fresh]
        return k0, k1, k2, ai, tasks

    def discard(self, app_ids) -> list:
        """Drop every queued task whose ``app_id`` is in ``app_ids``
        (shed/deferred applications); returns the removed tasks.  Keys are
        kept verbatim, so survivors pop in exactly the order they would
        have without the removal."""
        if not len(self):
            return []
        k0, k1, k2, ai, tasks = self._gather()
        keep = np.asarray([t.app_id not in app_ids for t in tasks], bool)
        removed = [t for t, k in zip(tasks, keep) if not k]
        if removed:
            order = np.lexsort((k2[keep], k1[keep], k0[keep]))
            self._k0 = k0[keep][order]
            self._k1 = k1[keep][order]
            self._k2 = k2[keep][order]
            self._ai = ai[keep][order]
            kept = [t for t, k in zip(tasks, keep) if k]
            self._tasks = [kept[i] for i in order]
            self._pos = 0
            self._fresh = []
        return removed

    def rebuild(self, rank_of: Optional[np.ndarray]) -> None:
        """Full refresh: re-key every queued entry and resort.  With
        ``rank_of`` (host rank column indexed by dense app index) the new
        ``r0`` is one vectorized gather; ``None`` keeps the stored keys
        (task-level policies — keys are rank-independent, resort only)."""
        if not len(self):
            return
        k0, k1, k2, ai, tasks = self._gather()
        if rank_of is not None:
            k0 = rank_of[ai]
        order = np.lexsort((k2, k1, k0))
        self._k0 = k0[order]
        self._k1 = k1[order]
        self._k2 = k2[order]
        self._ai = ai[order]
        self._tasks = [tasks[i] for i in order]
        self._pos = 0
        self._fresh = []

