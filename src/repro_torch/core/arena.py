"""Slot arena: the persistent per-application store behind the fused refresh.

PyTorch counterpart of ``repro.core.arena``.  ``QueueState`` is a
fixed-capacity power-of-two arena of per-app rows; capacity grows by
doubling and every live application keeps ONE slot id for its whole
lifetime (``admit`` pops a host free-list, ``retire`` pushes back — holes
are masked, never compacted away, so device-resident result rows stay
slot-aligned across membership churn).  Host input rows are numpy arrays
mutated in place O(1) per scheduler event; ``mark_dirty`` accumulates the
slots whose PDGraph position changed for the next delta walk.

**Shard placement** (the mesh-sharded refresh, :mod:`repro_torch.core.
refresh_mesh`): with ``n_shards`` > 1 the arena is split into shards by
residue — ``shard_of(slot) = slot % n_shards`` — so a slot's shard is a
pure function of its id and survives capacity doubling.  Each shard owns
its own free-list and dirty set, and its rows sit contiguously in the
device arena in the shard-major row layout

    device_row(slot) = (slot % n_shards) * (capacity // n_shards)
                       + slot // n_shards

(the identity map at one shard), so shard *s*'s rows are the block
``[s * cap_s, (s + 1) * cap_s)``.  Admission takes its slot from the shard
with the most free slots (lowest shard on a tie), as the reference does.

Device rows (torch tensors on the packed KB's device):

* ``d_probs`` / ``d_edges`` — (cap, n_buckets) demand-histogram rows;
  written only by dispatch scatters, read by rank-in-place.
* ``a_hist`` / ``a_lo`` / ``a_span`` / ``a_reach`` — per-(app, unit)
  arrival histograms (delta mode with prewarming; ``a_att`` is the host
  mirror of attained-at-walk).
* ``post`` — (cap, U, U+3) conjugate-posterior sufficient-statistic rows
  (online learning only, :mod:`repro_torch.core.posterior`; never
  allocated without it).

All of them are in device-row order.

Host mirrors: ``rank``, the triage scalars ``sup``/``opt``/``mean`` and the
prewarm rows ``trig``/``reach``.  ``repack()`` rebuilds the arena at the
smallest fitting capacity at a tick boundary and remaps every row.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.pdgraph import ARRIVAL_NEVER, PackedKB, _pow2_ceil


class QueueState:
    """Persistent per-application slot store (see module docstring)."""

    def __init__(self, packed: PackedKB, capacity: int = 64,
                 n_shards: int = 1):
        if n_shards < 1 or n_shards & (n_shards - 1):
            raise ValueError(f"n_shards must be a power of two, "
                             f"got {n_shards}")
        self.n_shards = n_shards
        self.device = packed.device
        self.n_units = packed.n_units
        self.max_samples = packed.n_samples
        cap = max(_pow2_ceil(capacity), n_shards, 1)
        self.graph_idx = np.zeros(cap, np.int32)
        self.start = np.zeros(cap, np.int32)
        self.executed = np.zeros(cap, np.float32)
        self.attained = np.zeros(cap, np.float32)
        self.key_id = np.zeros(cap, np.int32)
        self.refresh_id = np.zeros(cap, np.int32)
        self.deadline = np.full(cap, np.inf, np.float32)
        self.stretch = np.ones(cap, np.float32)
        self.ov_samples = np.zeros((cap, self.n_units, 1), np.float32)
        self.ov_counts = np.zeros((cap, self.n_units), np.int32)
        self.ids: List[Optional[str]] = [None] * cap
        self.slot: Dict[str, int] = {}
        self._occ = np.zeros(cap, bool)
        self._frees: List[List[int]] = [
            list(range(cap - n_shards + s, s - 1, -n_shards))
            for s in range(n_shards)]
        self.live = 0
        self._dirty: List[set] = [set() for _ in range(n_shards)]
        self.rank_dirty: set = set()   # attained moved since last rank write
        self.override_apps = 0       # apps with >= 1 active override row
        self.kb_token = None         # packed-KB version tag (rebuild guard)
        self.repack_epoch = 0        # slot ids are stable within one epoch
        self._nb: Optional[int] = None
        self.d_probs: Optional[torch.Tensor] = None   # (cap, nb) device
        self.d_edges: Optional[torch.Tensor] = None
        self.rank = np.zeros(cap, np.float32)
        self.sup = np.zeros(cap, np.float32)
        self.opt = np.zeros(cap, np.float32)
        self.mean = np.zeros(cap, np.float32)
        self.trig: Optional[np.ndarray] = None    # (cap, B)
        self.reach: Optional[np.ndarray] = None
        self.a_hist: Optional[torch.Tensor] = None  # (cap, U, nb) device
        self.a_lo: Optional[torch.Tensor] = None    # (cap, U) device
        self.a_span: Optional[torch.Tensor] = None
        self.a_reach: Optional[torch.Tensor] = None
        self.a_att: Optional[np.ndarray] = None   # (cap,) attained at walk
        self.post: Optional[torch.Tensor] = None  # (cap, U, U+3) device

    def __len__(self) -> int:
        return self.live

    @property
    def capacity(self) -> int:
        return self.graph_idx.shape[0]

    @property
    def shard_capacity(self) -> int:
        return self.capacity // self.n_shards

    def occupied(self) -> np.ndarray:
        """Slot ids of all live applications, ascending."""
        return np.nonzero(self._occ)[0]

    # ------------------------------------------------------------- placement
    def shard_of(self, slot: int) -> int:
        return slot % self.n_shards

    def device_rows(self, slots: np.ndarray) -> np.ndarray:
        """Shard-major device-arena row of each slot (identity at 1 shard)."""
        s = np.asarray(slots, np.int64)
        return (s % self.n_shards) * self.shard_capacity + s // self.n_shards

    def row_slots(self) -> np.ndarray:
        """Inverse layout map: the slot id stored at each device row."""
        rows = np.arange(self.capacity, dtype=np.int64)
        return (rows % self.shard_capacity) * self.n_shards \
            + rows // self.shard_capacity

    # ------------------------------------------------------------- dirty set
    @property
    def dirty(self) -> set:
        """Union of the per-shard dirty sets (a fresh set)."""
        out: set = set()
        for d in self._dirty:
            out |= d
        return out

    @property
    def dirty_count(self) -> int:
        return sum(len(d) for d in self._dirty)

    def _add_dirty(self, slot: int) -> None:
        self._dirty[slot % self.n_shards].add(slot)

    def mark_dirty(self, app_id: str) -> None:
        i = self.slot.get(app_id)
        if i is not None:
            self._add_dirty(i)

    def dirty_in(self, slots) -> set:
        """Dirty slots among ``slots`` (any iterable of slot ids)."""
        return {s for s in slots if s in self._dirty[s % self.n_shards]}

    def clear_dirty(self, slots) -> None:
        for s in slots:
            self._dirty[int(s) % self.n_shards].discard(int(s))

    def take_dirty(self) -> np.ndarray:
        """Drain the dirty sets (ascending slot ids)."""
        out: List[int] = []
        for d in self._dirty:
            out.extend(d)
            d.clear()
        return np.asarray(sorted(out), np.int64)

    def take_rank_dirty(self, within: Optional[set] = None) -> set:
        """Drain the rank-stale set (optionally only within a slot subset)."""
        if within is None:
            out, self.rank_dirty = self.rank_dirty, set()
            return out
        out = self.rank_dirty & within
        self.rank_dirty -= out
        return out

    # ------------------------------------------------------------- capacity
    _ROWS = ("graph_idx", "start", "executed", "attained", "key_id",
             "refresh_id", "deadline", "stretch", "ov_samples", "ov_counts",
             "rank", "sup", "opt", "mean")
    _DEVICE_ROWS = ("d_probs", "d_edges", "a_hist", "a_lo", "a_span",
                    "a_reach", "post")

    @property
    def _free(self) -> List[int]:
        """Flat view of the per-shard free-lists."""
        return [s for f in self._frees for s in f]

    def _free_count(self) -> int:
        return sum(len(f) for f in self._frees)

    def _take_slot(self) -> int:
        """Pop a free slot from the shard with the most free slots (lowest
        shard on a tie), growing the arena first when it is full."""
        if not self._free_count():
            self._grow()
        shard = max(range(self.n_shards), key=lambda s: len(self._frees[s]))
        return self._frees[shard].pop()

    def _grow(self) -> None:
        old = self.capacity
        extra = ("trig", "reach") if self.trig is not None else ()
        extra += ("a_att",) if self.a_att is not None else ()
        for name in self._ROWS + extra:
            a = getattr(self, name)
            b = np.zeros((old * 2,) + a.shape[1:], a.dtype)
            b[:old] = a
            setattr(self, name, b)
        self.deadline[old:] = np.inf
        self.stretch[old:] = 1.0
        if self.trig is not None:
            self.trig[old:] = ARRIVAL_NEVER
        self.ids.extend([None] * old)
        self._occ = np.concatenate([self._occ, np.zeros(old, bool)])
        n = self.n_shards
        for s in range(n):
            self._frees[s].extend(range(old * 2 - n + s, old - 1, -n))
        # shard-major layout: each shard's block grows in place, so old rows
        # keep their row within the shard (a plain concatenation at 1 shard)
        cs = old // n
        for name in self._DEVICE_ROWS:
            a = getattr(self, name)
            if a is not None:
                blocks = a.reshape((n, cs) + a.shape[1:])
                setattr(self, name, torch.cat(
                    [blocks, torch.zeros_like(blocks)], dim=1)
                    .reshape((old * 2,) + a.shape[1:]))

    def _grow_override_width(self, width: int) -> None:
        width = min(_pow2_ceil(width), self.max_samples)
        if width <= self.ov_samples.shape[2]:
            return
        b = np.zeros(self.ov_samples.shape[:2] + (width,), np.float32)
        b[:, :, :self.ov_samples.shape[2]] = self.ov_samples
        self.ov_samples = b

    def ensure_result_rows(self, n_buckets: int,
                           n_classes: Optional[int] = None,
                           arrivals: bool = False) -> None:
        """Allocate (or re-shape) the persisted result rows."""
        cap, dev = self.capacity, self.device
        if self._nb != n_buckets or self.d_probs is None:
            self._nb = n_buckets
            self.d_probs = torch.zeros((cap, n_buckets), dtype=torch.float32,
                                       device=dev)
            self.d_edges = torch.zeros_like(self.d_probs)
            self.a_hist = None      # bucket count changed: arrival rows too
        if n_classes is not None and (
                self.trig is None or self.trig.shape[1] != n_classes):
            self.trig = np.full((cap, n_classes), ARRIVAL_NEVER, np.float32)
            self.reach = np.zeros((cap, n_classes), np.float32)
        if arrivals and self.a_hist is None:
            U = self.n_units
            self.a_hist = torch.zeros((cap, U, n_buckets),
                                      dtype=torch.float32, device=dev)
            self.a_lo = torch.zeros((cap, U), dtype=torch.float32, device=dev)
            self.a_span = torch.full((cap, U), 1e-6, dtype=torch.float32,
                                     device=dev)
            self.a_reach = torch.zeros_like(self.a_lo)
            self.a_att = np.zeros(cap, np.float32)

    def ensure_posterior_rows(self) -> None:
        """Allocate the device posterior rows (online learning only)."""
        if self.post is None:
            from repro_torch.core.posterior import row_width
            U = self.n_units
            self.post = torch.zeros((self.capacity, U, row_width(U)),
                                    dtype=torch.float32, device=self.device)

    def update_posterior_rows(self, slots: np.ndarray,
                              vals: np.ndarray) -> None:
        """Write freshly folded posterior stats into the slots' device rows:
        ``vals`` is ``(len(slots), U, U+3)`` float32."""
        if len(slots) == 0:
            return
        self.ensure_posterior_rows()
        rows = torch.as_tensor(self.device_rows(slots), device=self.device)
        self.post[rows] = torch.as_tensor(np.asarray(vals, np.float32),
                                          device=self.device)

    def posterior_rows(self, slots: np.ndarray) -> np.ndarray:
        """Read back the device posterior rows of a slot subset."""
        self.ensure_posterior_rows()
        rows = torch.as_tensor(self.device_rows(slots), device=self.device)
        return self.post[rows].cpu().numpy()

    # ------------------------------------------------------------ lifecycle
    def admit(self, app_id: str, graph_idx: int, start: int, key_id: int,
              refresh_id: int = 0, deadline: Optional[float] = None,
              stretch: float = 1.0) -> int:
        """Take a free slot for a new application (grow by doubling when
        the arena is full) from the shard with the most free slots; the
        slot starts dirty."""
        i = self._take_slot()
        self.ids[i] = app_id
        self.slot[app_id] = i
        self._occ[i] = True
        self.live += 1
        self.graph_idx[i] = graph_idx
        self.start[i] = start
        self.executed[i] = 0.0
        self.attained[i] = 0.0
        self.key_id[i] = key_id
        self.refresh_id[i] = refresh_id
        self.deadline[i] = np.inf if deadline is None else deadline
        self.stretch[i] = stretch
        self.ov_counts[i] = 0
        self._add_dirty(i)
        return i

    def admit_many(self, rows: Sequence[tuple]) -> np.ndarray:
        """Admit a batch: ``rows`` of ``(app_id, graph_idx, start, key_id,
        deadline)``; slot choice is identical to :meth:`admit` per row."""
        n = len(rows)
        slots = np.empty(n, np.int64)
        for j, (app_id, *_rest) in enumerate(rows):
            i = self._take_slot()
            slots[j] = i
            self.ids[i] = app_id
            self.slot[app_id] = i
            self._add_dirty(i)
        self._occ[slots] = True
        self.live += n
        self.graph_idx[slots] = [r[1] for r in rows]
        self.start[slots] = [r[2] for r in rows]
        self.executed[slots] = 0.0
        self.attained[slots] = 0.0
        self.key_id[slots] = [r[3] for r in rows]
        self.refresh_id[slots] = 0
        self.deadline[slots] = [np.inf if r[4] is None else r[4]
                                for r in rows]
        self.stretch[slots] = 1.0
        self.ov_counts[slots] = 0
        return slots

    def retire_many(self, app_ids: Sequence[str]) -> np.ndarray:
        """Release a batch of applications' slots (unknown ids skipped)."""
        freed: List[int] = []
        for app_id in app_ids:
            i = self.slot.pop(app_id, None)
            if i is None:
                continue
            if self.ov_counts[i].any():
                self.override_apps -= 1
            self.ids[i] = None
            freed.append(i)
            self._dirty[i % self.n_shards].discard(i)
            self.rank_dirty.discard(i)
            self._frees[i % self.n_shards].append(i)
        out = np.asarray(freed, np.int64)
        if len(out):
            self._occ[out] = False
            self.ov_counts[out] = 0
            self.live -= len(out)
        return out

    def mark_dirty_many(self, app_ids: Sequence[str]) -> None:
        for app_id in app_ids:
            self.mark_dirty(app_id)

    def retire(self, app_id: str) -> None:
        """Release an application's slot back to its shard's free-list."""
        self.retire_many([app_id])

    # --------------------------------------------------------------- events
    def set_unit(self, app_id: str, unit_idx: int) -> None:
        i = self.slot[app_id]
        self.start[i] = unit_idx
        self.executed[i] = 0.0
        self._add_dirty(i)

    def add_progress(self, app_id: str, delta: float) -> None:
        # progress does NOT dirty the slot: the TOTAL-demand histogram stays
        # valid and rank-in-place re-ranks at the new attained each tick
        i = self.slot[app_id]
        self.executed[i] += delta
        self.attained[i] += delta
        self.rank_dirty.add(i)

    def set_override(self, app_id: str, unit_idx: int,
                     arr: np.ndarray) -> None:
        i = self.slot[app_id]
        arr = np.asarray(arr, np.float32)[:self.max_samples]
        if len(arr) == 0:
            return
        self._grow_override_width(len(arr))
        arr = arr[:self.ov_samples.shape[2]]
        if not self.ov_counts[i].any():
            self.override_apps += 1
        self.ov_samples[i, unit_idx, :len(arr)] = arr
        self.ov_counts[i, unit_idx] = len(arr)
        self._add_dirty(i)

    def get_deadline(self, slot: int) -> Optional[float]:
        d = self.deadline[slot]
        return None if np.isinf(d) else float(d)

    def set_stretch(self, app_id: str, stretch: float) -> None:
        self.stretch[self.slot[app_id]] = stretch

    def bump_refresh(self, slots: np.ndarray) -> None:
        self.refresh_id[slots] += 1

    # --------------------------------------------------------------- repack
    def maybe_repack(self, occupancy_threshold: float = 0.25,
                     min_capacity: int = 64) -> Optional[Dict[int, int]]:
        """Shrink the arena when occupancy fell below the threshold (and a
        smaller power of two fits).  Returns the old->new slot map when a
        repack happened.  Call ONLY at a tick boundary."""
        cap = self.capacity
        target = max(_pow2_ceil(max(self.live, 1)), min_capacity,
                     self.n_shards)
        if cap <= min_capacity or self.live > occupancy_threshold * cap \
                or target >= cap:
            return None
        return self.repack(target)

    def repack(self, new_capacity: Optional[int] = None) -> Dict[int, int]:
        """Rebuild the arena at ``new_capacity`` (default: smallest fitting
        power of two), renumbering live slots densely in ascending old-slot
        order; every host row and device row is remapped (no re-walk)."""
        old_cap, n = self.capacity, self.n_shards
        new_cap = max(_pow2_ceil(new_capacity or max(self.live, 1)), n, 1)
        old_slots = self.occupied()                       # ascending
        if len(old_slots) > new_cap:
            raise ValueError(f"repack to {new_cap} < live {len(old_slots)}")
        new_slots = np.arange(len(old_slots), dtype=np.int64)
        mapping = dict(zip(old_slots.tolist(), new_slots.tolist()))
        src = np.zeros(new_cap, np.int64)                 # old slot per new
        src[new_slots] = old_slots
        fill = np.zeros(new_cap, bool)
        fill[new_slots] = True
        for name in self._ROWS + (("trig", "reach")
                                  if self.trig is not None else ()) \
                + (("a_att",) if self.a_att is not None else ()):
            a = getattr(self, name)
            b = np.zeros((new_cap,) + a.shape[1:], a.dtype)
            b[fill] = a[src[fill]]
            setattr(self, name, b)
        self.deadline[~fill] = np.inf
        self.stretch[~fill] = 1.0
        if self.trig is not None:
            self.trig[~fill] = ARRIVAL_NEVER
        # device rows: one gather in the new shard-major row order (hole rows
        # read row 0 — garbage-in-bounds, masked like any other hole)
        new_cs = new_cap // n
        rows = np.arange(new_cap, dtype=np.int64)
        nslot = (rows % new_cs) * n + rows // new_cs       # slot per new row
        old_row = np.where(fill[nslot], (src[nslot] % n) * (old_cap // n)
                           + src[nslot] // n, 0)
        gidx = torch.as_tensor(old_row, device=self.device)
        for name in self._DEVICE_ROWS:
            a = getattr(self, name)
            if a is not None:
                setattr(self, name, a[gidx])
        old_ids = self.ids
        self.ids = [None] * new_cap
        for old, new in mapping.items():
            self.ids[new] = old_ids[old]
            self.slot[old_ids[old]] = new
        self._occ = fill
        self._frees = [[s for s in range(new_cap - n + sh, sh - 1, -n)
                        if not fill[s]] for sh in range(n)]
        remap = lambda ss: {mapping[s] for s in ss if s in mapping}  # noqa: E731
        old_dirty = self.dirty
        self._dirty = [set() for _ in range(n)]
        for s in remap(old_dirty):
            self._dirty[s % n].add(s)
        self.rank_dirty = remap(self.rank_dirty)
        self.repack_epoch += 1
        return mapping

    # ------------------------------------------------------------- dispatch
    def gather(self, slots: np.ndarray,
               pad_to: Optional[int] = None) -> Tuple[np.ndarray, ...]:
        """Padded dispatch view of a slot subset, padded (default: to a
        power of two) by repeating the first row."""
        n = len(slots)
        ap = max(pad_to if pad_to is not None else _pow2_ceil(n), 1)
        pad_slot = int(slots[0]) if n else 0
        idx = np.concatenate([np.asarray(slots, np.int64),
                              np.full(ap - n, pad_slot, np.int64)])
        return (self.graph_idx[idx], self.start[idx], self.executed[idx],
                self.attained[idx], self.key_id[idx], self.refresh_id[idx],
                self.stretch[idx], self.ov_samples[idx], self.ov_counts[idx])


def build_queue_state(packed: PackedKB, apps: Sequence, kb_token=None,
                      n_shards: int = 1) -> QueueState:
    """Rebuild a QueueState from live AppRuntime records; every admitted
    slot starts dirty, so the next delta tick re-walks the whole queue."""
    qs = QueueState(packed, capacity=max(len(apps), 64), n_shards=n_shards)
    qs.kb_token = kb_token
    for a in apps:
        g = packed.graph_index[a.app_name]
        start = (packed.unit_index[g][a.current_unit] if a.current_unit
                 else int(packed.entry[g]))
        i = qs.admit(a.app_id, g, start, a.key_id, a.refreshes,
                     deadline=a.deadline,
                     stretch=getattr(a, "queue_stretch", 1.0))
        qs.executed[i] = a.attained_in_unit
        qs.attained[i] = a.attained
        for name, arr in (a.overrides or {}).items():
            uidx = packed.unit_index[g]
            if name in uidx:
                qs.set_override(a.app_id, uidx[name], arr)
    return qs
