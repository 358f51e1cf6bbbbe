"""HermesLet: per-backend warm-state manager (Fig. 4).

Tracks which warmable contents (KV prefix blocks, LoRA adapters, docker
images, DNN tool models) are resident on each backend pool, executes prewarm
signals, and implements the baseline replacement/prefetch policies:

  lru   reactive: load on demand, evict least-recently-used
  epwq  Evict/Prefetch-Waiting-Queue (CachedAttention): prefetch only for
        requests already sitting in the waiting queue
  hermes  PDGraph-driven speculative prewarming (knob K)

Warm-up durations follow Fig. 2 (normalized to a typical 1000/100-token
inference ~ 3 s on the A100-class engine).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

# Fig. 2 warm-up costs, seconds (typical task ~3s; docker ~10x, KV-128K ~2x,
# LoRA ~3x, DNN tools 5-18x).
DEFAULT_WARMUP_S = {
    "docker:python:3.10-slim": 30.0,
    "docker:alfworld-env": 24.0,
    "dnn:vit-large": 15.0,
    "dnn:stable-diffusion": 54.0,
    "dnn:search-index": 6.0,
    "kv": 6.0,        # KV prefix-cache load
    "lora": 9.0,      # LoRA adapter load
}


def warmup_time_for(key: str, table: Optional[Dict[str, float]] = None) -> float:
    t = dict(DEFAULT_WARMUP_S)
    if table:
        t.update(table)
    if key in t:
        return t[key]
    kind = key.split(":", 1)[0]
    return t.get(kind, 10.0)


def warmup_table_from_model(model: str,
                            reference: str = "llama3-8b") -> Dict[str, float]:
    """Derive LLM-side warm-up costs from the model-config zoo.

    The Fig. 2 defaults are calibrated to an A100-class llama3-8b engine;
    serving a different architecture from ``repro_torch.configs`` rescales
    the two LLM warmables against that reference:

    * ``kv``   — prefix-cache load moves KV bytes, which scale with
                 layers x kv-heads x head-dim;
    * ``lora`` — adapter load/merge touches every adapted projection, which
                 scales with total parameter count.

    Merge the result into ``SimConfig.warmup_table`` (explicit entries win).
    """
    from repro_torch.config import get_config
    cfg, ref = get_config(model), get_config(reference)
    kv_bytes = lambda c: c.num_layers * c.num_kv_heads * c.resolved_head_dim()  # noqa: E731
    kv_scale = kv_bytes(cfg) / max(kv_bytes(ref), 1)
    lora_scale = cfg.param_counts()["total"] / max(ref.param_counts()["total"], 1)
    out = {"lora": DEFAULT_WARMUP_S["lora"] * lora_scale}
    if kv_scale > 0:       # attention-free archs (kv_heads=0): a zero scale
        out["kv"] = DEFAULT_WARMUP_S["kv"] * kv_scale
    return out             # would make KV cold starts free — keep the default


@dataclass
class WarmEntry:
    key: str
    warm_at: float            # when loading finishes
    last_used: float
    speculative: bool = False # loaded by a prewarm signal
    used_after_warm: bool = False
    pins: int = 0             # live applications depending on this content
    seq: int = 0              # creation order (LRU-heap tie-break)


class WarmCache:
    """One capacity-bounded warm store (per backend kind)."""

    spec_evict_idle_s = 45.0   # keep-alive: default speculative-evict idle

    def __init__(self, capacity: int, name: str = "",
                 keep_alive_s: Optional[float] = None):
        self.capacity = capacity
        self.name = name
        self.entries: Dict[str, WarmEntry] = {}
        # lazy LRU index: (last_used, creation_seq, key) records, one pushed
        # per touch; stale records (entry evicted or touched since) are
        # dropped when eviction pops them.  Keeps victim selection
        # O(log n) instead of a full min() scan of a 10k+-entry pool.
        self._lru: List[Tuple[float, int, str]] = []
        self._seq = itertools.count()
        self.hits = 0
        self.misses = 0
        self.wasted_warm_s = 0.0   # speculative entries evicted unused
        self.loads = 0
        self.spec_loads = 0        # speculative (prewarm) loads started
        self.spec_used = 0         # of those, later consumed by a task
        if keep_alive_s is not None:
            self.spec_evict_idle_s = keep_alive_s

    def is_warm(self, key: str, now: float) -> bool:
        e = self.entries.get(key)
        return e is not None and e.warm_at <= now

    def is_present(self, key: str) -> bool:
        return key in self.entries

    def lookup(self, key: str, now: float) -> bool:
        """Record a (task-start) access; returns hit."""
        e = self.entries.get(key)
        if e is not None and e.warm_at <= now:
            self.hits += 1
            e.last_used = now
            self._touch(e)
            if e.speculative and not e.used_after_warm:
                self.spec_used += 1     # first use of a prewarmed entry
            e.used_after_warm = True
            return True
        self.misses += 1
        return False

    def begin_load(self, key: str, now: float, t_warm: float,
                   speculative: bool = False) -> Optional[float]:
        """Start (or join) loading `key`; returns absolute warm_at time.
        Speculative loads never evict hot entries (idle < spec_evict_idle_s);
        they return None when no victim qualifies (prewarm skipped) — this is
        what keeps PDGraph prewarming from thrashing a saturated pool."""
        e = self.entries.get(key)
        if e is not None:
            return e.warm_at
        if not self._evict_if_needed(now, speculative):
            return None
        self.loads += 1
        if speculative:
            self.spec_loads += 1
        e = WarmEntry(key=key, warm_at=now + t_warm, last_used=now,
                      speculative=speculative, seq=next(self._seq))
        self.entries[key] = e
        self._touch(e)
        return now + t_warm

    def consume_inflight(self, key: str, now: float) -> Optional[float]:
        """A task joins a load still in flight: the entry is consumed (a
        prewarm that overlapped even partially is NOT wasted), the task
        waits only the remainder.  Returns warm_at, or None if absent."""
        e = self.entries.get(key)
        if e is None:
            return None
        if e.speculative and not e.used_after_warm:
            self.spec_used += 1
        e.used_after_warm = True
        e.last_used = max(e.warm_at, now)
        self._touch(e)
        return e.warm_at

    def _account_waste(self, e: WarmEntry, now: float) -> None:
        if e.speculative and not e.used_after_warm:
            self.wasted_warm_s += max(now - e.warm_at, 0.0)

    def pin(self, key: str) -> None:
        e = self.entries.get(key)
        if e is not None:
            e.pins += 1

    def unpin(self, key: str) -> None:
        e = self.entries.get(key)
        if e is not None:
            e.pins = max(e.pins - 1, 0)

    def _touch(self, e: WarmEntry) -> None:
        heapq.heappush(self._lru, (e.last_used, e.seq, e.key))
        if len(self._lru) > 8 * max(self.capacity, 64):
            # mostly-stale index: rebuild from the live entries
            self._lru = [(x.last_used, x.seq, x.key)
                         for x in self.entries.values()]
            heapq.heapify(self._lru)

    def _pick_victim(self, now: float, speculative: bool) -> Optional[WarmEntry]:
        """Least-recently-used qualifying entry, via the lazy heap.  Pops
        ascend (last_used, creation_seq), so the first unpinned live entry
        IS the seed scan's ``min`` (creation order breaks last_used ties
        exactly like the insertion-ordered dict did).  Records popped past
        (pinned entries) are re-pushed — a later eviction may claim them."""
        skipped: List[Tuple[float, int, str]] = []
        victim = None
        while self._lru:
            rec = heapq.heappop(self._lru)
            lu, seq, key = rec
            e = self.entries.get(key)
            if e is None or e.seq != seq or e.last_used != lu:
                continue                      # stale: evicted or re-touched
            if e.pins == 0:
                # idleness is monotone in last_used: if the LRU-most
                # unpinned entry is too hot to evict speculatively, every
                # later one is hotter — stop either way
                if not speculative or \
                        now - e.last_used >= self.spec_evict_idle_s:
                    victim = e
                else:
                    skipped.append(rec)
                break
            skipped.append(rec)
        if victim is None and not speculative and skipped:
            # demand loads must make progress: all-pinned pool falls back
            # to the overall LRU entry (first valid record popped)
            lu, seq, key = skipped[0]
            victim = self.entries[key]
            skipped = skipped[1:]
        for rec in skipped:
            heapq.heappush(self._lru, rec)
        return victim

    def _evict_if_needed(self, now: float, speculative: bool = False) -> bool:
        while len(self.entries) >= self.capacity:
            # never evict pinned (live-app) or hot contents speculatively;
            # demand loads must always make progress
            victim = self._pick_victim(now, speculative)
            if victim is None:
                return False
            self._account_waste(victim, now)
            del self.entries[victim.key]
        return True

    def finalize(self, now: float) -> None:
        """End-of-run: count speculative entries that were never used."""
        for e in self.entries.values():
            self._account_waste(e, now)

    def hit_ratio(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


class HermesLet:
    """Backend-side agent: owns the warm caches, executes prewarm signals."""

    def __init__(self, *, kv_capacity: int = 16, lora_capacity: int = 10,
                 docker_capacity: int = 32, dnn_capacity: int = 2,
                 warmup_table: Optional[Dict[str, float]] = None,
                 keep_alive_s: Optional[float] = None):
        self.caches: Dict[str, WarmCache] = {
            "kv": WarmCache(kv_capacity, "kv", keep_alive_s),
            "lora": WarmCache(lora_capacity, "lora", keep_alive_s),
            "docker": WarmCache(docker_capacity, "docker", keep_alive_s),
            "dnn": WarmCache(dnn_capacity, "dnn", keep_alive_s),
        }
        self.warmup_table = warmup_table

    def cache_for(self, key: str) -> WarmCache:
        kind = key.split(":", 1)[0]
        return self.caches[kind if kind in self.caches else "dnn"]

    def warmup_time(self, key: str) -> float:
        return warmup_time_for(key, self.warmup_table)

    def is_warm(self, key: str, now: float) -> bool:
        return self.cache_for(key).is_warm(key, now)

    def is_present(self, key: str) -> bool:
        return self.cache_for(key).is_present(key)

    def access(self, key: str, now: float) -> Tuple[bool, float]:
        """Task start: (hit, ready_at).  Miss starts a demand load — if the
        content is mid-load (e.g. a prewarm in flight) the task waits only
        for the remainder."""
        cache = self.cache_for(key)
        if cache.lookup(key, now):
            return True, now
        if cache.is_present(key):  # loading in progress: partial credit
            return False, cache.consume_inflight(key, now)
        t = self.warmup_time_of_key(key)
        ready = cache.begin_load(key, now, t)
        return False, ready if ready is not None else now + t

    def prewarm(self, key: str, now: float) -> Optional[float]:
        cache = self.cache_for(key)
        return cache.begin_load(key, now, self.warmup_time_of_key(key),
                                speculative=True)

    def finalize(self, now: float) -> None:
        for c in self.caches.values():
            c.finalize(now)

    def warmup_time_of_key(self, key: str) -> float:
        return self.warmup_time(key.split("@", 1)[0])

    def pin(self, key: str) -> None:
        self.cache_for(key).pin(key)

    def unpin(self, key: str) -> None:
        self.cache_for(key).unpin(key)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {name: {"hit_ratio": c.hit_ratio(), "hits": c.hits,
                       "misses": c.misses, "loads": c.loads,
                       "spec_loads": c.spec_loads, "spec_used": c.spec_used,
                       "wasted_warm_s": c.wasted_warm_s}
                for name, c in self.caches.items()}
