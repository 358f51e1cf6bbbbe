"""Paged KV-cache allocator + prefix cache.

The allocator manages fixed-size blocks over a preallocated arena the way
vLLM's block manager does (free list, per-sequence block tables, copy-on-
extend); here it tracks *capacity* for the engine (the decode step uses
per-slot dense caches — the arena bounds how many slots/prefixes may be
resident, which is the knob the paper's KV prewarming experiment turns).

The prefix cache stores computed prefix KV tensors keyed by prefix id, with
pin counts and LRU eviction — prewarming = asking the store to materialize a
prefix ahead of the request (HermesLet calls ``load``).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class BlockTable:
    seq_id: str
    blocks: List[int] = field(default_factory=list)
    length: int = 0


class PagedAllocator:
    def __init__(self, n_blocks: int, block_size: int = 16):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.free: List[int] = list(range(n_blocks))
        self.tables: Dict[str, BlockTable] = {}

    def can_allocate(self, n_tokens: int) -> bool:
        need = (n_tokens + self.block_size - 1) // self.block_size
        return len(self.free) >= need

    def allocate(self, seq_id: str, n_tokens: int) -> BlockTable:
        need = (n_tokens + self.block_size - 1) // self.block_size
        if len(self.free) < need:
            raise MemoryError(f"KV arena exhausted ({seq_id}: need {need}, "
                              f"free {len(self.free)})")
        t = BlockTable(seq_id, [self.free.pop() for _ in range(need)], n_tokens)
        self.tables[seq_id] = t
        return t

    def extend(self, seq_id: str, n_new: int) -> None:
        t = self.tables[seq_id]
        t.length += n_new
        need = (t.length + self.block_size - 1) // self.block_size
        while len(t.blocks) < need:
            if not self.free:
                raise MemoryError(f"KV arena exhausted extending {seq_id}")
            t.blocks.append(self.free.pop())

    def release(self, seq_id: str) -> None:
        t = self.tables.pop(seq_id, None)
        if t:
            self.free.extend(t.blocks)

    def utilization(self) -> float:
        return 1.0 - len(self.free) / max(self.n_blocks, 1)


@dataclass
class PrefixEntry:
    prefix_id: str
    caches: Any            # model cache pytree for the prefix tokens
    length: int
    blocks: int
    last_used: float
    pinned: int = 0
    speculative: bool = False
    used: bool = False


class PrefixCache:
    """Capacity-bounded store of computed prefix KV caches."""

    def __init__(self, allocator: PagedAllocator,
                 compute_fn: Callable[[str], Tuple[Any, int]]):
        """compute_fn(prefix_id) -> (caches, length)."""
        self.alloc = allocator
        self.compute_fn = compute_fn
        self.entries: Dict[str, PrefixEntry] = {}
        self.hits = 0
        self.misses = 0
        self.lock = threading.Lock()

    def _evict_for(self, blocks: int) -> bool:
        while len(self.alloc.free) < blocks:
            victims = [e for e in self.entries.values() if e.pinned == 0]
            if not victims:
                return False
            v = min(victims, key=lambda e: e.last_used)
            self.alloc.release(f"prefix:{v.prefix_id}")
            del self.entries[v.prefix_id]
        return True

    def load(self, prefix_id: str, speculative: bool = False) -> bool:
        """Materialize (prewarm) a prefix; returns success."""
        with self.lock:
            if prefix_id in self.entries:
                return True
        caches, length = self.compute_fn(prefix_id)   # the actual prefill work
        blocks = (length + self.alloc.block_size - 1) // self.alloc.block_size
        with self.lock:
            if prefix_id in self.entries:
                return True
            if not self._evict_for(blocks):
                return False
            self.alloc.allocate(f"prefix:{prefix_id}", length)
            self.entries[prefix_id] = PrefixEntry(
                prefix_id, caches, length, blocks, time.monotonic(),
                speculative=speculative)
            return True

    def lookup(self, prefix_id: str) -> Optional[PrefixEntry]:
        with self.lock:
            e = self.entries.get(prefix_id)
            if e is None:
                self.misses += 1
                return None
            self.hits += 1
            e.last_used = time.monotonic()
            e.used = True
            return e

    def hit_ratio(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0
