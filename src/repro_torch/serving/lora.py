"""LoRA adapter pool for the serving engine.

Adapters are low-rank (A, B) deltas on the attention q/v projections.  The
engine serves with *merged* weights (W + scale·A·B), so "loading" an adapter
is a real, measurable merge cost — the warm-up the paper's Fig. 13(b)
prewarming experiment hides or exposes.  The pool holds at most `capacity`
merged parameter sets (cf. vLLM's max-loras), LRU-evicted.

Parameter sets are dicts of tensors by the model's parameter names
(``Model.params()``).  A merged set is a new dict that holds new ``wq`` and
``wv`` tensors and shares every other tensor with the base set.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
_TARGETS = ("attn.wq", "attn.wv")


@dataclass
class LoraAdapter:
    lora_id: str
    rank: int
    deltas: Dict[str, Tuple[torch.Tensor, torch.Tensor]]  # name -> (A, B)
    scale: float = 1.0


def adapter_seed(lora_id: str, seed: int) -> int:
    """A seed that is the same in every process.  (The JAX package seeds
    with ``hash((lora_id, seed))``, which Python salts per process for
    strings, so its adapters differ from run to run.)"""
    return zlib.crc32(f"{lora_id}\0{seed}".encode()) & 0x7FFFFFFF


def make_random_adapter(lora_id: str, params: Params, rank: int = 8,
                        seed: int = 0, scale: float = 0.5) -> LoraAdapter:
    """Random adapter touching every attention wq/wv, drawn in float32 on
    the weights' device."""
    deltas = {}
    gen = None
    for name in sorted(params):
        if not name.endswith(_TARGETS):
            continue
        w = params[name]
        if gen is None:
            gen = torch.Generator(device=w.device).manual_seed(
                adapter_seed(lora_id, seed))
        din, dout = w.shape
        kw = dict(generator=gen, device=w.device, dtype=torch.float32)
        a = torch.randn((din, rank), **kw) * 0.02
        b = torch.randn((rank, dout), **kw) * 0.02
        deltas[name] = (a, b)
    return LoraAdapter(lora_id, rank, deltas, scale)


def lora_from_jax(adapter: Any, device="cpu") -> LoraAdapter:
    """The JAX package's ``LoraAdapter`` (deltas on stacked leaves
    ``layers/sub0/attn/wq``, arrays of shape (n, din, r) and (n, r, dout))
    as the port's per-layer adapter."""
    deltas = {}
    for path, (a, b) in adapter.deltas.items():
        *_, group, leaf = path.split("/")
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        for i in range(a.shape[0]):
            deltas[f"layers.{i}.{group}.{leaf}"] = (
                torch.tensor(a[i], device=device),
                torch.tensor(b[i], device=device))
    return LoraAdapter(adapter.lora_id, adapter.rank, deltas, adapter.scale)


def merge_adapter(params: Params, adapter: LoraAdapter) -> Params:
    """W' = W + scale * A @ B, in float32, cast to W's dtype; a new set
    sharing every weight the adapter does not touch."""
    out = dict(params)
    for name, (a, b) in adapter.deltas.items():
        w = params[name]
        delta = (a @ b) * adapter.scale
        out[name] = (w.float() + delta).to(w.dtype)
    return out


def _sync(params: Params) -> None:
    dev = next(iter(params.values())).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class _PoolEntry:
    params: Params
    last_used: float
    speculative: bool = False
    used: bool = False


class LoraPool:
    def __init__(self, base_params: Params, capacity: int = 4):
        self.base = base_params
        self.capacity = capacity
        self.adapters: Dict[str, LoraAdapter] = {}
        self.merged: Dict[str, _PoolEntry] = {}
        self.hits = 0
        self.misses = 0
        self.merges = 0

    def register(self, adapter: LoraAdapter) -> None:
        self.adapters[adapter.lora_id] = adapter

    def is_warm(self, lora_id: str) -> bool:
        return lora_id in self.merged

    def load(self, lora_id: str, speculative: bool = False) -> None:
        """Merge (prewarm) an adapter into the pool."""
        if lora_id in self.merged:
            return
        while len(self.merged) >= self.capacity:
            victim = min(self.merged, key=lambda k: self.merged[k].last_used)
            del self.merged[victim]
        merged = merge_adapter(self.base, self.adapters[lora_id])
        _sync(merged)
        self.merges += 1
        self.merged[lora_id] = _PoolEntry(merged, time.monotonic(),
                                          speculative=speculative)

    def get(self, lora_id: Optional[str]) -> Params:
        """Params for a request (base when no adapter). Cold -> merge inline."""
        if not lora_id:
            return self.base
        e = self.merged.get(lora_id)
        if e is None:
            self.misses += 1
            self.load(lora_id)
            e = self.merged[lora_id]
        else:
            self.hits += 1
        e.last_used = time.monotonic()
        e.used = True
        return e.params
