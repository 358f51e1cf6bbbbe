"""Probabilistic Demand Graph (PDGraph) — the paper's demand model (§3.2).

PyTorch counterpart of ``repro.core.pdgraph``.  The recording side
(``BackendSpec``, ``UnitNode``, ``PDGraph``) is host Python and numpy, kept
line for line so both packages build the same knowledge base from the same
seed.  ``PackedKB`` holds the padded ``(G, U, S)`` unit tables as torch
tensors on one device; ``packed_kb_from_arrays`` rebuilds it from plain
numpy arrays, and ``PDGraph.to_json``/``from_json`` round-trip a graph, so a
knowledge base can cross between the two packages without either importing
the other.

Not ported in this slice: the threefry walker behind
``PDGraph.mc_service_samples`` and ``mc_service_samples_batch`` (the
looped/composed refresh modes) — ROADMAP.md, modules to port, item 9.
The refresh pipeline's counter-RNG walk lives in
``repro_torch.kernels.pdgraph_walk``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

MAX_SAMPLES = 1000  # FIFO cap per the paper
N_BUCKETS = 10
ARRIVAL_NEVER = 1e30   # first-arrival sentinel: unit never reached


@dataclass(frozen=True)
class BackendSpec:
    kind: str                 # "llm" | "docker" | "dnn"
    model: str = ""           # LLM name / docker image / DNN tool name
    lora: str = ""            # optional LoRA adapter id
    prefix: str = ""          # shared-system-prompt id (KV prefix cache key)

    def resource_keys(self) -> Tuple[str, ...]:
        """Identities of the warmable backend contents this unit needs."""
        if self.kind == "llm":
            keys = []
            if self.lora:
                keys.append(f"lora:{self.lora}")
            if self.prefix:
                keys.append(f"kv:{self.prefix}")
            return tuple(keys)
        return (f"{self.kind}:{self.model}",)

    def resource_key(self) -> str:
        keys = self.resource_keys()
        return keys[0] if keys else f"llm:{self.model}"


@dataclass
class UnitNode:
    name: str
    backend: BackendSpec
    input_len: List[float] = field(default_factory=list)
    output_len: List[float] = field(default_factory=list)
    parallelism: List[float] = field(default_factory=list)
    duration: List[float] = field(default_factory=list)   # non-LLM wall time
    next_counts: Dict[str, int] = field(default_factory=dict)  # incl. "$end"
    corr_mask: Dict[str, bool] = field(default_factory=dict)

    def next_probs(self) -> Dict[str, float]:
        tot = sum(self.next_counts.values())
        if not tot:
            return {"$end": 1.0}
        return {k: v / tot for k, v in self.next_counts.items()}

    def service_samples(self, t_in: float, t_out: float) -> np.ndarray:
        """Per-trial unit service demand in seconds (LLM: parallelism *
        (in*t_in + out*t_out); non-LLM: recorded duration)."""
        if self.backend.kind == "llm":
            i = np.asarray(self.input_len, np.float64)
            o = np.asarray(self.output_len, np.float64)
            p = np.asarray(self.parallelism, np.float64)
            n = min(len(i), len(o), len(p))
            if n == 0:
                return np.asarray([1.0])
            return p[:n] * (i[:n] * t_in + o[:n] * t_out)
        d = np.asarray(self.duration, np.float64)
        return d if len(d) else np.asarray([1.0])


def _fifo(lst: List, x) -> None:
    lst.append(float(x))
    if len(lst) > MAX_SAMPLES:
        del lst[0]


class PDGraph:
    """Knowledge-base entry for one application."""

    def __init__(self, app_name: str, entry: str,
                 units: Optional[Dict[str, UnitNode]] = None):
        self.app_name = app_name
        self.entry = entry
        self.units: Dict[str, UnitNode] = units or {}
        # per-trial joined records for correlation / conditional refinement:
        # trials[i][unit_name] = {"in":..,"out":..,"par":..,"dur":..}
        self.trials: List[Dict[str, Dict[str, float]]] = []
        self._compiled = None
        self.version = 0          # bumped on every record_trial (pack caches)

    def record_trial(self, trace: Sequence[Tuple[str, Dict[str, float]]]) -> None:
        """trace: ordered [(unit_name, {"in","out","par","dur"}), ...]."""
        rec: Dict[str, Dict[str, float]] = {}
        prev: Optional[str] = None
        for name, obs in trace:
            u = self.units[name]
            if u.backend.kind == "llm":
                _fifo(u.input_len, obs.get("in", 0))
                _fifo(u.output_len, obs.get("out", 0))
                _fifo(u.parallelism, obs.get("par", 1))
            else:
                _fifo(u.duration, obs.get("dur", 0))
            if prev is not None:
                self.units[prev].next_counts[name] = \
                    self.units[prev].next_counts.get(name, 0) + 1
            rec[name] = dict(obs)
            prev = name
        if prev is not None:
            self.units[prev].next_counts["$end"] = \
                self.units[prev].next_counts.get("$end", 0) + 1
        self.trials.append(rec)
        if len(self.trials) > MAX_SAMPLES:
            del self.trials[0]
        self._compiled = None
        self.version += 1

    def compile_arrays(self, t_in: float, t_out: float):
        """Pack the graph into dense numpy arrays (one graph's unit tables)."""
        if self._compiled is not None and self._compiled[0] == (t_in, t_out):
            return self._compiled[1]
        names = sorted(self.units)
        idx = {n: i for i, n in enumerate(names)}
        U = len(names)
        S = max(max((len(self.units[n].service_samples(t_in, t_out))
                     for n in names), default=1), 1)
        samples = np.zeros((U, S), np.float32)
        counts = np.zeros((U,), np.int32)
        cum_trans = np.zeros((U, U + 1), np.float32)
        for n in names:
            u = self.units[n]
            sv = u.service_samples(t_in, t_out)
            counts[idx[n]] = len(sv)
            samples[idx[n], :len(sv)] = sv
            probs = np.zeros(U + 1, np.float32)
            for tgt, pr in u.next_probs().items():
                probs[U if tgt == "$end" else idx[tgt]] = pr
            cum_trans[idx[n]] = np.cumsum(probs)
        packed = {"names": names, "index": idx, "samples": samples,
                  "counts": counts, "cum_trans": cum_trans,
                  "entry": idx[self.entry]}
        self._compiled = ((t_in, t_out), packed)
        return packed

    def to_json(self) -> str:
        d = {
            "app_name": self.app_name, "entry": self.entry,
            "units": {n: {
                "backend": dataclasses.asdict(u.backend),
                "input_len": u.input_len, "output_len": u.output_len,
                "parallelism": u.parallelism, "duration": u.duration,
                "next_counts": u.next_counts, "corr_mask": u.corr_mask,
            } for n, u in self.units.items()},
            "trials": self.trials,
        }
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "PDGraph":
        d = json.loads(s)
        units = {}
        for n, ud in d["units"].items():
            units[n] = UnitNode(
                name=n, backend=BackendSpec(**ud["backend"]),
                input_len=ud["input_len"], output_len=ud["output_len"],
                parallelism=ud["parallelism"], duration=ud["duration"],
                next_counts={k: int(v) for k, v in ud["next_counts"].items()},
                corr_mask=ud.get("corr_mask", {}))
        g = cls(d["app_name"], d["entry"], units)
        g.trials = d.get("trials", [])
        return g


@dataclass(frozen=True)
class PackedKB:
    """Every PDGraph in a knowledge base padded into shared unit tables,
    held as tensors on ``samples.device``."""
    names: Tuple[str, ...]                 # graph order
    graph_index: Dict[str, int]            # app_name -> graph row
    unit_index: Tuple[Dict[str, int], ...]  # per graph: unit name -> local idx
    entry: np.ndarray                      # (G,) int32 entry-unit index
    samples: torch.Tensor                  # (G, U, S) float32
    counts: torch.Tensor                   # (G, U) int32
    cum_trans: torch.Tensor                # (G, U, U+1) float32

    @property
    def n_units(self) -> int:
        return self.samples.shape[1]

    @property
    def n_samples(self) -> int:
        return self.samples.shape[2]

    @property
    def device(self) -> torch.device:
        return self.samples.device


def packed_kb_from_arrays(names: Sequence[str],
                          unit_index: Sequence[Dict[str, int]],
                          entry: np.ndarray, samples: np.ndarray,
                          counts: np.ndarray, cum_trans: np.ndarray,
                          device: DeviceLike = None) -> PackedKB:
    """Build a :class:`PackedKB` from plain arrays: ``samples (G, U, S)``
    float32, ``counts (G, U)`` int32, ``cum_trans (G, U, U+1)`` float32,
    ``entry (G,)``, graph names in row order and per-graph unit index
    maps.  The tensors land on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    names = tuple(names)
    return PackedKB(
        names=names,
        graph_index={n: i for i, n in enumerate(names)},
        unit_index=tuple(dict(u) for u in unit_index),
        entry=np.asarray(entry, np.int32),
        samples=torch.tensor(np.asarray(samples, np.float32), device=dev),
        counts=torch.tensor(np.asarray(counts, np.int32), device=dev),
        cum_trans=torch.tensor(np.asarray(cum_trans, np.float32),
                               device=dev))


def pack_graphs(graphs: Dict[str, PDGraph], t_in: float, t_out: float,
                device: DeviceLike = None) -> PackedKB:
    """Pad all graphs' compiled arrays to a common (U, S) so one walker
    serves the whole knowledge base.  Padding units absorb on their first
    transition (end-probability 1, zero service), so walkers can never pick
    up demand from another graph's rows."""
    names = tuple(sorted(graphs))
    packs = [graphs[n].compile_arrays(t_in, t_out) for n in names]
    G = len(names)
    U = max((p["cum_trans"].shape[0] for p in packs), default=1)
    S = max((p["samples"].shape[1] for p in packs), default=1)
    samples = np.zeros((G, U, S), np.float32)
    counts = np.ones((G, U), np.int32)
    cum = np.zeros((G, U, U + 1), np.float32)
    cum[:, :, -1] = 1.0                     # pad rows: absorb immediately
    entry = np.zeros((G,), np.int32)
    for g, p in enumerate(packs):
        Ug = p["cum_trans"].shape[0]
        sg = p["samples"]
        samples[g, :Ug, :sg.shape[1]] = sg
        counts[g, :Ug] = p["counts"]
        cg = p["cum_trans"]                 # (Ug, Ug+1) cumulative
        probs = np.diff(np.concatenate(
            [np.zeros((Ug, 1), np.float32), cg], axis=1), axis=1)
        padded = np.zeros((Ug, U + 1), np.float32)
        padded[:, :Ug] = probs[:, :Ug]      # real targets keep local indices
        padded[:, U] = probs[:, Ug]         # "$end" moves to the shared sink
        cum[g, :Ug] = np.cumsum(padded, axis=1)
        entry[g] = int(p["entry"])
    return packed_kb_from_arrays(names, [p["index"] for p in packs], entry,
                                 samples, counts, cum, device=device)


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()

