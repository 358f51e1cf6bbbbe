"""Probabilistic Demand Graph (PDGraph) — the paper's demand model (§3.2).

PyTorch counterpart of ``repro.core.pdgraph``.  The recording side
(``BackendSpec``, ``UnitNode``, ``PDGraph``) is host Python and numpy, kept
line for line so both packages build the same knowledge base from the same
seed.  ``PackedKB`` holds the padded ``(G, U, S)`` unit tables as torch
tensors on one device; ``packed_kb_from_arrays`` rebuilds it from plain
numpy arrays, and ``PDGraph.to_json``/``from_json`` round-trip a graph, so a
knowledge base can cross between the two packages without either importing
the other.

The host-sample walker is the reference's threefry walk in plain PyTorch
on the tables' device: ``PDGraph.mc_service_samples`` walks one graph (the
``looped`` refresh mode), ``mc_service_samples_batch`` a whole queue over
the packed tables (``composed``, and ``walker="threefry"`` in the fused
pipelines).  Keyed by the same ``fold_in`` chain over
:mod:`repro_torch.core.threefry`, it gives the reference's samples bit for
bit.  The refresh pipeline's counter-RNG walk lives in
``repro_torch.kernels.pdgraph_walk``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import threefry
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

    def mc_service_samples(self, key: torch.Tensor, t_in: float,
                           t_out: float, start_unit: Optional[str] = None,
                           executed_in_unit: float = 0.0,
                           unit_sample_override: Optional[
                               Dict[str, np.ndarray]] = None,
                           n_walkers: int = 512, max_steps: int = 64,
                           device: DeviceLike = None) -> np.ndarray:
        """Remaining-service-time samples ``(n_walkers,)`` from
        ``start_unit`` (default: entry), walked on ``device`` (default
        ``cuda``) from the threefry ``key`` (two words, see
        :mod:`repro_torch.core.threefry`).

        ``unit_sample_override`` replaces a unit's demand samples (the
        online conditional refinement hook).  ``executed_in_unit``
        subtracts attained service inside the current unit (floored at 0
        per walker)."""
        dev = resolve_device(device)
        packed = self.compile_arrays(t_in, t_out)
        samples, counts = packed["samples"], packed["counts"]
        if unit_sample_override:
            samples = np.array(samples)
            counts = np.array(counts)
            for name, arr in unit_sample_override.items():
                i = packed["index"][name]
                arr = np.asarray(arr, np.float32)[:samples.shape[1]]
                if len(arr) == 0:
                    continue
                samples[i, :len(arr)] = arr
                counts[i] = len(arr)
        start = packed["index"][start_unit] if start_unit else packed["entry"]
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        out = _mc_walk(t(samples), t(counts), t(packed["cum_trans"]), start,
                       executed_in_unit, key.to(dev), n_walkers, max_steps)
        return out.cpu().numpy()

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


# Elements of one uniform-stream chunk (``walk_uniforms`` holds ~10 int64
# temporaries of this size): bounds the hash's memory on a long queue.
_STREAM_CHUNK = 1 << 22


def _walk_core(samples, counts, cum_trans, graph_idx, start, executed, keys,
               ov_samples, ov_counts, n_walkers: int, max_steps: int,
               track_arrivals: bool = False, po_cum=None, po_scale=None):
    """Random walks of A applications over the packed ``(G, U, S)`` unit
    tables, the reference's ``_walk_core`` with its vmap written out as the
    leading axis: ``graph_idx``, ``start``, ``executed`` ``(A,)``, ``keys``
    ``(A, 2)`` threefry keys.  Absorbing state is U.

    ``ov_samples (A, U, So)`` / ``ov_counts (A, U)`` (or ``None``) carry
    online-refinement overrides: a unit with a positive count draws from
    its override row.  ``po_cum (A, U, U+1)`` / ``po_scale (A, U)`` switch
    on posterior sampling: transitions draw against the blended CDF and
    every service draw is scaled by the unit's ratio.  With
    ``track_arrivals`` the walk also records each walker's cumulative
    service at its first entry into each unit (``ARRIVAL_NEVER`` where
    never entered) and returns ``(total (A, W), arrivals (A, W, U))``; the
    totals are the same either way.

    Each step draws ``(2, W)`` uniforms from the step's split key: demand
    index ``floor(r * n)``, transition ``sum(r2 > cdf)``, in the
    reference's float order (eager PyTorch contracts no multiply-add).
    Walkers that absorbed add nothing and never move, so the loop stops
    once every walker has absorbed, with the same result."""
    A = int(graph_idx.shape[0])
    G, U, S = samples.shape
    W = n_walkers
    dev = samples.device
    gi = graph_idx.to(dev, torch.int64)
    apps = torch.arange(A, device=dev) * U
    samp = samples.reshape(G * U, S)
    cnt = counts.reshape(G * U)
    base = (gi * U)[:, None]
    if po_cum is None:
        cdf_rows, cdf_base = cum_trans.reshape(G * U, U + 1), base
    else:
        cdf_rows, cdf_base = po_cum.reshape(A * U, U + 1), apps[:, None]
    with_ov = ov_counts is not None
    if with_ov:
        So = ov_samples.shape[2]
        ovs = ov_samples.reshape(A * U, So)
        ovc = ov_counts.reshape(A * U)
    u = torch.empty((A, max_steps, 2, W), dtype=torch.float32, device=dev)
    step = max(1, _STREAM_CHUNK // max(1, max_steps * 2 * W))
    for a0 in range(0, A, step):
        u[a0:a0 + step] = threefry.walk_uniforms(keys[a0:a0 + step],
                                                 max_steps, W)
    cur = start.to(dev, torch.int64)[:, None].expand(A, W).contiguous()
    ex = executed.to(dev, torch.float32)[:, None]
    total = torch.zeros((A, W), dtype=torch.float32, device=dev)
    done = torch.zeros((A, W), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    arr = (torch.full((A, W, U), ARRIVAL_NEVER, dtype=torch.float32,
                      device=dev) if track_arrivals else None)
    unit_ids = torch.arange(U, device=dev)
    for t in range(max_steps):
        r, r2 = u[:, t, 0], u[:, t, 1]
        row = base + cur
        n_eff = cnt[row]
        if with_ov:
            orow = apps[:, None] + cur
            oc = ovc[orow]
            has = oc > 0
            n_eff = torch.where(has, oc, n_eff)
        sidx = torch.floor(r * n_eff.to(torch.float32)).to(torch.int64)
        svc = samp[row, torch.clamp(sidx, 0, S - 1)]
        if with_ov:
            svc = torch.where(has, ovs[orow, torch.clamp(sidx, 0, So - 1)],
                              svc)
        if po_scale is not None:
            svc = svc * po_scale.reshape(A * U)[apps[:, None] + cur]
        if t == 0:
            svc = torch.clamp_min(svc - ex, 0.0)
        total = total + torch.where(done, zero, svc)
        nxt = (r2[..., None] > cdf_rows[cdf_base + cur]).sum(-1)
        nxt = torch.clamp_max(nxt, U)
        new_done = done | (nxt >= U)
        if track_arrivals:
            enter = (~done) & (nxt < U)
            onehot = enter[..., None] & (nxt[..., None] == unit_ids)
            arr = torch.where(onehot, torch.minimum(arr, total[..., None]),
                              arr)
        cur = torch.where(new_done, cur, nxt)
        done = new_done
        if t % 8 == 7 and bool(done.all()):
            break
    return (total, arr) if track_arrivals else total


def _mc_walk(samples: torch.Tensor, counts: torch.Tensor,
             cum_trans: torch.Tensor, start: int, executed: float,
             key: torch.Tensor, n_walkers: int, max_steps: int
             ) -> torch.Tensor:
    """One application's walk: ``(U, S)`` demand samples, ``(U, U+1)``
    cumulative transitions, absorbing state U.  Returns ``(n_walkers,)``
    remaining service times."""
    dev = samples.device
    return _walk_core(samples[None], counts[None], cum_trans[None],
                      torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.tensor([int(start)], device=dev),
                      torch.tensor([executed], dtype=torch.float32,
                                   device=dev),
                      key.reshape(1, 2), None, None, n_walkers,
                      max_steps)[0]


def _mc_walk_batch(samples, counts, cum_trans, graph_idx, start, executed,
                   base_key, key_ids, refresh_ids, ov_samples, ov_counts,
                   n_walkers: int, max_steps: int,
                   track_arrivals: bool = False, po_cum=None, po_scale=None):
    """The whole queue's walks, keyed per app by ``fold_in(fold_in(base_key,
    key_id), refresh_id)`` — the chain the looped path derives, so both
    give the same bits.  With ``track_arrivals`` returns ``(totals (A, W),
    arrivals (A, W, U))``; ``po_cum``/``po_scale`` switch on posterior
    sampling (see :func:`_walk_core`)."""
    dev = samples.device
    base_key = base_key.to(dev)
    keys = threefry.fold_in(threefry.fold_in(base_key, key_ids.to(dev)),
                            refresh_ids.to(dev))
    return _walk_core(samples, counts, cum_trans, graph_idx, start, executed,
                      keys, ov_samples, ov_counts, n_walkers, max_steps,
                      track_arrivals=track_arrivals, po_cum=po_cum,
                      po_scale=po_scale)


def mc_service_samples_batch(
        packed: PackedKB, base_key: torch.Tensor, *,
        graph_idx: np.ndarray, start: np.ndarray, executed: np.ndarray,
        key_ids: np.ndarray, refresh_ids: np.ndarray,
        overrides: Optional[Sequence[Optional[Dict[str, np.ndarray]]]] = None,
        n_walkers: int = 512, max_steps: int = 64) -> np.ndarray:
    """Remaining-service samples ``(A, n_walkers)`` for A applications in
    one batched walk on the packed tables' device.

    ``overrides[a]`` maps unit name -> conditional sample array (the online
    refinement hook).  As in the reference, override rows are cut to the
    power of two at or above the longest override (at most S) and the batch
    is padded to a power of two."""
    A = len(graph_idx)
    if A == 0:
        return np.zeros((0, n_walkers), np.float32)
    U, S = packed.n_units, packed.n_samples
    So = 1
    if overrides:
        for ov in overrides:
            for arr in (ov or {}).values():
                So = max(So, min(len(arr), S))
        So = min(_pow2_ceil(So), S) if So > 1 else 1
    Ap = _pow2_ceil(A)
    gi = np.zeros((Ap,), np.int64)
    st = np.zeros((Ap,), np.int64)
    ex = np.zeros((Ap,), np.float32)
    kid = np.zeros((Ap,), np.int64)
    rid = np.zeros((Ap,), np.int64)
    gi[:A] = np.asarray(graph_idx, np.int64)
    st[:A] = np.asarray(start, np.int64)
    st[A:] = packed.entry[0]
    ex[:A] = np.asarray(executed, np.float32)
    kid[:A] = np.asarray(key_ids, np.int64)
    rid[:A] = np.asarray(refresh_ids, np.int64)
    ovs = np.zeros((Ap, U, So), np.float32)
    ovc = np.zeros((Ap, U), np.int32)
    if overrides:
        for a, ov in enumerate(overrides):
            if not ov:
                continue
            uidx = packed.unit_index[int(gi[a])]
            for name, arr in ov.items():
                if name not in uidx:
                    continue
                arr = np.asarray(arr, np.float32)[:So]
                if len(arr) == 0:
                    continue
                i = uidx[name]
                ovs[a, i, :len(arr)] = arr
                ovc[a, i] = len(arr)
    t = lambda a: torch.as_tensor(a, device=packed.device)  # noqa: E731
    out = _mc_walk_batch(packed.samples, packed.counts, packed.cum_trans,
                         t(gi), t(st), t(ex), base_key, t(kid), t(rid),
                         t(ovs), t(ovc), n_walkers, max_steps)
    return out[:A].cpu().numpy()
