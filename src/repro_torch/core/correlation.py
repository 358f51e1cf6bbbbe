"""Pearson-correlation analysis + conditional refinement (§3.2).

The paper identifies three cross-unit correlation patterns (downstream input
length vs upstream input/output; output vs own input + upstream output;
parallelism vs upstream parallelism), keeps the ones with |ρ| > 0.5 as a mask,
and at runtime *joins* the historical trials of the two units, filters on the
observed upstream buckets, and resamples the downstream demand from the
filtered records.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pdgraph import N_BUCKETS, PDGraph

RHO_THRESHOLD = 0.5
MIN_FILTERED = 5

# (downstream var, upstream var) pairs considered, per the paper's three
# patterns.  "own_in" refers to the downstream unit's own input length.
PATTERNS: Tuple[Tuple[str, str], ...] = (
    ("in", "up_in"), ("in", "up_out"),
    ("out", "own_in"), ("out", "up_out"),
    ("par", "up_par"),
)


def _bucketize(x: np.ndarray, n: int = N_BUCKETS) -> np.ndarray:
    lo, hi = x.min(), x.max()
    if hi <= lo:
        return np.zeros(len(x), np.int64)
    edges = np.linspace(lo, hi, n + 1)
    return np.clip(np.digitize(x, edges[1:-1]), 0, n - 1)


def pearson(x: Sequence[float], y: Sequence[float]) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(x) < 3 or x.std() < 1e-12 or y.std() < 1e-12:
        return 0.0
    # bucketized correlation, as in the paper (Fig. 6)
    bx = _bucketize(x).astype(np.float64)
    by = _bucketize(y).astype(np.float64)
    if bx.std() < 1e-12 or by.std() < 1e-12:
        return 0.0
    return float(np.corrcoef(bx, by)[0, 1])


def _joined(graph: PDGraph, up: str, down: str
            ) -> Tuple[np.ndarray, ...]:
    """Join trials containing both units: arrays (up_in, up_out, up_par,
    d_in, d_out, d_par, d_dur)."""
    rows = [t for t in graph.trials if up in t and down in t]
    get = lambda key, unit: np.asarray([t[unit].get(key, 0.0) for t in rows])
    return (get("in", up), get("out", up), get("par", up),
            get("in", down), get("out", down), get("par", down),
            get("dur", down))


def _candidate_pairs(graph: PDGraph) -> List[Tuple[str, str]]:
    """Ordered (upstream, downstream) unit pairs within 2 hops of each other
    (e.g. KBQAV's generate-queries -> verify across the search unit)."""
    pairs = set()
    for up_name, up in graph.units.items():
        for mid in up.next_probs():
            if mid == "$end":
                continue
            pairs.add((up_name, mid))
            for down in graph.units[mid].next_probs():
                if down not in ("$end", up_name):
                    pairs.add((up_name, down))
    return sorted(pairs)


def correlation_masks(graph: PDGraph) -> Dict[Tuple[str, str], Dict[str, float]]:
    """For co-occurring unit pairs (<=2 hops), the ρ of each pattern; masks
    are |ρ| > 0.5 (the paper's threshold)."""
    out: Dict[Tuple[str, str], Dict[str, float]] = {}
    for up_name, down_name in _candidate_pairs(graph):
            ui, uo, up_, di, do, dp, dd = _joined(graph, up_name, down_name)
            if len(ui) < 3:
                continue
            rho = {
                "in~up_in": pearson(di, ui),
                "in~up_out": pearson(di, uo),
                "out~own_in": pearson(do, di),
                "out~up_out": pearson(do, uo),
                "par~up_par": pearson(dp, up_),
                "dur~up_out": pearson(dd, uo),
            }
            out[(up_name, down_name)] = rho
    return out


def apply_masks(graph: PDGraph) -> None:
    """Store the boolean five-tuple masks on each downstream unit."""
    for (up, down), rho in correlation_masks(graph).items():
        node = graph.units[down]
        for k, v in rho.items():
            node.corr_mask[f"{up}|{k}"] = bool(abs(v) > RHO_THRESHOLD)


def observed_service(observed: Dict[str, float],
                     t_in: float, t_out: float) -> float:
    """Model-space service seconds of one observed unit execution — the
    ``trajectory_service`` formula applied to a single observation dict
    (explicit ``dur`` wins; else parallelism x token-linear cost).  Shared by
    the §3.2 conditional refinement's consumers and the posterior demand
    feed, so the two observation paths can never disagree on what "observed
    service" means."""
    dur = observed.get("dur")
    if dur is not None:
        return float(dur)
    return float(observed.get("par", 1.0)
                 * (observed.get("in", 0.0) * t_in
                    + observed.get("out", 0.0) * t_out))


def conditional_samples(graph: PDGraph, up: str, down: str,
                        observed: Dict[str, float],
                        t_in: float, t_out: float) -> Optional[np.ndarray]:
    """Refined service-demand samples for `down`, conditioned on the observed
    execution of `up` (bucket-join + filter).  None -> no usable refinement."""
    node = graph.units[down]
    masks = {k.split("|", 1)[1]: v for k, v in node.corr_mask.items()
             if k.startswith(up + "|") and v}
    if not masks:
        return None
    ui, uo, up_, di, do, dp, dd = _joined(graph, up, down)
    if len(ui) < MIN_FILTERED:
        return None
    keep = np.ones(len(ui), bool)
    for pat in masks:
        _, upstream_var = pat.split("~")
        obs_key = {"up_in": "in", "up_out": "out", "up_par": "par"}.get(upstream_var)
        if obs_key is None or obs_key not in observed:
            continue
        col = {"up_in": ui, "up_out": uo, "up_par": up_}[upstream_var]
        b = _bucketize(col)
        lo, hi = col.min(), col.max()
        if hi <= lo:
            continue
        edges = np.linspace(lo, hi, N_BUCKETS + 1)
        ob = int(np.clip(np.digitize([observed[obs_key]], edges[1:-1])[0],
                         0, N_BUCKETS - 1))
        keep &= (b == ob)
    if keep.sum() < MIN_FILTERED:
        return None
    if node.backend.kind == "llm":
        svc = dp[keep] * (di[keep] * t_in + do[keep] * t_out)
    else:
        svc = dd[keep]
    return svc.astype(np.float32)
