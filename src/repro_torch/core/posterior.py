"""Online PDGraph learning: conjugate posterior over branch mix + unit demand.

PyTorch counterpart of ``repro.core.posterior``.

Branch probabilities — Dirichlet.  Each unit's next-unit distribution
(``$end`` at index ``U``) gets pseudo-counts ``tau_b * p_prior``; observed
branch outcomes are plain counts, so the posterior mean is
``(tau_b * p_prior + counts) / (tau_b + n_obs)`` and the walk's transition
CDF is its cumulative sum.  A unit with no observations keeps the prior CDF
row bit for bit.

Per-unit demand — Gamma on the service rate.  The walk keeps drawing from
the prior's sample list and rescales every draw by the posterior-to-prior
mean ratio ``(tau_d * mean + S) / ((tau_d + n) * mean)``, exactly ``1.0``
with no observations.

Sufficient statistics live as device rows on the slot arena
(``QueueState.post``, ``(cap, U, U + 3)``): ``[..., :U+1]`` branch counts,
``[..., U+1]`` observed service seconds, ``[..., U+2]`` observation count.
The scheduler folds observations on the host per graph (``PosteriorState``)
and writes each walked slot's row right before its walk.

Bits.  The reference builds the tables inside its jitted delta tick, and
XLA on the CPU contracts ``tau_b * p_prior + counts`` and
``tau_d * mean + S`` into fused multiply-adds there; both are spelled out
with :func:`repro_torch.core.gittins.fma32`, and sums run in XLA's order
(:func:`repro_torch.core.gittins.row_sum`, :func:`_cumsum_last`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from repro_torch.core.gittins import f32, fma32, row_sum

END = "$end"


@dataclass(frozen=True)
class PosteriorConfig:
    """Knobs for the online conjugate refinement.

    branch_strength
        Dirichlet pseudo-count mass ``tau_b`` put on the frozen prior's
        branch mix.  Smaller adapts faster, larger trusts the profile longer.
    demand_strength
        Gamma pseudo-observation count ``tau_d`` behind the frozen prior's
        mean demand per unit.
    """
    branch_strength: float = 8.0
    demand_strength: float = 8.0

    def __post_init__(self):
        if not self.branch_strength > 0.0:
            raise ValueError("branch_strength must be > 0, "
                             f"got {self.branch_strength}")
        if not self.demand_strength > 0.0:
            raise ValueError("demand_strength must be > 0, "
                             f"got {self.demand_strength}")


# width of one posterior row beyond the (U+1) branch-count lanes
STAT_COLS = 2  # [sum of observed service seconds, observation count]


def row_width(n_units: int) -> int:
    """Posterior row width for a KB padded to ``n_units`` units."""
    return n_units + 1 + STAT_COLS


def _cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis in float32, left to right (as XLA
    evaluates ``jnp.cumsum`` on the CPU; ``torch.cumsum`` on the CPU
    accumulates in float64 and rounds differently)."""
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, dim=-1)


def prior_mean(samples: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Per-(graph, unit) mean of the prior's demand samples, ``(G, U)``:
    the zero-padded sample row's sum over ``counts`` (at least 1)."""
    return row_sum(samples) / torch.clamp(counts.to(torch.float32),
                                            min=1.0)


def posterior_tables(post_rows: torch.Tensor,    # (P, U, U+3) float32
                     prior_cum: torch.Tensor,    # (P, U, U+1) float32
                     prior_mean: torch.Tensor,   # (P, U)      float32
                     *, branch_strength: float, demand_strength: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend posterior rows with the frozen prior into walk tables.

    Returns ``(po_cum (P, U, U+1), po_scale (P, U))``: the per-row
    transition CDF the walk uses in place of ``cum_trans[graph]`` and the
    per-(row, unit) demand scale multiplied into every sampled service.
    Zero-observation units give the prior CDF row and a literal ``1.0``."""
    U1 = prior_cum.shape[-1]
    bcnt = post_rows[..., :U1]                              # (P, U, U+1)
    dsum = post_rows[..., U1]                               # (P, U)
    dcnt = post_rows[..., U1 + 1]                           # (P, U)

    # Dirichlet: alpha = tau_b * p_prior + counts, prior probabilities by
    # first difference of the CDF
    p_prior = torch.cat([prior_cum[..., :1],
                         prior_cum[..., 1:] - prior_cum[..., :-1]], dim=-1)
    alpha = fma32(f32(branch_strength, prior_cum).expand_as(p_prior),
                  p_prior, bcnt)
    tot = row_sum(alpha)[..., None]
    cdf = _cumsum_last(alpha / torch.clamp(tot, min=float(np.float32(1e-30))))
    has_b = row_sum(bcnt) > 0.0                           # (P, U)
    po_cum = torch.where(has_b[..., None], cdf, prior_cum)

    # Gamma: posterior-predictive-mean / prior-mean ratio per unit
    tau = f32(demand_strength, prior_mean)
    num = fma32(tau.expand_as(prior_mean), prior_mean, dsum)
    den = (tau + dcnt) * prior_mean
    has_d = (dcnt > 0.0) & (prior_mean > 0.0)
    po_scale = torch.where(
        has_d, num / torch.clamp(den, min=float(np.float32(1e-30))),
        f32(1.0, prior_mean))
    return po_cum, po_scale


# --------------------------------------------------------------------------
# host-side accumulation (the scheduler's per-graph sufficient statistics)
# --------------------------------------------------------------------------

# one buffered observation: (app_name, unit, kind, value)
#   kind "branch": value is the next unit name (END for terminal)
#   kind "demand": value is the observed service seconds (float)
Observation = Tuple[str, str, str, object]


class PosteriorState:
    """Per-graph conjugate sufficient statistics, keyed by unit *names*.

    Name-keyed so the statistics survive knowledge-base repacks and queue
    rebuilds.  ``fold`` sorts each batch into a canonical order before
    accumulating, so any permutation of one observation batch gives the
    same bits."""

    def __init__(self):
        self.branch: Dict[str, Dict[str, Dict[str, float]]] = {}
        self.dsum: Dict[str, Dict[str, float]] = {}
        self.dcnt: Dict[str, Dict[str, float]] = {}

    def fold(self, batch: Iterable[Observation]) -> List[str]:
        """Accumulate one observation batch; returns touched graph names."""
        touched = []
        for name, unit, kind, value in sorted(
                batch, key=lambda o: (o[0], o[1], o[2], str(o[3]))):
            if kind == "branch":
                row = self.branch.setdefault(name, {}).setdefault(unit, {})
                row[str(value)] = row.get(str(value), 0.0) + 1.0
            else:
                d = self.dsum.setdefault(name, {})
                d[unit] = np.float32(d.get(unit, np.float32(0.0))
                                     + np.float32(value))
                c = self.dcnt.setdefault(name, {})
                c[unit] = c.get(unit, 0.0) + 1.0
            if name not in touched:
                touched.append(name)
        return touched

    def graph_row(self, name: str, unit_order: List[str],
                  n_units: int) -> np.ndarray:
        """One graph's stats as a ``(U, U+3)`` float32 row block under the
        current packed unit order (index ``n_units`` = $end)."""
        out = np.zeros((n_units, row_width(n_units)), np.float32)
        idx = {u: i for i, u in enumerate(unit_order)}
        for unit, row in self.branch.get(name, {}).items():
            ui = idx.get(unit)
            if ui is None:
                continue
            for nxt, cnt in row.items():
                j = n_units if nxt == END else idx.get(nxt)
                if j is not None:
                    out[ui, j] = np.float32(cnt)
        for unit, s in self.dsum.get(name, {}).items():
            ui = idx.get(unit)
            if ui is not None:
                out[ui, n_units + 1] = np.float32(s)
        for unit, c in self.dcnt.get(name, {}).items():
            ui = idx.get(unit)
            if ui is not None:
                out[ui, n_units + 2] = np.float32(c)
        return out

    def n_observations(self) -> float:
        tot = sum(c for per in self.dcnt.values() for c in per.values())
        tot += sum(c for per in self.branch.values()
                   for row in per.values() for c in row.values())
        return tot
