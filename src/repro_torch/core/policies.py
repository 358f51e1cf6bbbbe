"""Queue-management policies (§3.3 + §5 baselines).

Every policy maps application states to scalar ranks — lower rank runs first.
``task_level=True`` marks policies that ignore the application boundary
(vLLM-style request FCFS).

  gittins    Hermes: Gittins index over the PDGraph remaining-demand hist
  srpt_mean  SRPT on the distribution mean (the strawman §3.3 rejects)
  fcfs_req   vLLM: request-level FCFS
  fcfs_app   Parrot: application-level FCFS
  vtc        fair sharing via per-tenant virtual (service) counters
  edf        earliest deadline first
  lstf       Hermes-DDL: least worst-case slack,  S = ddl - now - (supX - a)
  oracle     true remaining service (simulator-provided upper bound)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.gittins import (gittins_rank_hist_np, to_histogram,
                                to_histogram_batch)

# The fused pipeline computes the composite policies' triage quantiles on
# device at THESE fixed probabilities (repro.core.refresh._triage_stats);
# a policy instance re-tuned away from them loses fused eligibility and
# falls back to the host-quantile path (see Policy.fused_capable).
SUP_Q = 0.9           # worst-case demand quantile (eq. 2 "sup X")
HOPELESS_Q = 0.1      # optimistic quantile for the hopeless-class gate


@dataclass
class AppView:
    """What a policy may see about one application.

    In the scheduler's fused refresh mode ``total_samples`` is None — the
    sample matrix never reaches the host; the view instead carries the
    device-computed histogram rows (``hist``) and, until invalidated by
    further progress, the device-computed Gittins rank (``fused_rank``).
    For the composite (deadline) policies it additionally carries the
    device-computed triage scalars: the SUP_Q/HOPELESS_Q quantiles and the
    mean of the TOTAL demand distribution."""
    app_id: str
    tenant: str
    arrival: float
    attained: float                      # service seconds received so far
    total_samples: Optional[np.ndarray]  # est. TOTAL demand distribution
    deadline: Optional[float] = None
    oracle_remaining: Optional[float] = None
    hist: Optional[tuple] = None         # cached (probs, edges)
    fused_rank: Optional[float] = None   # device-computed rank (fused mode)
    demand_sup: Optional[float] = None   # device P_{SUP_Q}(total demand)
    demand_opt: Optional[float] = None   # device P_{HOPELESS_Q}(total demand)
    demand_mean: Optional[float] = None  # device mean(total demand)


class Policy:
    name = "base"
    task_level = False
    needs_deadline = False
    # True when one app's rank depends only on that app's own state (not on
    # other apps, shared counters, or wall time) — hosts may then re-rank
    # just the apps an event touched between full bucket-tick refreshes
    independent_ranks = True
    # True when this policy can consume the fused dispatch's device-computed
    # outputs (ranks / hists / triage scalars) instead of raw sample arrays;
    # the scheduler only engages the fused pipeline for such policies
    fused_capable = False
    # True when ranks read only per-app scheduler bookkeeping (arrival /
    # tenant / deadline) and never the demand estimate: the scheduler skips
    # the MC view refresh entirely for such policies, so ranking 100k live
    # apps costs one vectorized gather instead of a device dispatch
    view_free = False
    # True when an app's rank is fixed at admission (arrival time, deadline)
    # — it can never change afterwards, so a full bucket-tick refresh has
    # nothing to recompute: array-native hosts skip the O(live) re-rank and
    # the waiting-queue rebuild entirely (the values they hold are already
    # final).  Implies the rank is per-app and time-invariant.
    static_ranks = False
    # True when the policy can rank straight off slot-store column gathers
    # (ranks_columns) — the scheduler's delta/mesh consumption then skips
    # minting AppView objects entirely (the last per-app Python loop on the
    # mesh hot path)
    columns_capable = False

    def ranks(self, apps: List[AppView], now: float) -> np.ndarray:
        raise NotImplementedError

    def ranks_columns(self, now: float, *, g: np.ndarray, sup: np.ndarray,
                      opt: np.ndarray, mean: np.ndarray,
                      attained: np.ndarray,
                      deadline: np.ndarray) -> np.ndarray:
        """Vectorized twin of :meth:`ranks` over store columns: ``g`` the
        device Gittins ranks (float32 mirror rows), ``sup``/``opt``/``mean``
        the device triage scalars, ``attained``/``deadline`` the host
        bookkeeping (``np.inf`` = no deadline).  Must return values
        bit-identical to :meth:`ranks` over views of the same scalars."""
        raise NotImplementedError


class GittinsPolicy(Policy):
    name = "gittins"
    fused_capable = True

    def __init__(self, n_buckets: int = 10, vectorized: bool = True):
        self.n_buckets = n_buckets
        self.vectorized = vectorized   # False = seed-style per-app bucketize

    def ranks(self, apps: List[AppView], now: float) -> np.ndarray:
        if not apps:
            return np.zeros(0)
        # fused path: the scheduler already computed every rank on device in
        # the fused refresh dispatch — accept them directly, no host
        # bucketize / rank dispatch at all
        if all(a.fused_rank is not None for a in apps):
            return np.asarray([a.fused_rank for a in apps], np.float32)
        stale = [a for a in apps
                 if a.hist is None or a.hist[0].shape[0] != self.n_buckets]
        if self.vectorized and len(stale) > 1 and \
                len({len(a.total_samples) for a in stale}) == 1:
            # whole-queue bucketization in one vectorized pass
            P, E = to_histogram_batch(
                np.stack([a.total_samples for a in stale]), self.n_buckets)
            for a, p, e in zip(stale, P, E):
                a.hist = (p, e)
        else:
            for a in stale:
                a.hist = to_histogram(a.total_samples, self.n_buckets)
        J = len(apps)
        probs = np.empty((J, self.n_buckets), np.float32)
        edges = np.empty((J, self.n_buckets), np.float32)
        att = np.empty((J,), np.float32)
        for i, a in enumerate(apps):
            probs[i] = a.hist[0]
            edges[i] = a.hist[1]
            att[i] = a.attained
        # gittins_rank_hist_np pads the queue axis to a power of two so
        # churning queue sizes don't trace a fresh jit executable each
        return gittins_rank_hist_np(probs, edges, att)


class SRPTMeanPolicy(Policy):
    name = "srpt_mean"

    def ranks(self, apps, now):
        return np.asarray([float(a.total_samples.mean()) - a.attained
                           for a in apps])


class FCFSAppPolicy(Policy):
    name = "fcfs_app"
    view_free = True
    static_ranks = True          # rank = arrival time, fixed at admission

    def ranks(self, apps, now):
        return np.asarray([a.arrival for a in apps])


class FCFSRequestPolicy(FCFSAppPolicy):
    """Request-level FCFS: the engine orders *tasks* by their own submission
    time; app rank is a tie-breaking fallback."""
    name = "fcfs_req"
    task_level = True


class VTCPolicy(Policy):
    """Virtual-token-counter fairness: serve the least-served tenant first."""
    name = "vtc"
    independent_ranks = False    # rank = shared per-tenant counter
    view_free = True

    def __init__(self):
        self.counters: Dict[str, float] = {}

    def account(self, tenant: str, service: float) -> None:
        self.counters[tenant] = self.counters.get(tenant, 0.0) + service

    def ranks(self, apps, now):
        return np.asarray([self.counters.get(a.tenant, 0.0) for a in apps])


class EDFPolicy(Policy):
    name = "edf"
    needs_deadline = True
    view_free = True
    static_ranks = True          # rank = deadline, fixed at admission

    def ranks(self, apps, now):
        return np.asarray([a.deadline if a.deadline is not None else np.inf
                           for a in apps])


def _demand_stats(apps: List[AppView], sup_q: float, hopeless_q: float
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(P_sup, P_hopeless, mean) of every app's demand samples — read off
    the fused dispatch's device-computed view scalars when present (no
    per-app host quantile pulls on the tick path), one vectorized pass when
    the queue's sample arrays share a length (the batched-refresh common
    case), per-app otherwise."""
    if all(a.total_samples is None for a in apps):
        # fused refresh: the sample matrix never reached the host; the
        # dispatch computed these at (SUP_Q, HOPELESS_Q) — the scheduler
        # guarantees the policy's quantiles match before engaging fused mode
        return (np.asarray([a.demand_sup for a in apps], np.float64),
                np.asarray([a.demand_opt for a in apps], np.float64),
                np.asarray([a.demand_mean for a in apps], np.float64))
    lens = {len(a.total_samples) for a in apps}
    if len(apps) > 1 and len(lens) == 1:
        M = np.stack([a.total_samples for a in apps])
        sup, opt = np.quantile(M, [sup_q, hopeless_q], axis=1)
        return sup, opt, M.mean(axis=1)
    sup = np.asarray([np.quantile(a.total_samples, sup_q) for a in apps])
    opt = np.asarray([np.quantile(a.total_samples, hopeless_q) for a in apps])
    mean = np.asarray([np.mean(a.total_samples) for a in apps])
    return sup, opt, mean


class LSTFPolicy(Policy):
    """Worst-case slack: S = ddl - now - (sup X - a)   (eq. 2).

    Two practical refinements (the paper's "prioritizes the most urgent
    applications while deferring less critical ones"):
    * sup is the P90 of the MC demand samples — the absolute max of a
      random-walk sample set is an outlier magnet and drowns the ordering;
    * applications that cannot meet their deadline even at the *median*
      demand are deferred behind salvageable ones instead of burning
      capacity at the head of the queue (the classic LSTF pathology).
    """
    name = "lstf"
    needs_deadline = True
    independent_ranks = False    # slack is a function of `now`
    sup_q = SUP_Q
    hopeless_q = HOPELESS_Q
    slack_bucket_s = 20.0
    hopeless_penalty = 1e9

    @property
    def fused_capable(self) -> bool:
        # the device triage runs at the module quantiles; a re-tuned
        # instance must keep pulling host quantiles from raw samples
        return (self.sup_q, self.hopeless_q) == (SUP_Q, HOPELESS_Q)

    def ranks(self, apps, now):
        """Triage: (1) hopeless apps (even the optimistic-quantile demand
        misses) go last; (2) the rest order by bucketized worst-case slack;
        (3) within a slack bucket, smallest expected remaining first — equal
        urgency is broken by throughput, which is what lifts DSR when many
        deadlines compete."""
        sup, opt, mean = _demand_stats(apps, self.sup_q, self.hopeless_q)
        out = np.full(len(apps), np.inf)
        for i, a in enumerate(apps):
            if a.deadline is None:
                continue
            mean_rem = max(mean[i] - a.attained, 0.0)
            slack = a.deadline - now - max(sup[i] - a.attained, 0.0)
            bucket = np.floor(slack / self.slack_bucket_s) * self.slack_bucket_s
            rank = bucket * 1e3 + mean_rem
            if a.deadline - now - max(opt[i] - a.attained, 0.0) < 0.0:
                rank += self.hopeless_penalty  # even optimistically missed
            out[i] = rank
        return out

    columns_capable = True

    def ranks_columns(self, now, *, g=None, sup, opt, mean, attained,
                      deadline):
        """Vectorized :meth:`ranks` (``g`` unused — LSTF is pure eq. 2).
        All arithmetic runs in float64, elementwise identical to the
        per-app loop; ``deadline=np.inf`` rows collapse to the loop's
        no-deadline ``np.inf`` rank (inf slack -> inf bucket -> inf rank,
        and the hopeless test can never fire on them)."""
        sup = np.asarray(sup, np.float64)
        opt = np.asarray(opt, np.float64)
        mean = np.asarray(mean, np.float64)
        attained = np.asarray(attained, np.float64)
        deadline = np.asarray(deadline, np.float64)
        mean_rem = np.maximum(mean - attained, 0.0)
        slack = deadline - now - np.maximum(sup - attained, 0.0)
        bucket = np.floor(slack / self.slack_bucket_s) * self.slack_bucket_s
        rank = bucket * 1e3 + mean_rem
        hopeless = (deadline - now - np.maximum(opt - attained, 0.0)) < 0.0
        return np.where(hopeless, rank + self.hopeless_penalty, rank)


class HermesDDLPolicy(Policy):
    """Hermes-DDL: the deadline extension actually shipped (§3.3 + Fig. 11).

    Three-way triage using the PDGraph demand distribution:
      0. *at risk but salvageable* — worst-case (P90) slack below the risk
         window yet optimistically feasible: most urgent, first;
      1. *safe* — comfortable slack: after the at-risk class;
      2. *hopeless* — even the optimistic (P10) demand misses the deadline:
         deferred to the back (don't burn capacity on lost causes).
    Within each class, applications order by Gittins rank, so capacity goes
    to the jobs most likely to finish soon — this demand-awareness is what
    delivers the paper's ~1x DSR gain over EDF (pure eq.-2 LSTF is kept as
    the `lstf` ablation policy).
    """
    name = "hermes_ddl"
    needs_deadline = True
    independent_ranks = False    # triage class is a function of `now`
    sup_q = SUP_Q
    hopeless_q = HOPELESS_Q
    risk_window_s = 30.0
    cls_span = 1e6

    def __init__(self, n_buckets: int = 10):
        self.gittins = GittinsPolicy(n_buckets)

    @property
    def fused_capable(self) -> bool:
        return (self.sup_q, self.hopeless_q) == (SUP_Q, HOPELESS_Q)

    @property
    def vectorized(self) -> bool:
        return self.gittins.vectorized

    @vectorized.setter
    def vectorized(self, value: bool) -> None:
        self.gittins.vectorized = value

    def ranks(self, apps, now):
        g = self.gittins.ranks(apps, now)
        g = np.minimum(g, self.cls_span * 0.99)
        sup, opt, _ = _demand_stats(apps, self.sup_q, self.hopeless_q)
        out = []
        for i, (a, gr) in enumerate(zip(apps, g)):
            if a.deadline is None:
                out.append(self.cls_span + gr)
                continue
            slack_sup = a.deadline - now - max(sup[i] - a.attained, 0.0)
            slack_opt = a.deadline - now - max(opt[i] - a.attained, 0.0)
            if slack_opt < 0.0:
                cls = 2
            elif slack_sup < self.risk_window_s:
                cls = 0
            else:
                cls = 1
            out.append(cls * self.cls_span + gr)
        return np.asarray(out)

    columns_capable = True

    def ranks_columns(self, now, *, g, sup, opt, attained, deadline,
                      mean=None):
        """Vectorized :meth:`ranks` over store columns.  Bit-identical to
        the per-app loop on fused views: the loop's ``cls * cls_span + gr``
        adds a weak Python float to a float32 device rank — NEP-50 performs
        that add in float32 — so this path clips and accumulates in float32
        too.  ``deadline=np.inf`` rows land in the safe class (inf slack),
        whose ``1 * cls_span + g`` equals the loop's explicit no-deadline
        branch."""
        g32 = np.minimum(np.asarray(g, np.float32),
                         np.float32(self.cls_span * 0.99))
        sup = np.asarray(sup, np.float64)
        opt = np.asarray(opt, np.float64)
        attained = np.asarray(attained, np.float64)
        deadline = np.asarray(deadline, np.float64)
        slack_sup = deadline - now - np.maximum(sup - attained, 0.0)
        slack_opt = deadline - now - np.maximum(opt - attained, 0.0)
        cls = np.where(slack_opt < 0.0, 2,
                       np.where(slack_sup < self.risk_window_s, 0, 1))
        return cls.astype(np.float32) * np.float32(self.cls_span) + g32


class OraclePolicy(Policy):
    """SRPT on the *true* remaining demand (ideal upper bound, Fig. 12)."""
    name = "oracle"

    def ranks(self, apps, now):
        return np.asarray([a.oracle_remaining if a.oracle_remaining is not None
                           else float(a.total_samples.mean()) - a.attained
                           for a in apps])


def make_policy(name: str, **kw) -> Policy:
    table = {c.name: c for c in
             (GittinsPolicy, SRPTMeanPolicy, FCFSAppPolicy, FCFSRequestPolicy,
              VTCPolicy, EDFPolicy, LSTFPolicy, HermesDDLPolicy, OraclePolicy)}
    if name not in table:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(table)}")
    return (table[name](**kw) if name in ("gittins", "hermes_ddl")
            else table[name]())
