"""The port's slot arena and delta refresh tick against the JAX package.

Both packages run the same churned arena one tick at a time — admit,
retire, unit transitions (dirty), progress, refinement overrides, repack —
and after every tick the arena-wide ranks, the persisted demand and arrival
histogram rows and the prewarm trigger/reach mirrors must be the same bits.
The port runs on the CPU (its plain versions); JAX on the CPU.
"""
import numpy as np
import pytest

import jax
import torch

from repro.apps.suite import T_IN, T_OUT, build_knowledge_base
from repro.core import arena as j_arena
from repro.core import refresh_pipeline as j_pipe
from repro.core.hermeslet import warmup_time_for
from repro.core.pdgraph import pack_graphs
from repro.core.prewarm import build_prewarm_table
from repro_torch.core import arena as t_arena
from repro_torch.core import pdgraph as t_pdgraph
from repro_torch.core import prewarm as t_prewarm
from repro_torch.core import refresh_pipeline as t_pipe

W, NB, SEED = 32, 10, 17


@pytest.fixture(scope="module")
def kbs():
    kb = build_knowledge_base(n_trials=40, seed=3)
    jp = pack_graphs(kb, T_IN, T_OUT)
    tkb = {n: t_pdgraph.PDGraph.from_json(g.to_json()) for n, g in kb.items()}
    tp = t_pdgraph.pack_graphs(tkb, T_IN, T_OUT, device="cpu")
    jt = build_prewarm_table(kb, jp, warmup_time_for)
    tt = t_prewarm.build_prewarm_table(tkb, tp, warmup_time_for)
    return jp, tp, jt, tt


class _Pair:
    """The same arena in both packages, driven by one event script."""

    def __init__(self, kbs, capacity=16):
        self.jp, self.tp, self.jt, self.tt = kbs
        self.j = j_arena.QueueState(self.jp, capacity=capacity)
        self.t = t_arena.QueueState(self.tp, capacity=capacity)
        self.n = 0

    def both(self, name, *args):
        a = getattr(self.j, name)(*args)
        b = getattr(self.t, name)(*args)
        return a, b

    def admit(self, rng, k):
        rows = []
        for _ in range(k):
            g = int(rng.integers(0, len(self.jp.names)))
            rows.append((f"app{self.n}", g, int(self.jp.entry[g]), self.n,
                         None))
            self.n += 1
        a, b = self.both("admit_many", rows)
        np.testing.assert_array_equal(a, b)

    def tick(self, walked=None, retrigger=True, j_extra=None, t_extra=None):
        """One delta tick in both; ``j_extra`` / ``t_extra`` are further
        keyword arguments of each package's ``refresh_ranks_delta``."""
        if walked is None:
            walked = self.j.take_dirty()
            np.testing.assert_array_equal(walked, self.t.take_dirty())
        kw = dict(walked=walked, n_walkers=W, n_buckets=NB,
                  prewarm_k=0.5, retrigger=retrigger)
        jt = j_pipe.refresh_ranks_delta(self.jp, self.j,
                                        jax.random.PRNGKey(0), SEED,
                                        prewarm_table=self.jt, **kw,
                                        **(j_extra or {}))
        tt = t_pipe.refresh_ranks_delta(self.tp, self.t, SEED,
                                        prewarm_table=self.tt, **kw,
                                        **(t_extra or {}))
        occ = self.j.occupied()
        np.testing.assert_array_equal(occ, self.t.occupied())
        np.testing.assert_array_equal(jt.ranks[occ], tt.ranks[occ])
        for name in ("d_probs", "d_edges", "a_hist", "a_lo", "a_span",
                     "a_reach"):
            np.testing.assert_array_equal(
                np.asarray(getattr(self.j, name))[occ],
                getattr(self.t, name).numpy()[occ], err_msg=name)
        rows = occ if retrigger else walked
        np.testing.assert_array_equal(self.j.trig[rows], self.t.trig[rows])
        np.testing.assert_array_equal(self.j.reach[rows], self.t.reach[rows])
        self.both("bump_refresh", walked)
        return jt, tt


def _churn(pair, rng):
    live = [pair.j.ids[s] for s in pair.j.occupied()]
    for app in rng.choice(live, len(live) // 4, replace=False):
        pair.both("retire", str(app))
    live = [pair.j.ids[s] for s in pair.j.occupied()]
    for app in rng.choice(live, len(live) // 3, replace=False):
        pair.both("set_unit", str(app), int(rng.integers(0, 4)))
    for app in rng.choice(live, len(live) // 2, replace=False):
        pair.both("add_progress", str(app), float(rng.uniform(0.0, 4.0)))
    for app in rng.choice(live, max(len(live) // 5, 1), replace=False):
        arr = rng.uniform(0.1, 6.0, int(rng.integers(1, 9)))
        pair.both("set_override", str(app), int(rng.integers(0, 4)), arr)


def test_delta_ticks_over_churned_arena(kbs):
    rng = np.random.default_rng(5)
    pair = _Pair(kbs)
    pair.admit(rng, 12)
    pair.tick()                                   # every slot walked
    for t in range(6):
        _churn(pair, rng)
        pair.admit(rng, int(rng.integers(2, 9)))  # grows past 16 slots
        pair.tick()
        if t == 2:
            pair.tick()                           # empty dirty set
    assert pair.j.capacity == pair.t.capacity > 16


def test_event_path_subset_and_repack(kbs):
    rng = np.random.default_rng(9)
    pair = _Pair(kbs, capacity=64)
    pair.admit(rng, 40)
    pair.tick()
    _churn(pair, rng)
    # event path: walk only part of the dirty set, walk-time triggers
    dirty = sorted(pair.j.dirty)
    sub = np.asarray(dirty[: len(dirty) // 2], np.int64)
    pair.both("clear_dirty", sub)
    pair.tick(walked=sub, retrigger=False)
    live = [pair.j.ids[s] for s in pair.j.occupied()]
    for app in live[:30]:
        pair.both("retire", app)
    a, b = pair.both("maybe_repack", 0.25, 8)
    assert a == b and a is not None
    pair.tick()


def test_fused_refresh_matches(kbs):
    """The first-tick path: one fused refresh over every occupied slot;
    the kernel's own ranks are the ranks here."""
    rng = np.random.default_rng(2)
    pair = _Pair(kbs)
    pair.admit(rng, 10)
    for app in ("app1", "app4"):
        pair.both("add_progress", app, 1.5)
    kw = dict(n_walkers=W, n_buckets=NB, prewarm_k=0.5)
    j = j_pipe.refresh_ranks_fused(pair.jp, pair.j, jax.random.PRNGKey(0),
                                   SEED, prewarm_table=pair.jt, **kw)
    t = t_pipe.refresh_ranks_fused(pair.tp, pair.t, SEED,
                                   prewarm_table=pair.tt, **kw)
    for k in ("ranks", "probs", "edges", "trigger", "reach"):
        np.testing.assert_array_equal(getattr(j, k), getattr(t, k),
                                      err_msg=k)


def test_triage_scalars_match(kbs):
    """Composite policies read the (P90, P10, mean) triage scalars of the
    raw totals; ranks stay in the arena as for plain Gittins."""
    rng = np.random.default_rng(3)
    pair = _Pair(kbs)
    pair.admit(rng, 9)
    walked = pair.j.take_dirty()
    pair.t.take_dirty()
    kw = dict(walked=walked, n_walkers=W, n_buckets=NB, with_triage=True)
    j_pipe.refresh_ranks_delta(pair.jp, pair.j, jax.random.PRNGKey(0), SEED,
                               **kw)
    t_pipe.refresh_ranks_delta(pair.tp, pair.t, SEED, **kw)
    for k in ("sup", "opt", "mean"):
        np.testing.assert_array_equal(getattr(pair.t, k)[walked],
                                      getattr(pair.j, k)[walked], err_msg=k)
    assert isinstance(pair.t.d_probs, torch.Tensor)


@pytest.mark.parametrize("retrigger", [True, False])
def test_composed_delta_ticks_match(kbs, retrigger):
    """``rank_in_kernel=False``: the per-phase walk composed with the
    reductions, against the reference's composition, over a churned
    arena; full ticks and event-path subset ticks."""
    rng = np.random.default_rng(21 + retrigger)
    pair = _Pair(kbs)
    extra = dict(rank_in_kernel=False)
    pair.admit(rng, 14)
    pair.tick(j_extra=extra, t_extra=extra)
    for _ in range(3):
        _churn(pair, rng)
        pair.admit(rng, int(rng.integers(2, 9)))
        walked = pair.j.take_dirty()
        np.testing.assert_array_equal(walked, pair.t.take_dirty())
        jt, tt = pair.tick(walked=walked, retrigger=retrigger,
                           j_extra=extra, t_extra=extra)
        assert jt.spill == tt.spill


def test_composed_fused_refresh_matches(kbs):
    """The first-tick path composed from the per-phase walk (triage on),
    against the reference's composition and against the port's own fused
    walk: the same bits."""
    rng = np.random.default_rng(6)
    pair = _Pair(kbs)
    pair.admit(rng, 10)
    for app in ("app2", "app7"):
        pair.both("add_progress", app, 2.5)
    pair.both("set_override", "app3", 1, rng.uniform(0.1, 6.0, 5))
    kw = dict(n_walkers=W, n_buckets=NB, prewarm_k=0.5, with_triage=True,
              rank_in_kernel=False)
    j = j_pipe.refresh_ranks_fused(pair.jp, pair.j, jax.random.PRNGKey(0),
                                   SEED, prewarm_table=pair.jt, **kw)
    t = t_pipe.refresh_ranks_fused(pair.tp, pair.t, SEED,
                                   prewarm_table=pair.tt, **kw)
    f = t_pipe.refresh_ranks_fused(pair.tp, pair.t, SEED,
                                   prewarm_table=pair.tt,
                                   **dict(kw, rank_in_kernel=True))
    for k in ("ranks", "probs", "edges", "trigger", "reach", "sup", "opt",
              "mean"):
        np.testing.assert_array_equal(getattr(j, k), getattr(t, k),
                                      err_msg=k)
        np.testing.assert_array_equal(getattr(f, k), getattr(t, k),
                                      err_msg=k)


@pytest.mark.parametrize("W", [32, 64, 256])
def test_triage_stats_bitwise_across_walker_counts(W):
    """The triage scalars of raw totals at the walker counts the simulator
    uses: XLA sums a row of more than 32 values in windows of 32 (see
    ``gittins.row_sum``), not left to right."""
    x = np.random.default_rng(W).lognormal(2.0, 1.0, (300, W)).astype(
        np.float32)
    j = jax.jit(j_pipe._triage_stats)(x)
    t = t_pipe._triage_stats(torch.as_tensor(x))
    for name, a, b in zip(("sup", "opt", "mean"), j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
