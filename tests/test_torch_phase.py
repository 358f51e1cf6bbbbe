"""The module that holds the per-phase walk kernel: the port's
``pdgraph_walk`` (the walk alone, compacted between phases) against the
JAX package's, through the reference's CPU twin (``impl="ref"``) and its
TPU kernel in Pallas interpret mode (``impl="pallas", interpret=True``).

Totals, first-arrival times and the spill count must be the same bits
across overrides, the step-0 ``executed`` offset, padding rows, single- and
multi-stage schedules, stages that switch themselves off, a walk whose
compaction spills, a walker count that is not a power of two, and
posterior walk tables.
"""
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.apps.suite import T_IN, T_OUT, build_knowledge_base
from repro.core.pdgraph import BackendSpec, PDGraph, UnitNode, pack_graphs
from repro.kernels.pdgraph_walk import ops as jops
from repro_torch.core import pdgraph as tp
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.pdgraph_walk import ops as tops
from repro_torch.kernels.pdgraph_walk import ref as tref

STEPS = 24


def _both_packs(kb):
    tkb = {n: tp.PDGraph.from_json(g.to_json()) for n, g in kb.items()}
    return (pack_graphs(kb, T_IN, T_OUT),
            tp.pack_graphs(tkb, T_IN, T_OUT, device="cpu"))


@pytest.fixture(scope="module")
def packs():
    return _both_packs(build_knowledge_base(n_trials=40, seed=3))


@pytest.fixture(scope="module")
def loopy():
    """One unit that loops back with probability 0.97: most walkers are
    still alive at every compaction stage, so a tight stage spills."""
    u = UnitNode(name="loop", backend=BackendSpec(kind="dnn", model="t"),
                 duration=[1.0, 2.0, 3.5],
                 next_counts={"loop": 97, "$end": 3})
    return _both_packs({"loopy": PDGraph("loopy", "loop", {"loop": u})})


def _queue(jp, A, seed, *, overrides=False, padding=False, posterior=False):
    rng = np.random.default_rng(seed)
    G, U, _ = jp.samples.shape
    gi = rng.integers(0, G, A).astype(np.int32)
    start = np.where(rng.random(A) < 0.7, np.asarray(jp.entry)[gi],
                     rng.integers(0, U, A)).astype(np.int32)
    q = dict(graph_idx=gi, start=start,
             executed=rng.uniform(0.0, 0.8, A).astype(np.float32),
             key_ids=np.arange(A), refresh_ids=rng.integers(0, 4, A))
    if padding:
        q["valid"] = rng.random(A) < 0.7
    if overrides:
        So = 8
        ovs = np.zeros((A, U, So), np.float32)
        ovc = np.zeros((A, U), np.int32)
        for a in range(0, A, 2):
            u, n = int(rng.integers(0, U)), int(rng.integers(1, So + 1))
            ovc[a, u] = n
            ovs[a, u, :n] = rng.uniform(0.1, 8.0, n)
        q.update(ov_samples=ovs, ov_counts=ovc)
    if posterior:
        alpha = rng.gamma(0.7, 1.0, (A, U, U + 1)).astype(np.float32)
        p = alpha / alpha.sum(-1, keepdims=True)
        q["po_cum"] = np.cumsum(p, -1, dtype=np.float32)
        q["po_scale"] = np.where(rng.random((A, U)) < 0.5, 1.0,
                                 rng.uniform(0.3, 3.0, (A, U))
                                 ).astype(np.float32)
    return q


_OPTIONAL = ("ov_samples", "ov_counts", "valid", "po_cum", "po_scale")


def _jax(jp, q, impl, **kw):
    streams = jops.walker_streams(np.uint32(7), q["key_ids"],
                                  q["refresh_ids"])
    opt = {k: jnp.asarray(q[k]) for k in _OPTIONAL if k in q}
    fn = partial(jops.pdgraph_walk, impl=impl,
                 interpret=True if impl == "pallas" else None, **kw)
    out = jax.jit(fn)(jp.samples, jp.counts, jp.cum_trans,
                      jnp.asarray(q["graph_idx"]), jnp.asarray(q["start"]),
                      jnp.asarray(q["executed"]), streams, **opt)
    return [np.asarray(o) for o in out]


def _torch(tpk, q, **kw):
    t = torch.as_tensor
    opt = {k: t(q[k]) for k in _OPTIONAL if k in q}
    out = tops.pdgraph_walk(
        tpk.samples, tpk.counts, tpk.cum_trans, t(q["graph_idx"]),
        t(q["start"]), t(q["executed"]),
        tref.walker_streams(7, q["key_ids"], q["refresh_ids"]), **opt, **kw)
    return [o.numpy() for o in out]


def _assert_same(j, t):
    assert len(j) == len(t)
    names = ("total", "spill") if len(j) == 2 else ("total", "arrivals",
                                                     "spill")
    for name, a, b in zip(names, j, t):
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)


CASES = {
    # name: (queue options, walk options)
    "single": (dict(), dict(n_walkers=32, compact_after=4,
                            compact_shrink=2)),
    "overrides": (dict(overrides=True), dict(n_walkers=32, compact_after=6,
                                             compact_shrink=2)),
    "padding": (dict(padding=True, overrides=True),
                dict(n_walkers=32, compact_after=4, compact_shrink=2)),
    "multi": (dict(overrides=True),
              dict(n_walkers=64, compact_schedule=((4, 2), (10, 4)))),
    "self_disabling": (dict(), dict(
        n_walkers=32, compact_schedule=((30, 4), (8, 2), (10, 2), (12, 64)))),
    "no_compaction": (dict(), dict(n_walkers=32, compact_after=0)),
    "odd_w": (dict(overrides=True, padding=True),
              dict(n_walkers=48, compact_after=5, compact_shrink=2)),
}


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("track", [False, True], ids=["noarr", "arrivals"])
@pytest.mark.parametrize("case", list(CASES))
def test_walk_matches_reference_bitwise(packs, case, track, impl):
    jp, tpk = packs
    qopt, kw = CASES[case]
    q = _queue(jp, 8, seed=len(case), **qopt)
    kw = dict(kw, max_steps=STEPS, track_arrivals=track)
    _assert_same(_jax(jp, q, impl, **kw), _torch(tpk, q, **kw))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_spilling_walk_matches_reference(loopy, impl):
    """A stage too tight for the survivors spills: the spilled walkers
    keep their partial totals and ``spill`` counts them, as in the
    reference."""
    jp, tpk = loopy
    q = _queue(jp, 16, seed=4, padding=True)
    kw = dict(n_walkers=32, max_steps=STEPS,
              compact_schedule=((2, 2), (6, 4)), track_arrivals=True)
    j = _jax(jp, q, impl, **kw)
    t = _torch(tpk, q, **kw)
    assert int(t[2]) > 0
    _assert_same(j, t)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_posterior_walk_matches_reference(packs, impl):
    """Posterior walk tables (per-app CDF rows and demand scales): the CPU
    version compacts as the reference's twin does; the reference's kernel
    path walks single-phase, which gives the same bits while nothing
    spills."""
    jp, tpk = packs
    q = _queue(jp, 8, seed=21, overrides=True, padding=True, posterior=True)
    kw = dict(n_walkers=32, max_steps=STEPS, compact_after=4,
              compact_shrink=2, track_arrivals=True)
    j = _jax(jp, q, impl, **kw)
    t = _torch(tpk, q, **kw)
    assert int(t[2]) == 0
    _assert_same(j, t)
    # the tables change the walk: prior tables give other totals
    base = _torch(tpk, {k: v for k, v in q.items()
                        if k not in ("po_cum", "po_scale")}, **kw)
    assert not np.array_equal(base[0], t[0])


def test_cpu_walk_launches_nothing(packs):
    jp, tpk = packs
    before = dict(LAUNCHES)
    _torch(tpk, _queue(jp, 4, seed=1), n_walkers=32, max_steps=8)
    assert LAUNCHES == before


def test_walk_schedule_matches():
    for after in (0, -1, 4, 12, 16, 20):
        for shrink in (0, 1, 2, 4, 8):
            for n in (128, 4096, 16383, 16384, 1 << 20):
                assert tops.walk_schedule(after, shrink, n) == \
                    jops.walk_schedule(after, shrink, n), (after, shrink, n)
