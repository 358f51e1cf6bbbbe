"""The CPU walk's lossless 16-bit lookup tables (``kernels/pdgraph_walk/
quant.py``) against the JAX package's.

The tables equal the reference's ``build_quant_tables`` bit for bit; the
walks through them (the ranked walk, with arrivals, with posterior tables
in mixed form, and over three compaction stages) equal the walks
without them and the reference's CPU twin with its tables, bit for bit;
overrides take the plain step, as in the reference; and the CPU refresh
reads the tables where the reference's does, with the same ranks.
"""
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.apps.suite import T_IN, T_OUT, build_knowledge_base
from repro.core.pdgraph import pack_graphs
from repro.kernels.pdgraph_walk import ops as jops
from repro.kernels.pdgraph_walk import quant as jquant
from repro_torch.apps.suite import build_knowledge_base as t_kb
from repro_torch.core import pdgraph as tp
from repro_torch.core import refresh_pipeline
from repro_torch.core.refresh_config import RefreshConfig
from repro_torch.core.scheduler import HermesScheduler
from repro_torch.kernels.pdgraph_walk import ops as tops
from repro_torch.kernels.pdgraph_walk import quant
from repro_torch.kernels.pdgraph_walk import ref as tref

NB = 10
KEYS = ("probs", "edges", "ranks", "total", "a_hist", "a_lo", "a_span",
        "a_reach")


@pytest.fixture(scope="module")
def packs():
    kb = build_knowledge_base(n_trials=40, seed=3)
    tkb = {n: tp.PDGraph.from_json(g.to_json()) for n, g in kb.items()}
    return (pack_graphs(kb, T_IN, T_OUT),
            tp.pack_graphs(tkb, T_IN, T_OUT, device="cpu"))


@pytest.fixture(scope="module")
def tables(packs):
    jp, tpk = packs
    return (jquant.build_quant_tables(jp.samples, jp.counts, jp.cum_trans),
            quant.build_quant_tables(tpk.samples, tpk.counts, tpk.cum_trans))


def _queue(jp, A, overrides, posterior, seed):
    rng = np.random.default_rng(seed)
    G, U, _ = jp.samples.shape
    gi = rng.integers(0, G, A).astype(np.int32)
    q = dict(graph_idx=gi,
             start=np.where(rng.random(A) < 0.7, jp.entry[gi],
                            rng.integers(0, U, A)).astype(np.int32),
             executed=rng.uniform(0.0, 0.5, A).astype(np.float32),
             attained=rng.uniform(0.0, 3.0, A).astype(np.float32),
             key_ids=np.arange(A), refresh_ids=rng.integers(0, 4, A),
             valid=np.arange(A) < A - 2)
    if overrides:
        ovs = np.zeros((A, U, 8), np.float32)
        ovc = np.zeros((A, U), np.int32)
        for a in range(0, A, 2):
            u, n = int(rng.integers(0, U)), int(rng.integers(1, 9))
            ovc[a, u] = n
            ovs[a, u, :n] = rng.uniform(0.1, 8.0, n)
        q.update(ov_samples=ovs, ov_counts=ovc)
    if posterior:     # the prior's CDF rows, rescaled demand
        q.update(po_cum=np.asarray(jp.cum_trans)[gi],
                 po_scale=rng.uniform(0.5, 2.0, (A, U)).astype(np.float32))
    return q


_EXTRA = ("ov_samples", "ov_counts", "po_cum", "po_scale")


def _jax_ranked(jp, q, W, jt, track):
    streams = jops.walker_streams(np.uint32(7), q["key_ids"],
                                  q["refresh_ids"])
    extra = {k: jnp.asarray(q[k]) for k in _EXTRA if k in q}
    return jops.pdgraph_walk_ranked(
        jp.samples, jp.counts, jp.cum_trans, jnp.asarray(q["graph_idx"]),
        jnp.asarray(q["start"]), jnp.asarray(q["executed"]), streams,
        jnp.asarray(q["attained"]), **extra, valid=jnp.asarray(q["valid"]),
        n_walkers=W, max_steps=64, n_buckets=NB, with_total=True,
        impl="ref", track_arrivals=track, quant=jt)


def _torch_ranked(tpk, q, W, tt, track):
    t = torch.as_tensor
    extra = {k: t(q[k]) for k in _EXTRA if k in q}
    return tops.pdgraph_walk_ranked(
        tpk.samples, tpk.counts, tpk.cum_trans, t(q["graph_idx"]),
        t(q["start"]), t(q["executed"]),
        tref.walker_streams(7, q["key_ids"], q["refresh_ids"]),
        t(q["attained"]), **extra, valid=t(q["valid"]), n_walkers=W,
        max_steps=64, n_buckets=NB, track_arrivals=track, with_total=True,
        quant=tt)


def test_tables_equal_the_reference_bitwise(tables):
    (jq, jc), (tq, tc) = tables
    assert tq.dtype == torch.float32 and tc.dtype == torch.uint8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("case", ["base", "arrivals", "posterior",
                                  "overrides"])
def test_ranked_walk_through_the_tables(packs, tables, case, monkeypatch):
    """With and without the tables, and against the reference's CPU twin
    with its tables (compiled as in the pipelines): every output bit for
    bit.  The tables' step runs unless overrides are given."""
    jp, tpk = packs
    q = _queue(jp, 40, case == "overrides", case == "posterior",
               seed=len(case))
    track = case != "base"
    steps = []
    step = quant.walk_phase_quant
    monkeypatch.setattr(tops, "walk_phase_quant",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    with_t = _torch_ranked(tpk, q, 128, tables[1], track)
    assert bool(steps) == (case != "overrides")
    without = _torch_ranked(tpk, q, 128, None, track)
    ref = jax.jit(partial(_jax_ranked, jp, q, 128, tables[0], track))()
    for k in KEYS if track else KEYS[:4]:
        np.testing.assert_array_equal(with_t[k].numpy(), without[k].numpy(),
                                      err_msg=k)
        np.testing.assert_array_equal(with_t[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert with_t["walker_steps"] == without["walker_steps"]


@pytest.mark.parametrize("posterior", [False, True])
def test_three_stage_walk_through_the_tables(packs, tables, posterior):
    """At 16,384 lanes (128 apps x 128 walkers) the CPU walk compacts in
    the three stages of ``walk_schedule``: every output with and without
    the tables and against the reference's twin with them, bit for bit."""
    jp, tpk = packs
    q = _queue(jp, 128, False, posterior, seed=9)
    a = _torch_ranked(tpk, q, 128, tables[1], True)
    b = _torch_ranked(tpk, q, 128, None, True)
    ref = jax.jit(partial(_jax_ranked, jp, q, 128, tables[0], True))()
    for k in KEYS:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(a[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert int(a["spill"]) == int(b["spill"]) == int(ref["spill"])


def test_tables_are_memoised_by_kb_identity(packs):
    _, tpk = packs
    first = quant.quant_tables(tpk.samples, tpk.counts, tpk.cum_trans)
    assert quant.quant_tables(tpk.samples, tpk.counts,
                              tpk.cum_trans) is first
    others = [tpk.samples.clone() for _ in range(quant._CACHE_SIZE)]
    for s in others:
        quant.quant_tables(s, tpk.counts, tpk.cum_trans)
    assert len(quant._CACHE) == quant._CACHE_SIZE
    assert quant.quant_tables(tpk.samples, tpk.counts,
                              tpk.cum_trans) is not first


@pytest.mark.parametrize("refresh", [RefreshConfig(),
                                     RefreshConfig(rank_in_kernel=False)],
                         ids=["ranked", "composed"])
def test_cpu_refresh_reads_the_tables_where_the_reference_does(
        refresh, monkeypatch):
    """The default (ranked) CPU refresh walks through the tables and ranks
    as it does without them; the composed walk reads none, as the
    reference's pipeline."""
    kb = t_kb(n_trials=30, seed=4)

    def ranks():
        s = HermesScheduler(kb, refresh=refresh, mc_walkers=64, seed=3,
                            device="cpu")
        for i, name in enumerate(sorted(kb) * 2):
            s.on_arrival(f"a{i}", name, now=0.1 * i)
        out = [s.priorities(1.0)]
        s.on_unit_start("a0", s.apps["a0"].current_unit, 1.5)
        out.append(s.priorities(2.0))
        return out

    built = []
    tables_of = quant.quant_tables
    monkeypatch.setattr(refresh_pipeline, "quant_tables",
                        lambda *a: built.append(1) or tables_of(*a))
    with_t = ranks()
    assert bool(built) == refresh.rank_in_kernel
    monkeypatch.setattr(refresh_pipeline, "quant_tables", lambda *a: None)
    assert ranks() == with_t
