"""The module that holds the fused walk kernel: the port's plain
``pdgraph_walk_ranked`` and its reductions against the JAX package.

The reference's reductions are held as XLA compiles them inside the refresh
pipelines (under ``jax.jit``): there the Gittins bucket sum is a chain of
fused multiply-adds, which the port reproduces bit for bit.  The Pallas
kernel (interpret mode) ranks with ``rank_rows_loop``, which sums in another
order; against it ranks are held to 1e-5 relative and everything else
bitwise.
"""
from fractions import Fraction
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.apps.suite import T_IN, T_OUT, build_knowledge_base
from repro.core import gittins as jg
from repro.core.pdgraph import pack_graphs
from repro.kernels.pdgraph_walk import ops as jops
from repro_torch.core import gittins as tg
from repro_torch.core import pdgraph as tp
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.pdgraph_walk import ops as tops
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


def _queue(jp, A, W, attained, overrides, seed=0):
    rng = np.random.default_rng(seed)
    G, U, _ = jp.samples.shape
    gi = rng.integers(0, G, A).astype(np.int32)
    start = np.where(rng.random(A) < 0.7, jp.entry[gi],
                     rng.integers(0, U, A)).astype(np.int32)
    q = dict(graph_idx=gi, start=start,
             executed=rng.uniform(0.0, 0.5, A).astype(np.float32),
             attained={"zero": np.zeros(A, np.float32),
                       "rand": rng.uniform(0.0, 3.0, A).astype(np.float32),
                       "large": np.full(A, 37.5, np.float32)}[attained],
             key_ids=np.arange(A), refresh_ids=rng.integers(0, 4, A),
             valid=np.arange(A) < A - 2)
    if overrides:
        So = 8
        ovs = np.zeros((A, U, So), np.float32)
        ovc = np.zeros((A, U), np.int32)
        for a in range(0, A, 2):
            u, n = int(rng.integers(0, U)), int(rng.integers(1, So + 1))
            ovc[a, u] = n
            ovs[a, u, :n] = rng.uniform(0.1, 8.0, n)
        q.update(ov_samples=ovs, ov_counts=ovc)
    return q


def _jax(jp, q, W, steps, **kw):
    streams = jops.walker_streams(np.uint32(7), q["key_ids"],
                                  q["refresh_ids"])
    ov = {k: jnp.asarray(q[k]) for k in ("ov_samples", "ov_counts")
          if k in q}
    return jops.pdgraph_walk_ranked(
        jp.samples, jp.counts, jp.cum_trans, jnp.asarray(q["graph_idx"]),
        jnp.asarray(q["start"]), jnp.asarray(q["executed"]), streams,
        jnp.asarray(q["attained"]), **ov, valid=jnp.asarray(q["valid"]),
        n_walkers=W, max_steps=steps, n_buckets=NB, with_total=True, **kw)


def _torch(tpk, q, W, steps, track=True):
    t = torch.as_tensor
    ov = {k: t(q[k]) for k in ("ov_samples", "ov_counts") if k in q}
    return tops.pdgraph_walk_ranked(
        tpk.samples, tpk.counts, tpk.cum_trans, t(q["graph_idx"]),
        t(q["start"]), t(q["executed"]),
        tref.walker_streams(7, q["key_ids"], q["refresh_ids"]),
        t(q["attained"]), **ov, valid=t(q["valid"]), n_walkers=W,
        max_steps=steps, n_buckets=NB, track_arrivals=track,
        with_total=True)


@pytest.mark.parametrize("overrides", [False, True], ids=["base", "ov"])
@pytest.mark.parametrize("attained", ["zero", "rand", "large"])
def test_plain_matches_reference_bitwise(packs, attained, overrides):
    """Every output of the plain version equals the reference's CPU twin
    (``impl="ref"``, compiled as in the pipelines) bit for bit."""
    jp, tpk = packs
    q = _queue(jp, 12, 32, attained, overrides, seed=len(attained))
    ref = jax.jit(partial(_jax, jp, q, 32, 64, impl="ref",
                          track_arrivals=True))()
    out = _torch(tpk, q, 32, 64)
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(ref[k]), out[k].numpy(),
                                      err_msg=k)
    assert int(out["spill"]) == 0


@pytest.mark.parametrize("arrivals", [False, True])
def test_plain_matches_pallas_interpret(packs, arrivals):
    """Against the TPU kernel itself (Pallas interpret mode) at the
    reference's fused-rank test sizes: histogram and arrival rows
    bitwise, ranks to 1e-5 relative (the kernel's rank sums in the
    ``rank_rows_loop`` order; ROADMAP.md section 3)."""
    jp, tpk = packs
    q = _queue(jp, 8, 32, "rand", False, seed=3)
    ker = _jax(jp, q, 32, 24, impl="pallas", interpret=True,
               track_arrivals=arrivals)
    out = _torch(tpk, q, 32, 24, track=arrivals)
    keys = [k for k in KEYS if k != "ranks" and (arrivals or "a_" not in k)]
    for k in keys:
        np.testing.assert_array_equal(np.asarray(ker[k]), out[k].numpy(),
                                      err_msg=k)
    np.testing.assert_allclose(out["ranks"].numpy(), np.asarray(ker["ranks"]),
                               rtol=1e-5)


def test_cpu_tensors_take_the_plain_version(packs):
    jp, tpk = packs
    before = dict(LAUNCHES)
    _torch(tpk, _queue(jp, 4, 16, "zero", True), 16, 16)
    assert LAUNCHES == before


@pytest.mark.parametrize("W", [32, 256])
def test_histogram_rows_and_ranks_bitwise(W):
    rng = np.random.default_rng(W)
    tot = (rng.lognormal(2.0, 1.0, (512, W))
           * rng.uniform(0.1, 3.0, (512, 1))).astype(np.float32)
    tot[::9] = tot[::9, :1]                       # degenerate rows
    att = rng.uniform(0.0, 20.0, 512).astype(np.float32)
    att[::3] = 0.0
    jp_, je = (np.asarray(x) for x in
               jax.jit(partial(jg.to_histogram_rows_jnp, n_buckets=NB))(tot))
    tp_, te = tg.to_histogram_rows(torch.as_tensor(tot), NB)
    np.testing.assert_array_equal(jp_, tp_.numpy())
    np.testing.assert_array_equal(je, te.numpy())
    jr = np.asarray(jax.jit(jg.gittins_rank_core)(jp_, je, att))
    tr = tg.gittins_rank_core(tp_, te, torch.as_tensor(att)).numpy()
    np.testing.assert_array_equal(jr, tr)
    np.testing.assert_array_equal(
        tr, tg.gittins_rank_hist_np(jp_, je, att))


def _exact_fma(a, b, c):
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(v))                 # within one ulp of v
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    # nearest, ties to the even significand
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - v),
                                     int(np.float32(x).view(np.uint32)) & 1))


def test_fma32_rounds_once():
    rng = np.random.default_rng(0)
    n = 400
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n)
         * np.exp2(rng.integers(-30, 30, n))).astype(np.float32)
    # products that land exactly between two float32 after a float64 round
    a[:40] = np.float32(1.0) + np.float32(2.0 ** -12)
    b[:40] = np.float32(1.0) + np.float32(2.0 ** -12)
    c[:40] = np.float32(2.0 ** -60) * np.sign(rng.standard_normal(40))
    got = tg.fma32(torch.as_tensor(a), torch.as_tensor(b),
                   torch.as_tensor(c)).numpy()
    want = np.asarray([_exact_fma(*x) for x in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_pad_rows_matches():
    for n in list(range(0, 300)) + [1000, 4097, 16385]:
        for m in (1, 8):
            assert tops.pad_rows(n, m) == jops.pad_rows(n, m), (n, m)


def test_spilling_ranked_walk_matches_reference():
    """A loopy graph at 16,384 lanes: the reference's CPU twin compacts
    with ``walk_schedule`` (three stages there) and spills; the port's CPU
    version compacts the same way and must report the same spill, totals
    and ranks."""
    from repro.core.pdgraph import BackendSpec, PDGraph, UnitNode
    u = UnitNode(name="loop", backend=BackendSpec(kind="dnn", model="t"),
                 duration=[1.0, 2.0, 3.5],
                 next_counts={"loop": 97, "$end": 3})
    kb = {"loopy": PDGraph("loopy", "loop", {"loop": u})}
    jp = pack_graphs(kb, T_IN, T_OUT)
    tpk = tp.pack_graphs({n: tp.PDGraph.from_json(g.to_json())
                          for n, g in kb.items()}, T_IN, T_OUT, device="cpu")
    A, W = 64, 256
    rng = np.random.default_rng(8)
    q = dict(graph_idx=np.zeros(A, np.int32), start=np.zeros(A, np.int32),
             executed=rng.uniform(0.0, 0.5, A).astype(np.float32),
             attained=rng.uniform(0.0, 3.0, A).astype(np.float32),
             key_ids=np.arange(A), refresh_ids=np.zeros(A, np.int64),
             valid=np.ones(A, bool))
    ref = jax.jit(partial(_jax, jp, q, W, 64, impl="ref"))()
    out = _torch(tpk, q, W, 64, track=False)
    assert int(out["spill"]) == int(ref["spill"]) > 0
    for k in ("total", "probs", "edges", "ranks"):
        np.testing.assert_array_equal(np.asarray(ref[k]), out[k].numpy(),
                                      err_msg=k)
