"""Online posterior learning in the port against the JAX package: the walk
tables (``posterior_tables``, held against the reference compiled under
``jax.jit``, where XLA contracts its multiply-adds), the host-side
statistics (``PosteriorState``), the ranked walk with posterior tables, and
delta ticks over an arena whose slots carry posterior rows — with the rank
in the kernel and composed from the per-phase walk.
"""
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import posterior as jpo
from repro.kernels.pdgraph_walk import ops as jops
from repro_torch.core import posterior as tpo
from repro_torch.kernels.pdgraph_walk import ops as tops
from repro_torch.kernels.pdgraph_walk import ref as tref
from test_torch_delta import _churn, _Pair, kbs  # noqa: F401  (fixture)

NB = 10


def _random_rows(rng, P, U, p_zero=0.4):
    """Posterior rows with a mix of observed and all-zero units."""
    rows = np.zeros((P, U, tpo.row_width(U)), np.float32)
    observed = rng.uniform(size=(P, U)) > p_zero
    counts = rng.integers(0, 6, (P, U, U + 1)).astype(np.float32)
    rows[..., :U + 1] = counts * observed[..., None]
    dcnt = rng.integers(1, 9, (P, U)).astype(np.float32) * observed
    rows[..., U + 1] = dcnt * rng.uniform(0.1, 30.0, (P, U)).astype(
        np.float32)
    rows[..., U + 2] = dcnt
    return rows


def _jax_tables(jp, rows, gi, tau_b=8.0, tau_d=8.0):
    """The reference's tables as its delta tick builds them: the prior mean
    and the blend inside one jit."""
    def fn(samples, counts, cum, rows, gi):
        pm = jnp.sum(samples, axis=-1) / jnp.maximum(
            counts.astype(jnp.float32), 1.0)
        return jpo.posterior_tables(rows, cum[gi], pm[gi],
                                    branch_strength=tau_b,
                                    demand_strength=tau_d)
    out = jax.jit(fn)(jp.samples, jp.counts, jp.cum_trans,
                      jnp.asarray(rows), jnp.asarray(gi))
    return [np.asarray(o) for o in out]


def _torch_tables(tpk, rows, gi, tau_b=8.0, tau_d=8.0):
    g = torch.as_tensor(gi).long()
    out = tpo.posterior_tables(
        torch.as_tensor(rows), tpk.cum_trans[g],
        tpo.prior_mean(tpk.samples, tpk.counts)[g],
        branch_strength=tau_b, demand_strength=tau_d)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("p_zero", [0.0, 0.4, 1.0], ids=["all", "mix",
                                                          "none"])
@pytest.mark.parametrize("tau", [(8.0, 8.0), (0.5, 30.0)])
def test_posterior_tables_bitwise(kbs, p_zero, tau):
    jp, tpk, *_ = kbs
    rng = np.random.default_rng(int(p_zero * 10) + int(tau[0]))
    G, U, _ = jp.samples.shape
    P = 96
    gi = rng.integers(0, G, P).astype(np.int32)
    rows = _random_rows(rng, P, U, p_zero)
    j = _jax_tables(jp, rows, gi, *tau)
    t = _torch_tables(tpk, rows, gi, *tau)
    for name, a, b in zip(("po_cum", "po_scale"), j, t):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_standalone_jit_tables_bitwise(kbs):
    """Against ``jax.jit(posterior_tables)`` on its own as well."""
    jp, tpk, *_ = kbs
    rng = np.random.default_rng(4)
    G, U, _ = jp.samples.shape
    gi = rng.integers(0, G, 64)
    rows = _random_rows(rng, 64, U)
    pm = tpo.prior_mean(tpk.samples, tpk.counts)[torch.as_tensor(gi)]
    cum = tpk.cum_trans[torch.as_tensor(gi)]
    j = jax.jit(partial(jpo.posterior_tables, branch_strength=8.0,
                        demand_strength=8.0))(
        jnp.asarray(rows), jnp.asarray(cum.numpy()), jnp.asarray(pm.numpy()))
    t = tpo.posterior_tables(torch.as_tensor(rows), cum, pm,
                             branch_strength=8.0, demand_strength=8.0)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_zero_observation_rows_are_the_prior(kbs):
    _, tpk, *_ = kbs
    G, U, _ = tpk.samples.shape
    gi = torch.arange(G)
    cum, scale = tpo.posterior_tables(
        torch.zeros((G, U, tpo.row_width(U))), tpk.cum_trans,
        tpo.prior_mean(tpk.samples, tpk.counts),
        branch_strength=8.0, demand_strength=8.0)
    assert torch.equal(cum, tpk.cum_trans[gi])
    assert torch.equal(scale, torch.ones((G, U)))


def _batch(rng, n):
    units = ("u0", "u1", "u2")
    out = []
    for _ in range(n):
        name = ("G0", "G1")[int(rng.integers(2))]
        unit = units[int(rng.integers(3))]
        if rng.uniform() < 0.5:
            out.append((name, unit, "branch",
                        (units + (tpo.END,))[int(rng.integers(4))]))
        else:
            out.append((name, unit, "demand",
                        float(np.float32(rng.uniform(0.01, 50.0)))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_posterior_state_fold_and_rows_match(seed):
    """The same observation batches, folded in different orders, give the
    reference's rows bit for bit; unknown units are dropped."""
    rng = np.random.default_rng(seed)
    js, ts = jpo.PosteriorState(), tpo.PosteriorState()
    for _ in range(3):
        b = _batch(rng, int(rng.integers(1, 40)))
        b.append(("G0", "gone", "demand", 9.5))
        b.append(("G1", "u1", "branch", "gone"))
        assert js.fold(b) == ts.fold([b[i] for i in
                                      rng.permutation(len(b))])
    assert js.n_observations() == ts.n_observations()
    order = ["u0", "u1", "u2"]
    for name in ("G0", "G1", "missing"):
        np.testing.assert_array_equal(js.graph_row(name, order, 3),
                                      ts.graph_row(name, order, 3))
    row = ts.graph_row("G0", order, 3)
    assert row.shape == (3, tpo.row_width(3)) == (3, 3 + 1 + tpo.STAT_COLS)


def test_graph_row_layout():
    st = tpo.PosteriorState()
    st.fold([("G", "u0", "branch", "u1"), ("G", "u0", "branch", "u1"),
             ("G", "u0", "branch", tpo.END), ("G", "u1", "demand", 2.5),
             ("G", "u1", "demand", 1.5)])
    row = st.graph_row("G", ["u0", "u1"], 2)
    assert row[0, 1] == 2.0 and row[0, 2] == 1.0
    assert row[1, 3] == np.float32(4.0) and row[1, 4] == 2.0


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_ranked_walk_with_posterior_bitwise(kbs, impl):
    """``pdgraph_walk_ranked`` with posterior tables against the reference's
    CPU twin (compacted) and its kernel in interpret mode (single-phase):
    histogram and arrival rows bitwise; ranks bitwise against the twin and
    to 1e-5 against the kernel, whose rank sums in another order."""
    jp, tpk, *_ = kbs
    rng = np.random.default_rng(7)
    G, U, _ = jp.samples.shape
    A, W = 8, 32
    gi = rng.integers(0, G, A).astype(np.int32)
    start = np.asarray(jp.entry)[gi].astype(np.int32)
    ex = rng.uniform(0, 0.5, A).astype(np.float32)
    att = rng.uniform(0, 3.0, A).astype(np.float32)
    valid = np.arange(A) < A - 1
    po_cum, po_scale = _torch_tables(tpk, _random_rows(rng, A, U), gi)
    kid, rid = np.arange(A), rng.integers(0, 3, A)
    kw = dict(n_walkers=W, max_steps=24, n_buckets=NB, with_total=True)
    j = jax.jit(partial(
        jops.pdgraph_walk_ranked, impl=impl,
        interpret=True if impl == "pallas" else None, track_arrivals=True,
        **kw))(jp.samples, jp.counts, jp.cum_trans, jnp.asarray(gi),
               jnp.asarray(start), jnp.asarray(ex),
               jops.walker_streams(np.uint32(7), kid, rid), jnp.asarray(att),
               valid=jnp.asarray(valid), po_cum=jnp.asarray(po_cum),
               po_scale=jnp.asarray(po_scale))
    t = torch.as_tensor
    out = tops.pdgraph_walk_ranked(
        tpk.samples, tpk.counts, tpk.cum_trans, t(gi), t(start), t(ex),
        tref.walker_streams(7, kid, rid), t(att), valid=t(valid),
        track_arrivals=True, po_cum=t(po_cum), po_scale=t(po_scale), **kw)
    for k in ("probs", "edges", "total", "a_hist", "a_lo", "a_span",
              "a_reach"):
        np.testing.assert_array_equal(np.asarray(j[k]), out[k].numpy(),
                                      err_msg=k)
    if impl == "ref":
        np.testing.assert_array_equal(np.asarray(j["ranks"]),
                                      out["ranks"].numpy())
    else:
        np.testing.assert_allclose(out["ranks"].numpy(),
                                   np.asarray(j["ranks"]), rtol=1e-5)


@pytest.mark.parametrize("rank_in_kernel", [True, False],
                         ids=["ranked", "composed"])
def test_posterior_delta_ticks_over_churned_arena(kbs, rank_in_kernel):
    """Delta ticks with posterior rows on the walked slots (some all-zero,
    so they walk on the prior), after churn, growth and a repack."""
    rng = np.random.default_rng(13)
    pair = _Pair(kbs)
    U = pair.jp.samples.shape[1]
    cfg = dict(posterior=jpo.PosteriorConfig(branch_strength=4.0),
               rank_in_kernel=rank_in_kernel)
    tcfg = dict(posterior=tpo.PosteriorConfig(branch_strength=4.0),
                rank_in_kernel=rank_in_kernel)

    def tick():
        walked = pair.j.take_dirty()
        np.testing.assert_array_equal(walked, pair.t.take_dirty())
        rows = _random_rows(rng, len(walked), U)
        pair.both("update_posterior_rows", walked, rows)
        pair.tick(walked=walked, j_extra=cfg, t_extra=tcfg)
        np.testing.assert_array_equal(pair.j.posterior_rows(walked),
                                      pair.t.posterior_rows(walked))

    pair.admit(rng, 12)
    tick()
    for _ in range(3):
        _churn(pair, rng)
        pair.admit(rng, int(rng.integers(2, 9)))
        tick()
    live = [pair.j.ids[s] for s in pair.j.occupied()]
    for app in live[: len(live) * 3 // 4]:
        pair.both("retire", app)
    a, b = pair.both("maybe_repack", 0.25, 8)
    assert a == b and a is not None
    occ = pair.j.occupied()
    np.testing.assert_array_equal(pair.j.posterior_rows(occ),
                                  pair.t.posterior_rows(occ))
    _churn(pair, rng)
    tick()
