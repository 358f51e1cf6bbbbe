"""The threefry walker and the host-sample refresh modes against the JAX
package, bit for bit: the threefry keys and uniforms, the one-graph and
whole-queue walks (overrides, start units, attained service, arrival rows,
posterior tables), the looped, composed and threefry-fused priorities, the
bare scheduler's default mode, and whole simulator runs under the policies
that rank raw demand samples."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.suite import T_IN, T_OUT
from repro.apps.suite import build_knowledge_base as j_kb
from repro.apps.workload import make_workload as j_workload
from repro.core import pdgraph as j_pd
from repro.core.refresh_config import RefreshConfig as JRefresh
from repro.core.scheduler import HermesScheduler as JScheduler
from repro.serving.simulator import SimConfig as JConfig
from repro.serving.simulator import run_sim as j_run
from repro_torch.apps.suite import build_knowledge_base as t_kb
from repro_torch.apps.workload import make_workload as t_workload
from repro_torch.core import pdgraph as t_pd
from repro_torch.core import threefry
from repro_torch.core.refresh_config import RefreshConfig as TRefresh
from repro_torch.core.scheduler import HermesScheduler as TScheduler
from repro_torch.serving.simulator import SimConfig as TConfig
from repro_torch.serving.simulator import run_sim as t_run


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _key(k):
    return np.asarray(k).astype(np.int64)


@pytest.fixture(scope="module")
def kbs():
    return j_kb(n_trials=20, seed=3), t_kb(n_trials=20, seed=3)


@pytest.fixture(scope="module")
def packed(kbs):
    jk, tk = kbs
    return (j_pd.pack_graphs(jk, T_IN, T_OUT),
            t_pd.pack_graphs(tk, T_IN, T_OUT, device="cpu"))


# ------------------------------------------------------------------ threefry
def test_jax_draws_threefry_in_the_partitionable_layout():
    """The port copies the layout of ``jax_threefry_partitionable`` (split
    and bit draws hash the flat output index); a JAX that draws otherwise
    fails here by name."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 7, 123_456, 2**31 - 1, -3, 2**32 + 5])
def test_prng_key_fold_in_and_split(seed):
    jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    assert np.array_equal(_key(jk), tk.numpy())
    for d in (0, 1, 5, 1 << 20, 2**31 - 1):
        assert np.array_equal(_key(jax.random.fold_in(jk, d)),
                              threefry.fold_in(tk, d).numpy())
    for n in (1, 2, 3, 64):
        assert np.array_equal(_key(jax.random.split(jk, n)),
                              threefry.split(tk, n).numpy())


@pytest.mark.parametrize("width", [1, 7, 128, 512])
@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
def test_uniform_rows(seed, width):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 2**31 - 1)
    tk = threefry.fold_in(threefry.PRNGKey(seed), 2**31 - 1)
    _same_bits(jax.random.uniform(jk, (2, width)),
               threefry.uniform(tk, (2, width)).numpy())


def test_batched_fold_in_and_walk_stream():
    """A batch of keys folds per row, and ``walk_uniforms`` is each row's
    ``uniform(split(key, steps)[t], (2, W))`` in one call."""
    ids = np.asarray([0, 3, 2**31 - 1, 77], np.int64)
    rids = np.asarray([0, 1, 9, 4], np.int64)
    base = jax.random.PRNGKey(5)
    tkeys = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(5),
                                              torch.tensor(ids)),
                             torch.tensor(rids))
    u = threefry.walk_uniforms(tkeys, 6, 7).numpy()
    for i, (a, r) in enumerate(zip(ids, rids)):
        k = jax.random.fold_in(jax.random.fold_in(base, int(a)), int(r))
        assert np.array_equal(_key(k), tkeys[i].numpy())
        for t, kt in enumerate(jax.random.split(k, 6)):
            _same_bits(jax.random.uniform(kt, (2, 7)), u[i, t])


# -------------------------------------------------------------------- walks
def _override(graph, scale=1.0):
    """A conditional-sample override for the graph's first non-entry
    unit (or its entry when it has one unit)."""
    names = sorted(graph.units)
    unit = next((n for n in names if n != graph.entry), graph.entry)
    return {unit: np.linspace(0.05, 4.0, 37) * scale}


@pytest.mark.parametrize("case", ["entry", "start_unit", "executed",
                                  "override", "all"])
def test_one_graph_walk(kbs, case):
    jk, tk = kbs
    for name in sorted(jk):
        units = sorted(jk[name].units)
        kw = {}
        if case in ("start_unit", "all"):
            kw["start_unit"] = units[-1]
        if case in ("executed", "all"):
            kw["executed_in_unit"] = 0.37
        if case in ("override", "all"):
            kw["unit_sample_override"] = _override(jk[name])
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(3), 41), 2)
        tkey = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(3), 41), 2)
        _same_bits(jk[name].mc_service_samples(key, T_IN, T_OUT,
                                               n_walkers=96, **kw),
                   tk[name].mc_service_samples(tkey, T_IN, T_OUT,
                                               n_walkers=96, device="cpu",
                                               **kw))


@pytest.mark.parametrize("n_apps", [1, 5, 13])
def test_whole_queue_walk(kbs, packed, n_apps):
    """``mc_service_samples_batch`` at a queue length that is not a power
    of two, with start units, attained service and overrides."""
    jk, _ = kbs
    jp, tp = packed
    names = sorted(jk)
    rng = np.random.default_rng(n_apps)
    gi = (np.arange(n_apps) * 3) % len(names)
    start = np.asarray([rng.integers(len(jp.unit_index[g])) for g in gi],
                       np.int32)
    kw = dict(graph_idx=gi, start=start,
              executed=rng.uniform(0.0, 1.0, n_apps),
              key_ids=rng.integers(0, 2**31 - 1, n_apps).astype(np.int32),
              refresh_ids=rng.integers(0, 7, n_apps).astype(np.int32),
              overrides=[_override(jk[names[g]], 1 + a % 3) if a % 2 else
                         None for a, g in enumerate(gi)],
              n_walkers=64)
    _same_bits(j_pd.mc_service_samples_batch(jp, jax.random.PRNGKey(9), **kw),
               t_pd.mc_service_samples_batch(tp, threefry.PRNGKey(9), **kw))


@pytest.mark.parametrize("posterior", [False, True], ids=["prior", "post"])
@pytest.mark.parametrize("arrivals", [False, True], ids=["total", "arr"])
def test_walk_batch_arrivals_and_posterior(packed, posterior, arrivals):
    """``_mc_walk_batch`` (jitted, as the fused pipelines run it) with
    override rows, arrival tracking and posterior walk tables."""
    jp, tp = packed
    A, U, W = 6, jp.n_units, 64
    rng = np.random.default_rng(1)
    gi = (np.arange(A) % len(jp.names)).astype(np.int32)
    st = jp.entry[gi].astype(np.int32)
    ex = rng.uniform(0, 1, A).astype(np.float32)
    kid = rng.integers(0, 2**31 - 1, A).astype(np.int32)
    rid = rng.integers(0, 9, A).astype(np.int32)
    ovs = rng.uniform(0.1, 3, (A, U, 4)).astype(np.float32)
    ovc = (rng.integers(1, 5, (A, U))
           * (rng.uniform(size=(A, U)) < 0.3)).astype(np.int32)
    j_kw, t_kw = {}, {}
    if posterior:
        cum = np.asarray(jp.cum_trans)[gi]
        po_cum = np.sort(np.clip(cum + rng.normal(0, 0.02, cum.shape), 0, 1)
                         .astype(np.float32), -1)
        po_cum[..., -1] = 1.0
        po_scale = rng.uniform(0.5, 2, (A, U)).astype(np.float32)
        j_kw = dict(po_cum=jnp.asarray(po_cum), po_scale=jnp.asarray(po_scale))
        t_kw = dict(po_cum=torch.tensor(po_cum),
                    po_scale=torch.tensor(po_scale))
    j = j_pd._mc_walk_batch(
        jp.samples, jp.counts, jp.cum_trans, jnp.asarray(gi), jnp.asarray(st),
        jnp.asarray(ex), jax.random.PRNGKey(11), jnp.asarray(kid),
        jnp.asarray(rid), jnp.asarray(ovs), jnp.asarray(ovc), W, 64,
        track_arrivals=arrivals, **j_kw)
    i64 = lambda a: torch.tensor(a.astype(np.int64))  # noqa: E731
    t = t_pd._mc_walk_batch(
        tp.samples, tp.counts, tp.cum_trans, i64(gi), i64(st),
        torch.tensor(ex), threefry.PRNGKey(11), i64(kid), i64(rid),
        torch.tensor(ovs), torch.tensor(ovc), W, 64,
        track_arrivals=arrivals, **t_kw)
    if arrivals:
        _same_bits(j[0], t[0].numpy())
        _same_bits(j[1], t[1].numpy())
        assert (t[1].numpy() < t_pd.ARRIVAL_NEVER).any()
    else:
        _same_bits(j, t.numpy())


# --------------------------------------------------------------- scheduler
def _filled(S, kb, n_apps=13, **kw):
    s = S(kb, t_in=T_IN, t_out=T_OUT, mc_walkers=32, seed=11, **kw)
    names = sorted(kb)
    for i in range(n_apps):
        aid = f"a{i:03d}"
        s.on_arrival(aid, names[i % len(names)], now=0.25 * i,
                     tenant=f"t{i % 4}", deadline=200.0 + 3.0 * i)
        s.on_progress(aid, 0.05 * i)
    return s


def _ranks(s, now):
    r = s.priorities(now)
    return np.asarray([r[k] for k in sorted(r)])


def _advance(s):
    """Finish every app's entry unit with an observation (refinement
    overrides for the correlated units), then bump attained service."""
    for a in list(s._live.values())[::2]:
        g = s.kb[a.app_name]
        nxt = sorted(n for n in g.units[a.current_unit].next_counts
                     if n != "$end")
        obs = {"in": 300.0, "out": 120.0, "par": 1.0, "dur": 0.8}
        s.on_unit_finish(a.app_id, a.current_unit, obs, 12.0,
                         nxt[0] if nxt else None)
    for a in list(s._live.values()):
        s.on_progress(a.app_id, 0.31)


MODES = {
    "looped": (dict(batched=False), dict(batched=False)),
    "composed": ({}, {}),
    "fused_threefry": (dict(refresh=JRefresh(mode="fused",
                                             walker="threefry")),
                       dict(refresh=TRefresh(mode="fused",
                                             walker="threefry"))),
    "fused_delta_threefry": (dict(refresh=JRefresh(walker="threefry")),
                             dict(refresh=TRefresh(walker="threefry"))),
}


@pytest.mark.parametrize("policy", ["gittins", "srpt_mean", "lstf",
                                    "hermes_ddl"])
@pytest.mark.parametrize("mode", list(MODES))
def test_priorities_match_the_reference(kbs, mode, policy):
    """Each mode's priorities equal the reference's in that mode, bit for
    bit, before and after refinement and progress re-walk the queue."""
    jk, tk = kbs
    j_kw, t_kw = MODES[mode]
    j = _filled(JScheduler, jk, policy=policy, **j_kw)
    t = _filled(TScheduler, tk, policy=policy, device="cpu", **t_kw)
    assert t.mode == j.mode and t.batched == j.batched
    _same_bits(_ranks(j, 10.0).astype(np.float64),
               _ranks(t, 10.0).astype(np.float64))
    _advance(j)
    _advance(t)
    j.refresh_tick(14.0, resample=True)
    t.refresh_tick(14.0, resample=True)
    _same_bits(_ranks(j, 15.0), _ranks(t, 15.0))


@pytest.mark.parametrize("policy", ["gittins", "srpt_mean"])
def test_looped_and_composed_agree(kbs, policy):
    """The two host-sample modes draw the same samples (one fold_in
    chain), so their ranks are the same bits."""
    _, tk = kbs
    loop = _filled(TScheduler, tk, policy=policy, batched=False,
                   device="cpu")
    comp = _filled(TScheduler, tk, policy=policy, device="cpu")
    _same_bits(_ranks(loop, 10.0), _ranks(comp, 10.0))
    for a in comp._live.values():
        _same_bits(a.view.total_samples,
                   loop._live[a.app_id].view.total_samples)


def test_bare_scheduler_defaults(kbs):
    """``HermesScheduler(kb)`` runs composed, ``batched=False`` looped, as
    in the reference; the Gittins policy bucketizes the queue at once only
    when batched."""
    jk, tk = kbs
    for batched in (True, False):
        j = JScheduler(jk, batched=batched)
        t = TScheduler(tk, batched=batched, device="cpu")
        assert t.mode == j.mode == ("composed" if batched else "looped")
        assert t.policy.vectorized is j.policy.vectorized is batched
        assert not t._fused_active() and not t.prewarm_batched


def test_fused_threefry_pipeline_matches_the_composed_walk(kbs):
    """The fused tick with ``walker="threefry"`` and prewarming on ranks
    the walked rows with the composed path's bits and plans the same
    prewarm triggers as the reference."""
    jk, tk = kbs
    j = _filled(JScheduler, jk, refresh=JRefresh(mode="fused",
                                                 walker="threefry"))
    t = _filled(TScheduler, tk, refresh=TRefresh(mode="fused",
                                                 walker="threefry"),
                device="cpu")
    c = _filled(TScheduler, tk, device="cpu")
    assert t.prewarm_batched and t.rank_in_kernel is False
    rt = _ranks(t, 10.0)
    _same_bits(_ranks(j, 10.0), rt)
    jp, tp = j.take_prewarm_plan(), t.take_prewarm_plan()
    assert len(tp) == len(jp) > 0
    assert (tp.app_ids, tp.resource_keys) == (jp.app_ids, jp.resource_keys)
    np.testing.assert_array_equal(tp.fire_at, jp.fire_at)
    np.testing.assert_array_equal(tp.p_reach, jp.p_reach)
    # the same samples reach the host views in composed mode
    np.testing.assert_allclose(_ranks(c, 10.0), rt, rtol=1e-6)


# --------------------------------------------------------------- simulator
def _assert_same_run(j, t):
    assert len(t.completion_order) == len(j.completion_order) > 0
    assert t.completion_order == j.completion_order
    ids = j.completion_order
    np.testing.assert_allclose([t.acts[a] for a in ids],
                               [j.acts[a] for a in ids], rtol=1e-6)
    assert t.policy_calls == j.policy_calls


@pytest.mark.parametrize("arm", ["srpt_mean", "oracle", "composed"])
def test_run_sim_matches(arm):
    """Fig. 12's ablation arms (``srpt_mean``, ``oracle``) and the composed
    refresh on a small trace: the reference's completion order, ACTs
    within 1e-6."""
    policy = arm if arm != "composed" else "gittins"
    kw = dict(seed=29, t_in=T_IN, t_out=T_OUT)
    cfg = dict(seed=5, n_llm_slots=8, mc_walkers=32, policy=policy)
    jr = dict(refresh=JRefresh(mode="composed")) if arm == "composed" else {}
    tr = dict(refresh=TRefresh(mode="composed")) if arm == "composed" else {}
    j = j_run(j_kb(n_trials=40, seed=3), j_workload(24, 120.0, **kw),
              JConfig(**cfg, **jr))
    t = t_run(t_kb(n_trials=40, seed=3), t_workload(24, 120.0, **kw),
              TConfig(device="cpu", **cfg, **tr))
    _assert_same_run(j, t)
