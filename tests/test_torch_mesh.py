"""The port's sharded arena and mesh tick against the JAX package.

(a) ``QueueState(n_shards=n)`` places, grows, retires and repacks slots
exactly as the reference's does, call for call, device rows included.
(b) The port's mesh tick (the shards a loop on the CPU, the plain versions
of the walk kernels) gives the same bits as the reference's single-arena
delta tick — ranks, triage scalars, arena rows, posterior rows and the
``PrewarmPlan`` — at 1, 2 and 8 shards, through churn, a repack, the
event path and the skewed, lane-balanced tick.
(c) The reference's real ``shard_map`` mesh at 8 host devices, in a
subprocess (the main process must see one JAX device).
(d) ``run_sim`` at ``mesh_shards=2`` schedules as the reference's default.

Every comparison is bitwise unless it says otherwise.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.apps.suite import T_IN, T_OUT
from repro.apps.suite import build_knowledge_base as j_kb
from repro.core import arena as j_arena
from repro.core.pdgraph import pack_graphs as j_pack
from repro.core.posterior import PosteriorConfig as JPosterior
from repro.core.refresh_config import RefreshConfig as JRefresh
from repro.core.scheduler import HermesScheduler as JSched
from repro_torch.apps.suite import build_knowledge_base as t_kb
from repro_torch.core import arena as t_arena
from repro_torch.core import refresh_mesh as t_mesh
from repro_torch.core import scheduler as t_sched_mod
from repro_torch.core.pdgraph import pack_graphs as t_pack
from repro_torch.core.posterior import PosteriorConfig as TPosterior
from repro_torch.core.refresh_config import RefreshConfig as TRefresh
from repro_torch.core.scheduler import HermesScheduler as TSched
from repro_torch.kernels.pdgraph_walk.ops import walk_schedule

ROOT = Path(__file__).resolve().parent.parent
MC = 32
SHARDS = (1, 2, 8)


@pytest.fixture(scope="module")
def kbs():
    return j_kb(n_trials=60, seed=3), t_kb(n_trials=60, seed=3)


# ------------------------------------------------------------ (a) the arena

class _Arenas:
    """The same sharded arena in both packages, driven call for call."""

    def __init__(self, kbs, n_shards, capacity=16):
        jk, tk = kbs
        self.jp = j_pack(jk, T_IN, T_OUT)
        self.tp = t_pack(tk, T_IN, T_OUT, device="cpu")
        self.j = j_arena.QueueState(self.jp, capacity=capacity,
                                    n_shards=n_shards)
        self.t = t_arena.QueueState(self.tp, capacity=capacity,
                                    n_shards=n_shards)
        for qs in (self.j, self.t):
            qs.ensure_result_rows(4, 2, arrivals=True)
        self.n = 0

    def both(self, name, *args):
        a = getattr(self.j, name)(*args)
        b = getattr(self.t, name)(*args)
        if a is None or isinstance(a, (int, dict)):
            assert a == b, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
        self.check()
        return a

    def admit(self, rng, k):
        rows = []
        for _ in range(k):
            g = int(rng.integers(0, len(self.jp.names)))
            rows.append((f"app{self.n}", g, int(self.jp.entry[g]), self.n,
                         None))
            self.n += 1
        if k == 1:
            self.both("admit", *rows[0][:4])
        else:
            self.both("admit_many", rows)
        self.stamp(np.asarray([self.j.slot[r[0]] for r in rows]))

    def stamp(self, slots):
        """Write each slot's id into its device rows, in both packages."""
        for name in ("d_probs", "a_lo"):
            ja, ta = getattr(self.j, name), getattr(self.t, name)
            rows = self.j.device_rows(slots)
            vals = np.repeat(slots[:, None].astype(np.float32) + 1,
                             ja.shape[1], 1)
            setattr(self.j, name, ja.at[jnp.asarray(rows)].set(vals))
            ta[torch.as_tensor(rows)] = torch.as_tensor(vals)

    def check(self):
        j, t = self.j, self.t
        assert (j.capacity, j.shard_capacity, j.live) == \
            (t.capacity, t.shard_capacity, t.live)
        assert j._frees == t._frees and j._free == t._free
        assert j._dirty == t._dirty and j.rank_dirty == t.rank_dirty
        assert j.slot == t.slot and j.ids == t.ids
        np.testing.assert_array_equal(j.occupied(), t.occupied())
        cap = np.arange(j.capacity)
        np.testing.assert_array_equal(j.device_rows(cap), t.device_rows(cap))
        np.testing.assert_array_equal(j.row_slots(), t.row_slots())
        assert [j.shard_of(s) for s in cap] == [t.shard_of(s) for s in cap]
        for name in ("graph_idx", "start", "attained", "key_id",
                     "refresh_id", "deadline", "stretch", "ov_counts",
                     "a_att", "trig"):
            np.testing.assert_array_equal(getattr(j, name), getattr(t, name),
                                          err_msg=name)
        for name in ("d_probs", "d_edges", "a_hist", "a_lo", "a_span"):
            np.testing.assert_array_equal(
                np.asarray(getattr(j, name)), getattr(t, name).numpy(),
                err_msg=name)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_arena_matches_the_reference_call_for_call(kbs, n_shards):
    rng = np.random.default_rng(7 + n_shards)
    ar = _Arenas(kbs, n_shards)
    ar.admit(rng, 11)
    ar.admit(rng, 1)
    for _ in range(3):                        # grow past 16 and 32 slots
        ar.admit(rng, 9)
        ar.both("take_dirty")
        live = [ar.j.ids[s] for s in ar.j.occupied()]
        for app in rng.choice(live, len(live) // 4, replace=False):
            ar.both("retire", str(app))
        ar.both("retire_many", [str(a) for a in
                                rng.choice(live, 3, replace=False)])
        live = [ar.j.ids[s] for s in ar.j.occupied()]
        for app in rng.choice(live, len(live) // 3, replace=False):
            ar.both("set_unit", str(app), int(rng.integers(0, 4)))
        for app in rng.choice(live, len(live) // 2, replace=False):
            ar.both("add_progress", str(app), float(rng.uniform(0, 3)))
        ar.both("mark_dirty_many", [str(a) for a in live[:3]])
        ar.both("dirty_in", set(ar.j.occupied()[:5].tolist()))
        ar.admit(rng, 2)
    assert ar.j.capacity >= 32
    live = [ar.j.ids[s] for s in ar.j.occupied()]
    for app in live[: len(live) - 5]:
        ar.both("retire", str(app))
    ar.both("maybe_repack", 0.25, 4)           # shrink: slots renumbered
    ar.admit(rng, 3)
    ar.both("repack", 64)                      # and back out
    ar.both("clear_dirty", ar.j.occupied()[:2].tolist())
    ar.both("take_dirty")


@pytest.mark.parametrize("n_shards", (2, 8))
def test_admission_balances_shards(kbs, n_shards):
    """Consecutive admissions land on different shards; a retire frees the
    slot back to its own shard, which then takes the next admission."""
    ar = _Arenas(kbs, n_shards)
    rng = np.random.default_rng(3)
    ar.admit(rng, n_shards)
    shards = sorted(ar.t.shard_of(ar.t.slot[f"app{i}"])
                    for i in range(n_shards))
    assert shards == list(range(n_shards))
    victim = ar.t.slot["app1"]
    ar.both("retire", "app1")
    ar.admit(rng, 1)
    assert ar.t.shard_of(ar.t.slot[f"app{n_shards}"]) == victim % n_shards


def test_sharded_arena_guards(kbs):
    _, tk = kbs
    tp = t_pack(tk, T_IN, T_OUT, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        t_arena.QueueState(tp, n_shards=3)
    assert t_arena.QueueState(tp, capacity=2, n_shards=8).capacity == 8


# ------------------------------------------------- (b) the tick, scheduler

def _filled(sched, refresh, kb, mesh=None, policy="gittins", prewarm=False,
            walker="pallas", n_apps=24, posterior=None, rik=None, lane=None,
            **kw):
    s = sched(kb, policy=policy, t_in=T_IN, t_out=T_OUT, mc_walkers=MC,
              seed=11, prewarm=prewarm, posterior=posterior,
              refresh=refresh(mode="fused_delta", walker=walker,
                              mesh_shards=mesh, rank_in_kernel=rik,
                              lane_balance=lane), **kw)
    names = sorted(kb)
    for i in range(n_apps):
        aid = f"a{i:03d}"
        s.on_arrival(aid, names[i % len(names)], now=0.25 * i,
                     tenant=f"t{i % 4}", deadline=200.0 + 3.0 * i)
        s.on_progress(aid, 0.05 * i)
    return s


def _pair(kbs, n_shards, lane=None, posterior=False, **kw):
    """The reference's single-arena delta tick and the port's mesh (with
    ``lane`` balancing)."""
    jk, tk = kbs
    a = _filled(JSched, JRefresh, jk, None,
                posterior=JPosterior() if posterior else None, **kw)
    b = _filled(TSched, TRefresh, tk, n_shards, lane=lane,
                posterior=TPosterior() if posterior else None,
                device="cpu", **kw)
    return a, b


def _churn(s, kb, t):
    """Progress, a unit transition, a retirement and an admission — every
    dirty and rank-dirty pathway, landing on different shards."""
    s.on_progress("a003", 1.0)
    s.on_unit_start("a005", s.apps["a005"].current_unit, t)
    if "a007" in s._live:
        s.on_app_complete("a007")
    if f"new{int(t)}" not in s.apps:
        s.on_arrival(f"new{int(t)}", sorted(kb)[0], now=t)


def _obs(s, t):
    """The posterior feeds: the explicit observation calls and
    ``on_unit_finish`` (a transition, so the slot re-walks)."""
    u2 = s.apps["a002"].current_unit
    if u2 is not None:
        s.observe_unit_completion("a002", u2, 3.5 + 0.25 * t,
                                  wall_s=5.0 + 0.25 * t)
        s.observe_branch_taken("a002", u2, None)
    u6 = s.apps["a006"].current_unit
    if u6 is not None:
        s.on_unit_finish("a006", u6, {"dur": 2.0 + t}, t, u6)


def _tick(s, t):
    return s.refresh_tick(t, resample=True)


def _same_ranks(tag, ra, rb):
    ids = sorted(ra)
    assert sorted(rb) == ids, tag
    np.testing.assert_array_equal(np.asarray([ra[i] for i in ids]),
                                  np.asarray([rb[i] for i in ids]),
                                  err_msg=tag)


def _plan_key(p):
    return sorted(zip(p.app_ids, p.resource_keys, p.fire_at, p.p_reach))


def _same_store(a, b, rows=("d_probs", "d_edges"), triage=False,
                posterior=False):
    """Every live slot's arena rows (read through ``device_rows``), triage
    scalars and posterior rows, slot by slot."""
    qa, qb = a._qstate, b._qstate
    for aid, sa in qa.slot.items():
        sb = qb.slot[aid]
        for name in rows:
            np.testing.assert_array_equal(
                np.asarray(getattr(qa, name))[sa],
                getattr(qb, name)[int(qb.device_rows([sb])[0])].numpy(),
                err_msg=f"{aid} {name}")
        if triage:
            for name in ("sup", "opt", "mean"):
                assert getattr(qa, name)[sa] == getattr(qb, name)[sb], \
                    (aid, name)
        if posterior:
            np.testing.assert_array_equal(qa.posterior_rows([sa])[0],
                                          qb.posterior_rows([sb])[0],
                                          err_msg=aid)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("walker", ["pallas", "threefry"])
@pytest.mark.parametrize("policy", ["gittins", "hermes_ddl"])
def test_mesh_ticks_match_the_reference_delta_tick(kbs, n_shards, walker,
                                                   policy):
    """Churn ticks: ranks, histogram rows, triage scalars and the merged
    PrewarmPlan (hermes_ddl runs with prewarming)."""
    prewarm = policy == "hermes_ddl"
    a, b = _pair(kbs, n_shards, walker=walker, policy=policy,
                 prewarm=prewarm)
    for t in (10.0, 11.0, 12.0):
        _same_ranks(f"shards={n_shards} t={t}", _tick(a, t), _tick(b, t))
        if prewarm:
            assert _plan_key(a.take_prewarm_plan()) == \
                _plan_key(b.take_prewarm_plan())
        _churn(a, kbs[0], t)
        _churn(b, kbs[1], t)
    assert b.fused_spill == 0 and b._qstate.n_shards == n_shards
    rows = ("d_probs", "d_edges") + (
        ("a_hist", "a_lo", "a_span", "a_reach") if prewarm else ())
    _same_store(a, b, rows=rows, triage=prewarm)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("walker", ["pallas", "threefry"])
def test_mesh_posterior_ticks_match(kbs, n_shards, walker):
    """Online posterior learning: the same churn and observation streams
    give the same ranks and device posterior rows."""
    a, b = _pair(kbs, n_shards, walker=walker, posterior=True)
    for t in (10.0, 11.0, 12.0, 13.0):
        _same_ranks(f"shards={n_shards} t={t}", _tick(a, t), _tick(b, t))
        if t < 13.0:
            for s, kb in ((a, kbs[0]), (b, kbs[1])):
                _churn(s, kb, t)
                _obs(s, t)
    assert b._post_state.n_observations() == a._post_state.n_observations()
    assert b._qstate.posterior_rows([b._qstate.slot["a006"]])[0].sum() > 0
    _same_store(a, b, posterior=True)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("posterior", [False, True])
def test_mesh_repack_epoch(kbs, n_shards, posterior):
    """A shrink repack renumbers slots and moves device rows across shard
    blocks: every survivor keeps its rank, rows and posterior row without
    a re-walk, and the next ticks still match the reference."""
    a, b = _pair(kbs, n_shards, n_apps=96, posterior=posterior)
    for s in (a, b):
        if posterior:
            for aid in ("a090", "a091", "a092"):
                u = s.apps[aid].current_unit
                s.observe_unit_completion(aid, u, 7.5)
                s.observe_branch_taken(aid, u, None)
                s.on_requeue(aid, 9.0)
    _same_ranks("before", _tick(a, 10.0), r1 := _tick(b, 10.0))
    qs = b._qstate
    cap0, epoch0 = qs.capacity, qs.repack_epoch
    for s in (a, b):
        for i in range(88):
            s.on_app_complete(f"a{i:03d}")
    before = {k: v.refreshes for k, v in b.apps.items() if not v.done}
    b._mesh_ranks = None           # serve the ranks off the store's rows
    _same_ranks("after", _tick(a, 11.0), r2 := _tick(b, 11.0))
    assert qs.repack_epoch == epoch0 + 1 and qs.capacity < cap0
    assert a._qstate.capacity == qs.capacity
    for aid, n in before.items():
        assert r2[aid] == r1[aid] and b.apps[aid].refreshes == n, aid
    _same_store(a, b, posterior=posterior)
    _churn(a, kbs[0], 12.0)
    _churn(b, kbs[1], 12.0)
    _same_ranks("next", _tick(a, 12.0), _tick(b, 12.0))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_mesh_event_path_subset(kbs, n_shards):
    """An event-path subset tick re-walks the touched slot; the next full
    tick serves the post-event rank, as the reference's delta tick."""
    a, b = _pair(kbs, n_shards, policy="hermes_ddl", prewarm=True)
    for s in (a, b):
        _tick(s, 10.0)
        s.take_prewarm_plan()
    for s in (a, b):
        s.on_unit_start("a004", s.apps["a004"].current_unit, 10.5)
    _same_ranks("subset", a.priorities(10.5, app_ids=["a004", "a009"]),
                b.priorities(10.5, app_ids=["a004", "a009"]))
    assert _plan_key(a.take_prewarm_plan()) == \
        _plan_key(b.take_prewarm_plan())
    _same_ranks("full", _tick(a, 11.0), _tick(b, 11.0))


def _skewed(s):
    """Tick, then unit transitions on slots 0 mod 4 only: a walk-dirty set
    skewed at 2 and 8 shards, a quarter of the queue."""
    r1 = s.priorities(10.0)
    for i in range(0, 24, 4):
        aid = f"a{i:03d}"
        s.on_unit_start(aid, s.apps[aid].current_unit, 11.0)
    r2 = s.priorities(12.0)
    plan = s.take_prewarm_plan() if s.prewarm_enabled else None
    return r1, r2, plan


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("rik", [True, False])
def test_mesh_rank_in_kernel_and_composed(kbs, n_shards, rik):
    """The walk through K1's plain version (``rank_in_kernel``) and through
    K2's, on the skewed dirty set, against the reference's delta tick."""
    a, b = _pair(kbs, n_shards, rik=rik, policy="hermes_ddl", prewarm=True)
    (a1, a2, ap), (b1, b2, bp) = _skewed(a), _skewed(b)
    _same_ranks("tick1", a1, b1)
    _same_ranks("tick2", a2, b2)
    assert _plan_key(ap) == _plan_key(bp)
    _same_store(a, b, triage=True)


@pytest.mark.parametrize("n_shards", (2, 8))
@pytest.mark.parametrize("policy", ["gittins", "hermes_ddl"])
def test_mesh_lane_balance(kbs, monkeypatch, n_shards, policy):
    """``lane_balance=0.0`` walks the skewed set round-robin (the balanced
    tick must fire) and gives the reference delta tick's bits, the prewarm
    plan included (hermes_ddl runs with prewarming)."""
    fired = []
    orig = t_sched_mod.refresh_ranks_mesh

    def spy(*a, **kw):
        tick = orig(*a, **kw)
        fired.append(tick.balanced)
        return tick

    monkeypatch.setattr(t_sched_mod, "refresh_ranks_mesh", spy)
    prewarm = policy == "hermes_ddl"
    a, b = _pair(kbs, n_shards, lane=0.0, policy=policy, prewarm=prewarm)
    (a1, a2, ap), (b1, b2, bp) = _skewed(a), _skewed(b)
    assert any(fired), "the balanced tick never fired"
    _same_ranks("tick1", a1, b1)
    _same_ranks("tick2", a2, b2)
    if prewarm:
        assert _plan_key(ap) == _plan_key(bp)
    _same_store(a, b, rows=("d_probs", "d_edges") + (
        ("a_hist", "a_lo", "a_span", "a_reach") if prewarm else ()),
        triage=prewarm)


def test_balanced_tick_is_off_with_posterior(kbs, monkeypatch):
    ticks = []
    orig = t_sched_mod.refresh_ranks_mesh

    def spy(*a, **kw):
        ticks.append(orig(*a, **kw))
        return ticks[-1]

    monkeypatch.setattr(t_sched_mod, "refresh_ranks_mesh", spy)
    _skewed(_filled(TSched, TRefresh, kbs[1], 2, lane=0.0,
                    posterior=TPosterior(), device="cpu"))
    assert ticks and not any(t.balanced for t in ticks)


def test_mesh_schedule_and_guards():
    """The shard's compaction schedule is the reference's
    ``_mesh_schedule``; shard counts must be powers of two; the upload
    cache is bounded."""
    for args, want in (((16, 1, 1 << 20), ((16, 1),)),
                       ((0, 4, 1 << 20), ((0, 4),)),
                       ((16, 4, 1 << 20), ((12, 4), (28, 16), (44, 64))),
                       ((16, 4, 1024), ((16, 4),)),
                       ((8, 2, 1 << 20), ((8, 2), (16, 8)))):
        assert walk_schedule(*args) == want
    with pytest.raises(ValueError, match="power of two"):
        t_mesh.RefreshMesh(3, device="cpu")
    mesh = t_mesh.RefreshMesh(16, device="cpu")      # no device count
    for i in range(t_mesh.RefreshMesh._REP_CAP + 20):
        mesh.replicated(np.full(4, i, np.float32))
    assert len(mesh._rep) <= t_mesh.RefreshMesh._REP_CAP


def test_mesh_runs_on_the_card_unless_asked_for_the_cpu(kbs):
    """``RefreshMesh`` defaults to ``cuda`` (an error without a card, never
    a silent CPU), and a tick refuses a store laid out for another shard
    count or held on another device."""
    if torch.cuda.is_available():
        assert t_mesh.RefreshMesh(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_mesh.RefreshMesh(2)
    tp = t_pack(kbs[1], T_IN, T_OUT, device="cpu")
    qs = t_arena.QueueState(tp, n_shards=2)
    with pytest.raises(ValueError, match="laid out for 2 shards"):
        t_mesh.refresh_ranks_mesh(tp, qs, 0, walked=np.zeros(0, np.int64),
                                  mesh=t_mesh.RefreshMesh(4, device="cpu"))
    with pytest.raises(ValueError, match="serves 1-shard arenas"):
        from repro_torch.core.refresh_pipeline import refresh_ranks_delta
        refresh_ranks_delta(tp, qs, 0, walked=np.zeros(0, np.int64))


# ------------------------------------------- (c) the reference's real mesh

_SUBPROCESS = """
import json, numpy as np
from repro.apps.suite import T_IN, T_OUT, build_knowledge_base as j_kb
from repro.core.refresh_config import RefreshConfig as JRC
from repro.core.scheduler import HermesScheduler as JS
from repro_torch.apps.suite import build_knowledge_base as t_kb
from repro_torch.core.refresh_config import RefreshConfig as TRC
from repro_torch.core.scheduler import HermesScheduler as TS
import jax
assert jax.device_count() == 8

def filled(S, RC, kb, mesh, lane, rik, **kw):
    s = S(kb, policy="hermes_ddl", t_in=T_IN, t_out=T_OUT, mc_walkers=32,
          seed=11, prewarm=True, refresh=RC(mode="fused_delta",
          mesh_shards=mesh, lane_balance=lane, rank_in_kernel=rik), **kw)
    names = sorted(kb)
    for i in range(24):
        aid = f"a{i:03d}"
        s.on_arrival(aid, names[i % len(names)], now=0.25 * i,
                     tenant=f"t{i % 4}", deadline=200.0 + 3.0 * i)
        s.on_progress(aid, 0.05 * i)
    return s

def run(s):
    out = [s.priorities(10.0)]
    for i in range(0, 24, 4):
        aid = f"a{i:03d}"
        s.on_unit_start(aid, s.apps[aid].current_unit, 11.0)
    out.append(s.priorities(12.0))
    p = s.take_prewarm_plan()
    out.append(sorted(zip(p.app_ids, p.resource_keys,
                          map(float, p.fire_at), map(float, p.p_reach))))
    qs = s._qstate
    out.append({a: [float(qs.sup[i]), float(qs.opt[i]), float(qs.mean[i])]
                for a, i in qs.slot.items()})
    return out

jk, tk = j_kb(n_trials=60, seed=3), t_kb(n_trials=60, seed=3)
res = {}
for lane in (None, 0.0):
    for rik in (None, False):
        res[f"{lane}/{rik}"] = {
            "ref_mesh": run(filled(JS, JRC, jk, 8, lane, rik)),
            "ref_delta": run(filled(JS, JRC, jk, None, None, rik)),
            "port": run(filled(TS, TRC, tk, 8, lane, rik, device="cpu"))}
print(json.dumps(res))
"""


def test_port_against_the_reference_shard_map_mesh_at_8_devices():
    """The port's 8-shard tick against the reference's ``shard_map`` over
    8 host devices, skewed dirty set, K1's and K2's plain versions, with
    and without lane balancing.  Unbalanced, the two meshes agree bitwise.
    Balanced, the port keeps the single-arena delta tick's bits, which is
    its contract; the reference's balanced tick ranks a row of this
    scenario an ulp off its own delta tick (ROADMAP §3), so there the
    port is held to the reference's mesh within 1e-6 relative."""
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_SUBPROCESS)],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res) == 4
    for key, r in res.items():
        assert r["port"] == r["ref_delta"], key
        if key.startswith("None/"):
            assert r["port"] == r["ref_mesh"], key
        for tick in (0, 1):
            ids = sorted(r["port"][tick])
            assert sorted(r["ref_mesh"][tick]) == ids
            np.testing.assert_allclose(
                [r["port"][tick][i] for i in ids],
                [r["ref_mesh"][tick][i] for i in ids], rtol=1e-6,
                err_msg=key)
        assert r["port"][3] == r["ref_mesh"][3], key       # triage


# --------------------------------------------------------------- (d) run_sim

def test_run_sim_at_two_shards_matches_the_reference_default():
    """``SimConfig(refresh=RefreshConfig(mesh_shards=2))`` on a small trace:
    the reference's default run's completion order and ACTs."""
    from repro.apps.workload import make_workload as j_workload
    from repro.serving.simulator import SimConfig as JConfig
    from repro.serving.simulator import run_sim as j_run
    from repro_torch.apps.workload import make_workload as t_workload
    from repro_torch.serving.simulator import SimConfig as TConfig
    from repro_torch.serving.simulator import run_sim as t_run
    kw = dict(seed=29, t_in=T_IN, t_out=T_OUT)
    cfg = dict(seed=5, n_llm_slots=8, mc_walkers=32)
    j = j_run(j_kb(n_trials=40, seed=3), j_workload(30, 120.0, **kw),
              JConfig(**cfg))
    t = t_run(t_kb(n_trials=40, seed=3), t_workload(30, 120.0, **kw),
              TConfig(refresh=TRefresh(mesh_shards=2), device="cpu", **cfg))
    assert len(t.completion_order) == 30
    assert t.completion_order == j.completion_order
    ids = j.completion_order
    np.testing.assert_array_equal([t.acts[i] for i in ids],
                                  [j.acts[i] for i in ids])
    assert t.policy_calls == j.policy_calls
    assert t.prewarm_stats == j.prewarm_stats
