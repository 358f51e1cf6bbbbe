"""What each rank of a spawned world runs for ``test_torch_procs.py``.

Every function here runs inside one rank of a ``launch.procs.spawn``
world on the CPU (gloo) and imports only the port.  A rank never raises
on a mismatch: it records it and goes on, so every rank reaches every
collective and a fault cannot hang the world; the parent test asserts on
what the ranks return.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.apps.suite import T_IN, T_OUT
from repro_torch.apps.suite import build_knowledge_base
from repro_torch.core import scheduler as sched_mod
from repro_torch.core.posterior import PosteriorConfig
from repro_torch.core.refresh_config import RefreshConfig
from repro_torch.core.scheduler import HermesScheduler

MC = 32


class Checks:
    """Mismatches found by this rank, as readable lines."""

    def __init__(self):
        self.fails: List[str] = []

    def true(self, tag: str, ok: bool) -> None:
        if not ok:
            self.fails.append(tag)

    def same_arrays(self, tag: str, a, b) -> None:
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a, b):
            self.fails.append(f"{tag}: differs")

    def same_ranks(self, tag: str, ra: Dict[str, float],
                   rb: Dict[str, float]) -> None:
        if sorted(ra) != sorted(rb):
            self.fails.append(f"{tag}: app sets differ")
            return
        ids = sorted(ra)
        self.same_arrays(tag, [ra[i] for i in ids], [rb[i] for i in ids])


# ------------------------------------------------------------ the mesh tick

def _filled(kb, mesh=None, policy="gittins", prewarm=False, walker="pallas",
            n_apps=24, posterior=None, rik=None, lane=None):
    s = HermesScheduler(kb, policy=policy, t_in=T_IN, t_out=T_OUT,
                        mc_walkers=MC, seed=11, prewarm=prewarm,
                        posterior=posterior, device="cpu",
                        refresh=RefreshConfig(
                            mode="fused_delta", walker=walker,
                            mesh_shards=mesh, rank_in_kernel=rik,
                            lane_balance=lane))
    names = sorted(kb)
    for i in range(n_apps):
        aid = f"a{i:03d}"
        s.on_arrival(aid, names[i % len(names)], now=0.25 * i,
                     tenant=f"t{i % 4}", deadline=200.0 + 3.0 * i)
        s.on_progress(aid, 0.05 * i)
    return s


def _churn(s, kb, t):
    s.on_progress("a003", 1.0)
    s.on_unit_start("a005", s.apps["a005"].current_unit, t)
    if "a007" in s._live:
        s.on_app_complete("a007")
    if f"new{int(t)}" not in s.apps:
        s.on_arrival(f"new{int(t)}", sorted(kb)[0], now=t)


def _obs(s, t):
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


def _plan_key(p):
    return sorted(zip(p.app_ids, p.resource_keys, map(float, p.fire_at),
                      map(float, p.p_reach)))


def _same_store(chk, tag, a, b, rows=("d_probs", "d_edges"),
                triage=False, posterior=False):
    """Every live slot's arena rows (``b``'s blocks gathered from every
    rank: a collective), triage scalars and posterior rows."""
    qa, qb = a._qstate, b._qstate
    for name in rows:
        full_a = getattr(qa, name)
        full_b = qb.arena_rows(name)
        for aid, sa in qa.slot.items():
            sb = qb.slot[aid]
            chk.same_arrays(f"{tag} {aid} {name}", full_a[sa],
                            full_b[int(qb.device_rows([sb])[0])])
    if triage:
        for aid, sa in qa.slot.items():
            sb = qb.slot[aid]
            for name in ("sup", "opt", "mean"):
                chk.true(f"{tag} {aid} {name}",
                         getattr(qa, name)[sa] == getattr(qb, name)[sb])
    if posterior:
        ids = sorted(qa.slot)
        chk.same_arrays(f"{tag} posterior rows",
                        qa.posterior_rows([qa.slot[i] for i in ids]),
                        qb.posterior_rows([qb.slot[i] for i in ids]))


def _skewed(s, n_apps):
    """Tick, then unit transitions on slots 0 mod 4 only (a walk-dirty set
    skewed at every rank count), tick again."""
    r1 = s.priorities(10.0)
    for i in range(0, n_apps, 4):
        aid = f"a{i:03d}"
        s.on_unit_start(aid, s.apps[aid].current_unit, 11.0)
    r2 = s.priorities(12.0)
    plan = s.take_prewarm_plan() if s.prewarm_enabled else None
    return r1, r2, plan


APPS = 16


def mesh_scenarios(chk: Checks, n: int, kb, full: bool = True) -> None:
    """The process mesh tick at ``n`` ranks against the delta tick on the
    same rank, bit for bit (ranks, prewarm plans, triage scalars, arena
    and posterior rows): uniform churn with prewarming, the skewed dirty
    set through K1's plain version, the skewed set lane-balanced through
    K2's (unless not ``full``), and a repack epoch with posterior
    learning."""
    if full:
        _churn_and_skew(chk, n, kb)
    _repack(chk, n, kb)


def _churn_and_skew(chk: Checks, n: int, kb) -> None:
    tag = "churn"
    a = _filled(kb, None, "hermes_ddl", True, n_apps=APPS)
    b = _filled(kb, n, "hermes_ddl", True, n_apps=APPS)
    for t in (10.0, 11.0, 12.0):
        chk.same_ranks(f"{tag} t={t}", _tick(a, t), _tick(b, t))
        chk.true(f"{tag} plan t={t}", _plan_key(a.take_prewarm_plan())
                 == _plan_key(b.take_prewarm_plan()))
        _churn(a, kb, t)
        _churn(b, kb, t)
    arrivals = ("d_probs", "d_edges", "a_hist", "a_lo", "a_span", "a_reach")
    _same_store(chk, tag, a, b, rows=arrivals, triage=True)
    for rik, lane in ((None, None), (False, 0.0)):
        tag = f"skewed rik={rik} lane={lane}"
        a = _filled(kb, None, "hermes_ddl", True, rik=rik, n_apps=APPS)
        b = _filled(kb, n, "hermes_ddl", True, rik=rik, lane=lane,
                    n_apps=APPS)
        (a1, a2, ap), (b1, b2, bp) = _skewed(a, APPS), _skewed(b, APPS)
        chk.same_ranks(f"{tag} tick1", a1, b1)
        chk.same_ranks(f"{tag} tick2", a2, b2)
        chk.true(f"{tag} plan", _plan_key(ap) == _plan_key(bp))
        _same_store(chk, tag, a, b, rows=arrivals, triage=True)


def _repack(chk: Checks, n: int, kb) -> None:
    """A repack epoch with posterior rows: after most apps complete, both
    arenas shrink to 16 slots at a tick boundary, which renumbers the
    survivors and moves their rows between the ranks' blocks."""
    tag = "repack"
    a = _filled(kb, None, n_apps=APPS, posterior=PosteriorConfig())
    b = _filled(kb, n, n_apps=APPS, posterior=PosteriorConfig())
    for s in (a, b):
        for aid in ("a013", "a014"):
            u = s.apps[aid].current_unit
            s.observe_unit_completion(aid, u, 7.5)
            s.observe_branch_taken(aid, u, None)
            s.on_requeue(aid, 9.0)
    chk.same_ranks(f"{tag} before", _tick(a, 10.0), _tick(b, 10.0))
    epoch0 = b._qstate.repack_epoch
    for s in (a, b):
        for i in range(0, APPS - 4, 2):
            s.on_app_complete(f"a{i:03d}")
        s._qstate.repack(16)
    b._mesh_ranks = None
    chk.true(f"{tag}: no repack", b._qstate.repack_epoch == epoch0 + 1
             and b._qstate.capacity == 16)
    _same_store(chk, tag, a, b, posterior=True)
    chk.same_ranks(f"{tag} after", _tick(a, 11.0), _tick(b, 11.0))
    for s in (a, b):
        _churn(s, kb, 12.0)
        _obs(s, 12.0)
    chk.same_ranks(f"{tag} next", _tick(a, 12.0), _tick(b, 12.0))
    _same_store(chk, f"{tag} next", a, b, posterior=True)


def reference_scenario(n: int, kb) -> dict:
    """``tests/test_torch_mesh.py``'s (c) scenario on a process mesh of
    ``n`` ranks: the outputs the parent holds to the reference's
    ``shard_map`` mesh and delta tick."""
    out = {}
    for lane in (None, 0.0):
        for rik in (None, False):
            s = _filled(kb, n, "hermes_ddl", True, rik=rik, lane=lane)
            res = [s.priorities(10.0)]
            for i in range(0, 24, 4):
                aid = f"a{i:03d}"
                s.on_unit_start(aid, s.apps[aid].current_unit, 11.0)
            res.append(s.priorities(12.0))
            p = s.take_prewarm_plan()
            res.append(sorted(zip(p.app_ids, p.resource_keys,
                                  map(float, p.fire_at),
                                  map(float, p.p_reach))))
            qs = s._qstate
            res.append({a: [float(qs.sup[i]), float(qs.opt[i]),
                            float(qs.mean[i])] for a, i in qs.slot.items()})
            out[f"{lane}/{rik}"] = res
    return out


# ----------------------------------------------------------------- run_sim

def run_sim_mesh(n: int) -> dict:
    """``run_sim`` at ``mesh_shards=n`` on this rank (every rank runs it)."""
    import torch.distributed as dist
    from repro_torch.apps.workload import make_workload
    from repro_torch.serving.simulator import SimConfig, run_sim
    res = run_sim(build_knowledge_base(n_trials=40, seed=3),
                  make_workload(30, 120.0, seed=29, t_in=T_IN, t_out=T_OUT),
                  SimConfig(refresh=RefreshConfig(mesh_shards=n),
                            device="cpu", seed=5, n_llm_slots=8,
                            mc_walkers=32, process_group=dist.group.WORLD))
    return {"order": list(res.completion_order),
            "acts": [float(res.acts[i]) for i in res.completion_order],
            "policy_calls": int(res.policy_calls),
            "prewarm_stats": res.prewarm_stats}


# --------------------------------------------------------------------- EP

def _layer(inputs, tag):
    from repro_torch.models import moe as X
    from repro_torch.testing import tiny_config
    ne, cf = tag.split("/")
    cfg = tiny_config("qwen2-moe-a2.7b", capacity_factor=float(cf),
                      num_experts=int(ne), dtype="float32", moe_impl="ep")
    full = {k[len(tag) + 3:]: torch.as_tensor(v) for k, v in inputs.items()
            if k.startswith(tag + "/p/")}
    return cfg, full, torch.as_tensor(inputs[tag + "/x"])


def ep_checks(chk: Checks, shapes, inputs, tags) -> dict:
    """The EP layer over each process mesh of ``shapes`` against the
    one-process body on this rank, bit for bit, at every ``tags`` case;
    then the tiny MoE model's share and EP prefill.  Returns this rank's
    layer outputs (its data shard) by ``tag/shape``."""
    from repro_torch.distributed.sharding import (ShardCtx, expert_rows,
                                                  shard_params,
                                                  use_shard_ctx)
    from repro_torch.launch.mesh import init_process_mesh, make_mesh
    from repro_torch.models import moe as X
    from repro_torch.models.layers import padded_experts
    from repro_torch.models.model import build_model
    from repro_torch.testing import tiny_config
    out = {}
    for shape in shapes:
        pm = init_process_mesh(shape, ("data", "model"), device="cpu")
        ctx = ShardCtx(pm)
        for tag in tags:
            cfg, full, x = _layer(inputs, tag)
            one = X.MoE(cfg, torch.float32, "cpu")
            one.load_state_dict(full)
            with use_shard_ctx(ShardCtx(make_mesh(shape,
                                                  ("data", "model")))):
                want = X.moe_apply(one, x, cfg)
            rows = expert_rows(pm, padded_experts(cfg.num_experts))
            mine = X.MoE(cfg, torch.float32, "cpu", experts=rows)
            share = shard_params({f"moe.{k}": v for k, v in full.items()},
                                 pm)
            mine.load_state_dict({k[4:]: v for k, v in share.items()})
            bl = x.shape[0] // shape[0]
            d = ctx.data_shard
            with use_shard_ctx(ctx):
                got = X.moe_apply(mine, x[d * bl:(d + 1) * bl], cfg)
            chk.same_arrays(f"EP {tag} {shape}", got,
                            want[d * bl:(d + 1) * bl])
            out[f"{tag}/{shape}"] = got.numpy()
        # the tiny model: the rank's share as drawn, and its EP prefill
        cfg = tiny_config("qwen2-moe-a2.7b", dtype="float32",
                          moe_impl="ep")
        whole = build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(7))
        share = build_model(cfg, "cpu", mesh=pm).init(
            torch.Generator().manual_seed(7))
        cut = shard_params(whole.params(), pm)
        for name, t in share.params().items():
            chk.same_arrays(f"share {shape} {name}", t, cut[name])
        tokens = torch.as_tensor(
            np.random.default_rng(3).integers(1, 256, (4, 16)))
        with use_shard_ctx(ShardCtx(make_mesh(shape, ("data", "model")))):
            _, want = whole.prefill(tokens)
        bl = 4 // shape[0]
        d = ctx.data_shard
        with use_shard_ctx(ctx):
            _, got = share.prefill(tokens[d * bl:(d + 1) * bl])
        chk.same_arrays(f"EP prefill {shape}", got, want[d * bl:(d + 1) * bl])
    return out


# ------------------------------------------------------------------ a rank

def run_world(n: int, ep_shapes, ep_inputs, ep_tags) -> dict:
    """Everything a rank of an ``n``-rank world checks (see
    ``test_torch_procs.py``)."""
    import time

    import torch.distributed as dist
    from repro_torch.core.refresh_mesh import RefreshMesh
    from repro_torch.launch.mesh import init_process_mesh
    t0 = time.perf_counter()
    mesh = init_process_mesh((n,), ("shard",), device="cpu")
    chk = Checks()
    # the guard: a mesh whose shard count is not the group's size
    try:
        RefreshMesh(2 * n, device="cpu", group=mesh.group("shard"))
        chk.fails.append("RefreshMesh(2n) did not raise")
    except ValueError:
        pass
    # every rank's per-tick walked and ranked slots, recorded
    ticks = []
    orig = sched_mod.refresh_ranks_mesh

    def spy(*a, **kw):
        tick = orig(*a, **kw)
        ticks.append((tick.walked.tolist(), tick.ranked.tolist(),
                      bool(tick.balanced)))
        return tick

    sched_mod.refresh_ranks_mesh = spy
    kb = build_knowledge_base(n_trials=60, seed=3)
    try:
        # at 8 ranks the reference's scenario covers the uniform, skewed,
        # balanced and K2 ticks (held in the parent)
        mesh_scenarios(chk, n, kb, full=n != 8)
        t1 = time.perf_counter()
        ref = reference_scenario(n, kb) if n == 8 else None
        sim = run_sim_mesh(n) if n == 4 else None
    finally:
        sched_mod.refresh_ranks_mesh = orig
    t2 = time.perf_counter()
    ep = ep_checks(chk, ep_shapes, ep_inputs, ep_tags) if ep_shapes else {}
    dist.barrier()
    seconds = {"mesh": t1 - t0, "reference/run_sim": t2 - t1,
               "ep": time.perf_counter() - t2}
    return {"rank": mesh.rank, "fails": chk.fails, "ticks": ticks,
            "reference": ref, "sim": sim, "ep": ep, "seconds": seconds}
