"""The reference's deprecated pieces in the port: the heap event engine,
the ``core/refresh`` facade, and the mesh's device-count guard.

(a) ``HeapEventQueue`` and ``HeapWaitQueue`` call for call against the
reference's (random pushes, drains, pops, discards and rebuilds), and the
``make_event_queue`` / ``make_wait_queue`` factories and ``ENGINES``.
(b) ``run_sim`` with ``SimConfig(engine="heap")`` against the reference's
heap run and the port's calendar run, on ``tests/test_sim_engine.py``'s
cases (open arrivals under five policies, simultaneous bursts, a mid-run
repack), at sizes cut to keep the file short: completion order, ACTs,
makespan, refresh calls, cache and stall statistics, deadline outcomes,
all exactly.
(c) ``SimConfig(engine="heap")`` warns as the reference does; the default
does not; an unknown engine raises.
(d) ``repro_torch.core.refresh`` re-exports the reference's ``__all__``
from the port's homes with a ``DeprecationWarning`` naming the home, and
lists the reference's names.
(e) Under a process group (one gloo process here), ``RefreshMesh`` and
``QueueState`` refuse a shard count that is not the group's size.
"""
import warnings

import numpy as np
import pytest
import torch

import repro.core.refresh as j_facade
from repro.apps.suite import T_IN, T_OUT
from repro.apps.suite import build_knowledge_base as j_kb
from repro.apps.workload import make_open_workload as j_open
from repro.apps.workload import make_workload as j_workload
from repro.serving import events as J
from repro.serving.simulator import ClusterSim as JSim
from repro.serving.simulator import SimConfig as JConfig
from repro_torch.apps.suite import build_knowledge_base as t_kb
from repro_torch.apps.workload import make_open_workload as t_open
from repro_torch.apps.workload import make_workload as t_workload
from repro_torch.serving import events as T
from repro_torch.serving.simulator import ClusterSim as TSim
from repro_torch.serving.simulator import SimConfig as TConfig


@pytest.fixture(scope="module")
def kbs():
    return j_kb(n_trials=40, seed=3), t_kb(n_trials=40, seed=3)


# ------------------------------------------------------------ (a) queues

@pytest.mark.parametrize("seed", range(4))
def test_heap_event_queue_is_the_reference_call_for_call(seed):
    """Random pushes (ties common, pushes behind the drained time's
    bucket) and drains: the same batches as the reference's heap and as
    the port's calendar queue."""
    rng = np.random.default_rng(seed)
    j, t = J.HeapEventQueue(), T.HeapEventQueue()
    c = T.CalendarEventQueue(bucket_s=1.0)
    uid = 0
    for _ in range(int(rng.integers(1, 5))):
        at = float(rng.integers(0, 16)) * 0.25
        for q in (j, t, c):
            q.push(at, "e", uid)
        uid += 1
    for _ in range(60):
        assert len(j) == len(t) == len(c)
        if not len(j):
            break
        got = t.next_batch()
        assert got == j.next_batch() == c.next_batch()
        for _ in range(int(rng.integers(0, 4))):
            dt = float(rng.choice([0.0, 0.25, 0.5, 1.0, 3.25, 7.0]))
            for q in (j, t, c):
                q.push(got[0] + dt, "e", uid)
            uid += 1
    while len(j):
        assert t.next_batch() == j.next_batch()
    assert len(t) == 0


class _Task:
    __slots__ = ("submitted", "task_id", "ai", "app_id")

    def __init__(self, submitted, task_id, ai):
        self.submitted, self.task_id, self.ai = submitted, task_id, ai
        self.app_id = f"app{ai}"


@pytest.mark.parametrize("seed", range(4))
def test_heap_wait_queue_is_the_reference_call_for_call(seed):
    """Random pushes, peeks, pops, discards and rank rebuilds: the same
    keys and tasks as the reference's heap queue, and the same pops as the
    port's array queue."""
    rng = np.random.default_rng(seed)
    n_apps = int(rng.integers(2, 8))
    ranks = rng.uniform(0, 10, n_apps)
    j, t, a = J.HeapWaitQueue(), T.HeapWaitQueue(), T.ArrayWaitQueue()
    uid = 0
    for _ in range(int(rng.integers(20, 80))):
        op = rng.uniform()
        if op < 0.5:
            ai = int(rng.integers(n_apps))
            task = _Task(float(rng.integers(0, 8)) * 0.5, uid, ai)
            uid += 1
            key = (float(ranks[ai]), task.submitted, task.task_id)
            for q in (j, t, a):
                q.push(key, task, ai)
        elif op < 0.8:
            assert len(j) == len(t) == len(a)
            if len(j):
                assert t.peek_key() == j.peek_key()
                got = t.pop()
                assert got is j.pop() and got is a.pop()
        elif op < 0.88:
            gone = {f"app{int(rng.integers(n_apps))}"}
            got = t.discard(gone)
            assert [x.task_id for x in got] == \
                [x.task_id for x in j.discard(gone)]
            assert sorted(x.task_id for x in got) == \
                sorted(x.task_id for x in a.discard(gone))
        else:
            ranks = rng.uniform(0, 10, n_apps)
            key_fn = lambda x: (float(ranks[x.ai]), x.submitted,  # noqa
                                x.task_id)
            j.rebuild(key_fn)
            t.rebuild(key_fn)
            a.rebuild(ranks)
    while len(j):
        got = t.pop()
        assert got is j.pop() and got is a.pop()
    assert len(t) == 0


def test_engine_factories():
    assert T.ENGINES == J.ENGINES == ("heap", "calendar")
    assert set(T.__all__) == set(J.__all__)
    assert isinstance(T.make_event_queue("heap"), T.HeapEventQueue)
    assert isinstance(T.make_event_queue("calendar", bucket_s=2.0),
                      T.CalendarEventQueue)
    assert isinstance(T.make_wait_queue("heap"), T.HeapWaitQueue)
    assert isinstance(T.make_wait_queue("calendar"), T.ArrayWaitQueue)
    for make in (T.make_event_queue, T.make_wait_queue):
        with pytest.raises(ValueError, match="unknown sim engine"):
            make("wheel-of-fortune")


# ------------------------------------------------------------ (b) run_sim

def _heap(config, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return config(engine="heap", **kw)


def _same(a, b):
    assert a.completion_order == b.completion_order
    assert a.acts == b.acts
    assert a.makespan == b.makespan
    assert a.policy_calls == b.policy_calls
    assert a.cache_stats == b.cache_stats
    assert a.stall_stats == b.stall_stats
    assert a.dsr == b.dsr


def _three(kbs, j_insts, t_insts, **kw):
    """The reference's heap run, the port's heap run and the port's
    calendar run of one trace (the simulators, for their arenas)."""
    jk, tk = kbs
    sims = [JSim(jk, _heap(JConfig, **kw)),
            TSim(tk, _heap(TConfig, device="cpu", **kw)),
            TSim(tk, TConfig(device="cpu", **kw))]
    return sims, [sims[0].run(j_insts), sims[1].run(t_insts),
                  sims[2].run(t_insts)]


@pytest.mark.parametrize("seed, policy", [
    (5, "gittins"), (11, "fcfs_app"), (20, "vtc"), (13, "hermes_ddl"),
    (41, "fcfs_req")])
def test_heap_run_sim_on_open_arrivals(kbs, seed, policy):
    kw = dict(t_in=T_IN, t_out=T_OUT, rate_per_s=0.5, process="gamma",
              cv=2.5, seed=seed, with_deadlines=True, max_apps=16)
    ji, ti = j_open(60.0, **kw), t_open(60.0, **kw)
    assert ji and len(ji) == len(ti)
    _, (j, t, c) = _three(kbs, ji, ti, policy=policy, mc_walkers=16,
                          seed=seed % 7, n_llm_slots=4, n_docker_slots=6,
                          n_dnn_slots=2)
    assert len(t.completion_order) == len(ji)
    _same(t, j)
    _same(t, c)


def test_heap_run_sim_on_simultaneous_bursts(kbs):
    kw = dict(seed=11, t_in=T_IN, t_out=T_OUT, with_deadlines=True)
    ji, ti = j_workload(20, 6.0, **kw), t_workload(20, 6.0, **kw)
    for i in ji + ti:
        i.arrival = float(int(i.arrival))       # exact ties
    _, (j, t, c) = _three(kbs, ji, ti, policy="gittins", mc_walkers=16,
                          seed=3, n_llm_slots=4)
    _same(t, j)
    _same(t, c)


def test_heap_run_sim_across_a_midrun_repack(kbs, monkeypatch):
    """The arenas' repack floor lowered from 64 to 16 slots in both
    packages alike, so a 20-app trace shrink-repacks mid-run (twice)."""
    from repro.core import arena as j_arena
    from repro_torch.core import arena as t_arena
    for mod in (j_arena, t_arena):
        orig = mod.QueueState.maybe_repack
        monkeypatch.setattr(
            mod.QueueState, "maybe_repack",
            lambda self, occupancy_threshold=0.25, min_capacity=16,
            _orig=orig: _orig(self, occupancy_threshold, min_capacity))
    kw = dict(seed=9, t_in=T_IN, t_out=T_OUT)
    ji, ti = j_workload(20, 10.0, **kw), t_workload(20, 10.0, **kw)
    sims, (j, t, c) = _three(kbs, ji, ti, mc_walkers=16, seed=2,
                             n_llm_slots=8)
    epochs = [s.sched._qstate.repack_epoch for s in sims]
    assert epochs[0] >= 1 and epochs[0] == epochs[1] == epochs[2]
    _same(t, j)
    _same(t, c)


# ------------------------------------------------------------ (c) warning

def test_heap_engine_warns_as_the_reference():
    for config in (JConfig, TConfig):
        with pytest.warns(DeprecationWarning, match="calendar") as rec:
            cfg = config(engine="heap")
        assert cfg.engine == "heap"
        assert rec[0].filename == __file__     # points at the caller
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            assert config().engine == "calendar"
        with pytest.raises(ValueError, match="unknown sim engine"):
            config(engine="wheel")


# ------------------------------------------------------------ (d) facade

def test_refresh_facade_lists_the_references_names():
    import repro_torch.core.refresh as t_facade
    assert t_facade.__all__ == j_facade.__all__
    assert dir(t_facade) == dir(j_facade)
    # the reference's private re-exports the port has under those names
    assert set(t_facade._HOME_OF) == {
        n for n in j_facade._HOME_OF
        if n not in ("_arrival_hists", "_delta_pipeline", "_fused_pipeline",
                     "_prewarm_triggers", "_walk_total")}


@pytest.mark.parametrize("name", j_facade.__all__)
def test_refresh_facade_reexports_with_a_warning(name):
    import importlib

    import repro_torch.core.refresh as t_facade
    home = {"QueueState": "arena", "build_queue_state": "arena",
            "MeshTick": "refresh_mesh", "RefreshMesh": "refresh_mesh",
            "refresh_ranks_mesh": "refresh_mesh"}.get(name,
                                                      "refresh_pipeline")
    with pytest.warns(DeprecationWarning,
                      match=f"import {name} from repro_torch.core.{home}"):
        got = getattr(t_facade, name)
    assert got is getattr(importlib.import_module(
        f"repro_torch.core.{home}"), name)
    with pytest.warns(DeprecationWarning, match=f"repro.core.{home}"):
        getattr(j_facade, name)                 # the reference's, alike
    with pytest.raises(AttributeError, match="no attribute"):
        t_facade.refresh_ranks_looped


# ------------------------------------------------------------ (e) guard

def test_mesh_refuses_a_group_of_another_size(kbs, tmp_path):
    """One gloo process: a 2-shard mesh or arena over its group is refused
    (the reference's device-count guard), a 1-shard one takes the group,
    and a mesh given no group stays in this process whatever group is
    initialised."""
    import torch.distributed as dist
    from repro_torch.core.arena import QueueState
    from repro_torch.core.pdgraph import pack_graphs
    from repro_torch.core.refresh_mesh import RefreshMesh
    from repro_torch.core.scheduler import HermesScheduler
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="2 shards but its process "
                                             "group has 1 rank"):
            RefreshMesh(2, device="cpu", group=dist.group.WORLD)
        with pytest.raises(ValueError, match="process_group requires"):
            HermesScheduler(kbs[1], device="cpu",
                            process_group=dist.group.WORLD)
        assert RefreshMesh(2, device="cpu").group is None
        mesh = RefreshMesh(1, device="cpu", group=dist.group.WORLD)
        assert mesh.group is not None and mesh.rank == 0
        packed = pack_graphs(kbs[1], T_IN, T_OUT, device="cpu")
        with pytest.raises(ValueError, match="cannot hold 2 shards"):
            QueueState(packed, n_shards=2, group=mesh.group)
        qs = QueueState(packed, n_shards=1, group=mesh.group)
        qs.ensure_result_rows(4)
        assert qs.local_shard == 0 and qs.d_probs.shape[0] == qs.capacity
    finally:
        dist.destroy_process_group()
    assert RefreshMesh(2, device="cpu").group is None
    assert torch.zeros(1).device.type == "cpu"
