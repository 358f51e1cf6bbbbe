"""The port's overload, fault and policy paths against the JAX package.

``run_sim`` in both packages (the port on the CPU) on the reference's own
scenarios (``tests/test_overload.py``, ``tests/test_fault_tolerance.py``):
admission and shedding, degradation, an SLO mix, a crash, a correlated
outage, a slow backend, the diurnal workload, every policy, the prewarm
modes and the refresh variants.  Each arm must give the same completion
order, ACTs within 1e-6 relative, and the same shed set, SLO classes,
units done, fault, degradation and prewarm statistics and refresh calls.
The pure-Python pieces (admission ledger, degradation latch, backoff,
heartbeat reaper, failure injector, straggler watchdog, pools) are
compared call by call.
"""
import numpy as np
import pytest

from repro.apps import workload as j_wl
from repro.apps.suite import T_IN, T_OUT
from repro.apps.suite import build_knowledge_base as j_kb
from repro.core import admission as j_adm
from repro.core.refresh_config import RefreshConfig as JRefresh
from repro.runtime import fault_tolerance as j_ft
from repro.serving import backends as j_be
from repro.serving.simulator import SimConfig as JConfig
from repro.serving.simulator import run_sim as j_run
from repro_torch.apps import workload as t_wl
from repro_torch.apps.suite import build_knowledge_base as t_kb
from repro_torch.core import admission as t_adm
from repro_torch.core.refresh_config import RefreshConfig as TRefresh
from repro_torch.runtime import fault_tolerance as t_ft
from repro_torch.serving import backends as t_be
from repro_torch.serving.simulator import SimConfig as TConfig
from repro_torch.serving.simulator import run_sim as t_run

PKG = {"j": (j_wl, j_adm, j_ft, j_be, JRefresh),
       "t": (t_wl, t_adm, t_ft, t_be, TRefresh)}


@pytest.fixture(scope="module")
def kbs():
    return j_kb(n_trials=120, seed=3), t_kb(n_trials=120, seed=3)


def _small(wl):
    return wl.make_workload(24, 60.0, seed=11, t_in=T_IN, t_out=T_OUT)


def _crowd(wl, **kw):
    base = dict(t_in=T_IN, t_out=T_OUT, base_load=0.8, spike_mult=8.0,
                spike_start=30.0, spike_dur=60.0, n_service_slots=8,
                with_deadlines=True, seed=2)
    base.update(kw)
    return wl.make_flash_crowd_workload(120.0, **base)


def _slo_mix(wl):
    insts = wl.assign_slo_mix(
        _crowd(wl, crowd_slo="best_effort"),
        {"gold": 0.2, "standard": 0.5, "best_effort": 0.3}, seed=9)
    for i in insts:
        if i.tenant == "crowd":
            i.slo = "best_effort"
    return insts


def _diurnal(wl):
    return wl.make_diurnal_workload(80.0, t_in=T_IN, t_out=T_OUT,
                                    peak_load=2.0, trough_load=0.2,
                                    n_service_slots=8, seed=4)


def _admission(p):
    return dict(admission=PKG[p][1].AdmissionConfig(pressure_watermark=1.0))


def _degrade(p):
    adm = PKG[p][1]
    return dict(mc_walkers=128, policy="gittins",
                admission=adm.AdmissionConfig(pressure_watermark=1.0),
                degrade=adm.DegradeConfig(high_watermark=1.5,
                                          low_watermark=0.5, walker_cap=32,
                                          llm_speedup=2.0))


def _faults(p, events, n=4, **kw):
    ft, be = PKG[p][2], PKG[p][3]
    return dict(faults=be.FaultConfig(
        events=tuple(ft.FaultEvent(**e) for e in events),
        n_backends=(("llm", n),), **kw))


def _outage(p):
    be = PKG[p][3]
    return dict(faults=be.FaultConfig(
        events=tuple(be.correlated_outage_plan(3.0, "llm", [0, 1],
                                               stagger_s=0.5,
                                               recover_after_s=6.0)),
        n_backends=(("llm", 4),), heartbeat_timeout_s=1.0))


def _refresh(**rc):
    return lambda p: dict(refresh=PKG[p][4](**rc))


# (workload, SimConfig keywords of one package) for each arm
ARMS = {
    "hermes_ddl_admission_fused_delta": (
        _crowd, lambda p: dict(policy="hermes_ddl", **_admission(p))),
    "hermes_ddl_admission_fused": (
        _crowd, lambda p: dict(policy="hermes_ddl",
                               refresh=PKG[p][4](mode="fused"),
                               **_admission(p))),
    "gittins_degradation": (lambda wl: _crowd(wl, spike_mult=10.0),
                            _degrade),
    "slo_mix": (_slo_mix, lambda p: dict(policy="hermes_ddl",
                                         **_admission(p))),
    "crash": (_small, lambda p: _faults(
        p, [dict(t=20.0, kind="crash", backend=1)],
        heartbeat_timeout_s=1.0)),
    "correlated_outage": (_small, _outage),
    "slow_backend_straggler": (_small, lambda p: _faults(
        p, [dict(t=0.5, kind="slow", backend=0, slowdown=4.0)], n=2,
        straggler_threshold=1.5, straggler_flag_after=2)),
    "pool_split_fault_free": (_small, lambda p: _faults(p, [])),
    "diurnal_lstf": (_diurnal, lambda p: dict(policy="lstf")),
    **{f"policy_{pol}": (_small, lambda p, pol=pol: dict(policy=pol))
       for pol in ("fcfs_app", "fcfs_req", "vtc", "edf", "lstf",
                   "hermes_ddl", "gittins")},
    "prewarm_epwq": (_small, lambda p: dict(prewarm_mode="epwq")),
    "prewarm_lru": (_small, lambda p: dict(prewarm_mode="lru")),
    "fused": (_small, _refresh(mode="fused")),
    "queue_delay_correction": (
        _small, lambda p: dict(prewarm_mode="hermes",
                               refresh=PKG[p][4](
                                   queue_delay_correction=True))),
    "looped_hermes_ddl": (_small, lambda p: dict(
        policy="hermes_ddl", refresh=PKG[p][4](mode="looped"))),
    "walker_threefry": (_small, _refresh(walker="threefry")),
    "warmup_model": (_small, lambda p: dict(prewarm_mode="hermes",
                                            warmup_model="llama3-8b")),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_run_sim_arm_matches_the_reference(kbs, arm):
    make, kw = ARMS[arm]
    base = dict(seed=5, prewarm_mode="lru", n_llm_slots=8, mc_walkers=64)
    j = j_run(kbs[0], make(j_wl), JConfig(**{**base, **kw("j")}))
    t = t_run(kbs[1], make(t_wl), TConfig(**{**base, **kw("t")},
                                          device="cpu"))
    assert len(t.acts) > 0
    assert t.completion_order == j.completion_order
    ids = j.completion_order
    np.testing.assert_allclose([t.acts[i] for i in ids],
                               [j.acts[i] for i in ids], rtol=1e-6)
    assert t.shed == j.shed
    assert t.slo == j.slo
    assert t.units_done == j.units_done
    assert t.fault_stats == j.fault_stats
    assert t.degrade_stats == j.degrade_stats
    assert t.prewarm_stats == j.prewarm_stats
    assert t.policy_calls == j.policy_calls


# ---------------------------------------------------- call-by-call classes

def test_admission_ledger_call_by_call():
    """Admit / exit / double-exit churn (admission once per lifetime):
    per-tenant live demand, fair-share verdicts and hopeless decisions."""
    rng = np.random.default_rng(3)
    ctl = [PKG[p][1].AdmissionController(
        PKG[p][1].AdmissionConfig(fair_share_slack=1.5)) for p in PKG]
    live = set()
    for _ in range(300):
        op, x = int(rng.integers(0, 3)), int(rng.integers(0, 10 ** 6))
        app, tenant = f"a{x % 40}", f"t{x % 5}"
        for c in ctl:
            if op == 0 and app not in live:
                c.note_admitted(app, tenant, 1.0 + (x % 7))
            elif op:
                c.note_exit(app)
                c.note_exit(app)
        if op == 0:
            live.add(app)
        else:
            live.discard(app)
        out = [({t: a.live_demand for t, a in c.tenants.items()},
                [c.over_share(f"t{k}") for k in range(5)],
                c.hopeless(10.0, float(x % 5), float(x % 13),
                           extra_wait=float(x % 3))) for c in ctl]
        assert out[0] == out[1]


def test_degrade_latch_call_by_call():
    rng = np.random.default_rng(5)
    d = [PKG[p][1].DegradeState(PKG[p][1].DegradeConfig(
        high_watermark=3.0, low_watermark=1.0, llm_speedup=2.0))
        for p in PKG]
    for pressure in rng.uniform(0.0, 5.0, 200):
        assert d[0].update(float(pressure)) == d[1].update(float(pressure))
        assert d[0].entered == d[1].entered


def test_requeue_backoff_call_by_call():
    for k in range(-3, 70):
        for base, cap in ((0.25, 4.0), (0.1, 30.0), (1.0, 1.0)):
            assert j_ft.requeue_backoff(k, base, cap) == \
                t_ft.requeue_backoff(k, base, cap)


def test_heartbeat_reap_call_by_call():
    rng = np.random.default_rng(7)
    now = {"t": 0.0}
    reg = [PKG[p][2].HeartbeatRegistry(timeout_s=2.0,
                                       clock=lambda: now["t"]) for p in PKG]
    for step in range(200):
        now["t"] += float(rng.uniform(0.0, 0.8))
        op, b, u = (int(rng.integers(0, 4)), f"llm{rng.integers(0, 4)}",
                    str(rng.integers(0, 30)))
        outs = []
        for r in reg:
            call = (lambda: r.beat(b), lambda: r.assign(b, u),
                    lambda: r.complete(b, u), r.reap_dead)[op]
            try:
                outs.append(call())
            except KeyError as e:          # an engine that never beat
                outs.append(("KeyError", str(e)))
        assert outs[0] == outs[1], step
        assert {k: (e.last_beat, e.inflight)
                for k, e in reg[0].engines.items()} == \
            {k: (e.last_beat, e.inflight) for k, e in reg[1].engines.items()}


def test_failure_injector_call_by_call():
    rng = np.random.default_rng(9)
    kinds = ("crash", "slow", "recover")
    draws = list(zip(rng.integers(0, 20, 30).tolist(),
                     rng.integers(0, 3, 30).tolist(),
                     rng.integers(0, 4, 30).tolist()))
    plan = {p: [PKG[p][2].FaultEvent(
        t=float(t), kind=kinds[k], backend=b,
        **({"slowdown": 2.0} if kinds[k] == "slow" else {}))
        for t, k, b in draws] for p in PKG}
    inj = {p: PKG[p][2].FailureInjector(plan=plan[p]) for p in PKG}
    key = lambda evs: [(e.t, e.kind, e.backend) for e in evs]  # noqa: E731
    assert key(inj["j"].pending()) == key(inj["t"].pending())
    for now in np.arange(0.0, 22.0, 0.75):
        assert key(inj["j"].due(float(now))) == key(inj["t"].due(float(now)))
    assert inj["t"].pending() == ()


def test_straggler_watchdog_call_by_call():
    rng = np.random.default_rng(11)
    wd = [PKG[p][2].BackendStragglerWatchdog(threshold=1.5, flag_after=3,
                                             clear_after=2) for p in PKG]
    for _ in range(300):
        b, x = f"llm{rng.integers(0, 3)}", float(rng.uniform(0.5, 3.0))
        assert wd[0].observe(b, x) == wd[1].observe(b, x)
        assert wd[0].slowdown(b) == wd[1].slowdown(b)
        assert wd[0].flag_events == wd[1].flag_events


def test_pools_and_outage_plans_call_by_call():
    rng = np.random.default_rng(13)
    pools = [PKG[p][3].BackendPool("llm", total_slots=10, n_backends=4)
             for p in PKG]
    for _ in range(100):
        i, run, alive = (int(rng.integers(0, 4)), int(rng.integers(0, 4)),
                         bool(rng.random() < 0.8))
        for pool in pools:
            pool[i].running, pool[i].alive = run, alive
        placed = [pool.place() for pool in pools]
        assert [None if b is None else b.backend_id for b in placed][0] == \
            [None if b is None else b.backend_id for b in placed][1]
        assert pools[0].capacity() == pools[1].capacity()
    for slots, n in (({"llm": 8, "docker": 4}, None),
                     ({"llm": 8}, {"llm": 4})):
        a, b = (PKG[p][3].build_pools(slots, n) if n else
                PKG[p][3].build_pools(slots) for p in PKG)
        assert {k: [(m.backend_id, m.slots) for m in v]
                for k, v in a.items()} == \
            {k: [(m.backend_id, m.slots) for m in v] for k, v in b.items()}
    plans = [PKG[p][3].correlated_outage_plan(10.0, "llm", [0, 2, 3],
                                              stagger_s=1.5,
                                              recover_after_s=5.0)
             for p in PKG]
    assert [(e.t, e.kind, e.backend) for e in plans[0]] == \
        [(e.t, e.kind, e.backend) for e in plans[1]]
