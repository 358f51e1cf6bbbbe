"""The slice as a whole: the port's simulator against the JAX package's on
one trace — the default configuration (fused delta refresh, counter-RNG
walker with the rank in the kernel, Hermes prewarming), the port on the CPU.
"""
import numpy as np

from repro.apps.suite import T_IN, T_OUT
from repro.apps.suite import build_knowledge_base as j_kb
from repro.apps.workload import make_workload as j_workload
from repro.serving.simulator import SimConfig as JConfig
from repro.serving.simulator import run_sim as j_run
from repro_torch.apps.suite import build_knowledge_base as t_kb
from repro_torch.apps.workload import make_workload as t_workload
from repro_torch.serving.simulator import SimConfig as TConfig
from repro_torch.serving.simulator import run_sim as t_run


def _both(policy="gittins", deadlines=False, n_apps=30):
    kw = dict(seed=29, t_in=T_IN, t_out=T_OUT, with_deadlines=deadlines)
    cfg = dict(seed=5, n_llm_slots=8, mc_walkers=32, policy=policy)
    j = j_run(j_kb(n_trials=40, seed=3), j_workload(n_apps, 120.0, **kw),
              JConfig(**cfg))
    t = t_run(t_kb(n_trials=40, seed=3), t_workload(n_apps, 120.0, **kw),
              TConfig(device="cpu", **cfg))
    return j, t


def _assert_same_run(j, t):
    assert t.completion_order == j.completion_order
    ids = j.completion_order
    ja = np.asarray([j.acts[a] for a in ids])
    ta = np.asarray([t.acts[a] for a in ids])
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    assert t.policy_calls == j.policy_calls
    assert t.prewarm_stats == j.prewarm_stats


def test_default_config_run_sim_matches():
    j, t = _both()
    assert len(t.completion_order) == 30
    _assert_same_run(j, t)


def test_composed_refresh_run_sim_matches():
    """``RefreshConfig(rank_in_kernel=False)``: every delta tick walks
    through the per-phase walk and composes the reductions."""
    from repro.core.refresh_config import RefreshConfig as JRefresh
    from repro_torch.core.refresh_config import RefreshConfig as TRefresh
    kw = dict(seed=29, t_in=T_IN, t_out=T_OUT)
    cfg = dict(seed=5, n_llm_slots=8, mc_walkers=32, policy="gittins")
    j = j_run(j_kb(n_trials=40, seed=3), j_workload(30, 120.0, **kw),
              JConfig(refresh=JRefresh(rank_in_kernel=False), **cfg))
    t = t_run(t_kb(n_trials=40, seed=3), t_workload(30, 120.0, **kw),
              TConfig(refresh=TRefresh(rank_in_kernel=False), device="cpu",
                      **cfg))
    assert len(t.completion_order) == 30
    _assert_same_run(j, t)


def test_posterior_run_sim_matches():
    """Online posterior learning on a short drift trace (the drift
    benchmark's scenario, cut to 150 s with the shift at 50 s)."""
    from repro.apps.workload import TenantProfile as JTenant
    from repro.apps.workload import make_drift_workload as j_drift
    from repro.core.posterior import PosteriorConfig as JPosterior
    from repro_torch.apps.workload import TenantProfile as TTenant
    from repro_torch.apps.workload import make_drift_workload as t_drift
    from repro_torch.core.posterior import PosteriorConfig as TPosterior
    mix = {"EV": 0.144, "FEV": 0.144, "CC": 0.144, "ALFWI": 0.144,
           "KBQAV": 0.144, "CG": 0.13, "PE": 0.13}
    kw = dict(t_in=T_IN, t_out=T_OUT, shift_at=50.0, rate_per_s=0.3,
              demand_mult=3.0, p_repeat=0.35,
              drift_apps=("FEV", "ALFWI", "KBQAV"), n_service_slots=8,
              seed=11)
    cfg = dict(policy="gittins", seed=5, prewarm_mode="lru", n_llm_slots=8,
               mc_walkers=64)
    j = j_run(j_kb(n_trials=40, seed=3),
              j_drift(150.0, tenants=[JTenant(name="t0", app_mix=mix)], **kw),
              JConfig(posterior=JPosterior(), **cfg))
    t = t_run(t_kb(n_trials=40, seed=3),
              t_drift(150.0, tenants=[TTenant(name="t0", app_mix=mix)], **kw),
              TConfig(posterior=TPosterior(), device="cpu", **cfg))
    assert len(t.completion_order) > 30
    _assert_same_run(j, t)
