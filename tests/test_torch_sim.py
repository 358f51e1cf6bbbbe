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
