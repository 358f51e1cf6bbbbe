"""The port stands alone: nothing under src/repro_torch imports JAX or the
JAX package, its entry points run on the card unless asked for the CPU, the
kernel wrappers take CUDA tensors only, and every configuration outside
this slice raises NotImplementedError naming the ROADMAP item that ports
it."""
import ast
from pathlib import Path

import pytest

import torch

from repro_torch.apps.suite import build_knowledge_base
from repro_torch.core.posterior import PosteriorConfig
from repro_torch.core.refresh_config import RefreshConfig
from repro_torch.core.scheduler import HermesScheduler
from repro_torch.kernels.pdgraph_walk import kernel
from repro_torch.serving.simulator import ClusterSim, SimConfig

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = [(f.relative_to(PORT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
    assert not any("import jax" in f.read_text() for f in files)


@pytest.fixture(scope="module")
def kb():
    return build_knowledge_base(n_trials=20, seed=3)


@pytest.mark.parametrize("refresh, item", [
    (RefreshConfig(mode="looped"), "item 9"),
    (RefreshConfig(mode="composed"), "item 9"),
    (RefreshConfig(mode="fused", walker="threefry"), "item 9"),
    (RefreshConfig(mode="fused_delta", walker="threefry"), "item 9"),
    (RefreshConfig(rank_in_kernel=False, walker="threefry"), "item 9"),
    (RefreshConfig(mesh_shards=2), "item 8"),
])
def test_out_of_slice_refresh_configs_raise(kb, refresh, item):
    with pytest.raises(NotImplementedError, match=item):
        HermesScheduler(kb, refresh=refresh, device="cpu")


def test_bare_scheduler_runs_the_default_refresh(kb):
    """With no ``refresh`` the scheduler takes ``RefreshConfig()`` — the
    port has no composed walk to fall back to."""
    sched = HermesScheduler(kb, device="cpu")
    assert sched.refresh_config == RefreshConfig()
    assert (sched.mode, sched.walker, sched.rank_in_kernel) == \
        ("fused_delta", "pallas", True)


def test_posterior_and_warmup_model_raise(kb):
    """Posterior learning is ported but rides the delta tick, so another
    mode raises as in the reference; the warmup model is not ported."""
    with pytest.raises(ValueError, match="fused_delta"):
        ClusterSim(kb, SimConfig(posterior=PosteriorConfig(),
                                 refresh=RefreshConfig(mode="fused"),
                                 device="cpu"))
    with pytest.raises(NotImplementedError, match="item 10"):
        ClusterSim(kb, SimConfig(warmup_model="llama3-8b", device="cpu"))


@pytest.mark.parametrize("refresh", [
    RefreshConfig(rank_in_kernel=False),
    RefreshConfig(mode="fused", rank_in_kernel=False),
], ids=["fused_delta", "fused"])
def test_composed_walk_and_posterior_construct(kb, refresh):
    posterior = PosteriorConfig() if refresh.mode == "fused_delta" else None
    sim = ClusterSim(kb, SimConfig(refresh=refresh, posterior=posterior,
                                   device="cpu"))
    assert sim.sched.rank_in_kernel is False
    assert sim.sched.posterior == posterior


def test_default_device_is_cuda(kb):
    if torch.cuda.is_available():
        assert HermesScheduler(kb, refresh=RefreshConfig()).device.type \
            == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ClusterSim(kb, SimConfig())
    assert ClusterSim(kb, SimConfig(device="cpu")).sched.device.type == "cpu"


def test_kernel_wrapper_refuses_cpu_tensors():
    """The binding never runs a plain version: a CPU tensor is an error
    raised before anything is built."""
    z = torch.zeros
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernel.pdgraph_walk_fused_kernel(
            z(2, 4, 8), z(2, 4), z(2, 4, 5), None, None, z(3),
            z(3, dtype=torch.int32), z(3, dtype=torch.int32),
            z(3, dtype=torch.int32), z(3), z(3, dtype=torch.uint8),
            n_walkers=32, max_steps=8, n_buckets=10, with_arrivals=True,
            with_total=False)
    i = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernel.pdgraph_walk_kernel(
            z(2, 4, 8), z(2, 4), z(2, 4, 5), None, None, None, None, i,
            z(4), torch.zeros(4, dtype=torch.bool), i, i, i, i, None,
            step0=0, n_steps=4, lanes_per_app=2, n_apps=2)
