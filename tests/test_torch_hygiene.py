"""The port stands alone: nothing under src/repro_torch imports JAX or the
JAX package, its entry points run on the card unless asked for the CPU, the
kernel wrappers take CUDA tensors only, and every configuration outside
this slice raises NotImplementedError naming the ROADMAP item that ports
it; none names item 9 or item 16, which are ported."""
import ast
from pathlib import Path

import numpy as np
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


def test_no_port_module_names_item_9_as_unported():
    files = sorted(PORT.rglob("*.py"))
    assert not [f for f in files if "item 9" in f.read_text()]


def test_no_port_module_names_item_16_as_unported():
    """The encoder-decoder and VLM families are ported: no module names
    item 16 or keeps a list of unported families or configurations."""
    files = sorted(PORT.rglob("*.py"))
    assert not [f for f in files if "item 16" in f.read_text()]
    assert not [f for f in files
                if "UNPORTED" in f.read_text() or "FAMILY_ITEMS"
                in f.read_text()]


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
    (RefreshConfig(mesh_shards=2), "item 8"),
])
def test_out_of_slice_refresh_configs_raise(kb, refresh, item):
    """The sharded arena (item 8a) is ported: ``mesh_shards=2`` builds a
    2-shard mesh on the asked-for device and runs a tick over a 2-shard
    arena, where it used to raise ``NotImplementedError`` naming the
    item."""
    sched = HermesScheduler(kb, refresh=refresh, device="cpu")
    assert sched.refresh_mesh.n_shards == 2
    assert sched.refresh_mesh.device == torch.device("cpu")
    for i, name in enumerate(sorted(kb)[:5]):
        sched.on_arrival(f"a{i}", name, now=0.0)
    ranks = sched.priorities(1.0)
    assert sorted(ranks) == [f"a{i}" for i in range(5)]
    assert all(np.isfinite(list(ranks.values())))
    assert sched._qstate.n_shards == 2
    assert {s % 2 for s in sched._qstate.occupied()} == {0, 1}
    assert not [f for f in PORT.rglob("*.py")
                if f"{item})" in f.read_text()
                and "NotImplementedError" in f.read_text()]


def test_bare_scheduler_runs_the_default_refresh(kb):
    """With no ``refresh`` the scheduler takes the reference's default:
    ``composed``, or ``looped`` with ``batched=False``; ``SimConfig``'s
    default is ``RefreshConfig()`` (fused_delta)."""
    sched = HermesScheduler(kb, device="cpu")
    assert sched.refresh_config == RefreshConfig(mode="composed")
    assert (sched.mode, sched.batched) == ("composed", True)
    assert HermesScheduler(kb, batched=False, device="cpu").mode == "looped"
    assert ClusterSim(kb, SimConfig(device="cpu")).sched.refresh_config \
        == RefreshConfig()


def test_posterior_and_warmup_model_raise(kb):
    """Posterior learning is ported but rides the delta tick, so another
    mode raises as in the reference; the warmup model works for every
    configuration, Whisper's (item 16) included, and an unknown one raises
    ``KeyError`` as in the reference."""
    with pytest.raises(ValueError, match="fused_delta"):
        ClusterSim(kb, SimConfig(posterior=PosteriorConfig(),
                                 refresh=RefreshConfig(mode="fused"),
                                 device="cpu"))
    sim = ClusterSim(kb, SimConfig(warmup_model="qwen3-4b", device="cpu"))
    assert set(sim.warmup_table) == {"kv", "lora"}
    sim = ClusterSim(kb, SimConfig(warmup_model="whisper-large-v3",
                                   device="cpu"))
    assert set(sim.warmup_table) == {"kv", "lora"}
    with pytest.raises(KeyError, match="unknown arch"):
        ClusterSim(kb, SimConfig(warmup_model="whisper-tiny", device="cpu"))


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


# ---------------------------------------------------------------- model stack
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import moe_gmm  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.testing import tiny_config  # noqa: E402
from repro_torch.configs import (ENCDEC_ARCHS, HYBRID_ARCHS,  # noqa: E402
                                 MOE_ARCHS, SSM_ARCHS, VLM_ARCHS)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_model_kernel_wrappers_refuse_non_cuda_tensors(device):
    """The bindings take CUDA tensors only, and the ops take the plain
    version only for a CPU tensor: a ``meta`` tensor (the dry run's
    trace) takes the kernel's stand-in, which gives the kernel's output
    shapes and builds nothing; the bindings raise for both devices before
    anything is built."""
    z = lambda *s, **kw: torch.zeros(*s, device=device, **kw)  # noqa: E731
    calls = [lambda: rms_kernel.rmsnorm_kernel(z(4, 8), z(8), eps=1e-5),
             lambda: fa_kernel.flash_attention_kernel(
                 z(1, 5, 4, 16), z(1, 5, 2, 16), z(1, 5, 2, 16), causal=True),
             lambda: dec_kernel.decode_attention_kernel(
                 z(1, 4, 16), z(1, 9, 2, 16), z(1, 9, 2, 16),
                 z(2, dtype=torch.int32)),
             lambda: gmm_kernel.moe_gmm_kernel(z(4, 2, 16), z(4, 16, 24)),
             lambda: ssd_kernel.ssd_scan_kernel(
                 z(1, 4, 2, 8), z(1, 4, 2), z(2), z(1, 4, 4), z(1, 4, 4),
                 chunk=4)]
    if device == "meta":
        stand_ins = [(lambda: rmsnorm(z(2, 3, 8), z(8)), (2, 3, 8)),
                     (lambda: flash_attention(z(1, 5, 4, 16), z(1, 5, 2, 16),
                                              z(1, 5, 2, 16)), (1, 5, 4, 16)),
                     (lambda: decode_attention(z(1, 1, 4, 16), z(1, 9, 2, 16),
                                               z(1, 9, 2, 16), 3),
                      (1, 1, 4, 16)),
                     (lambda: moe_gmm(z(4, 2, 16), z(4, 16, 24)), (4, 2, 24)),
                     (lambda: ssd_scan(z(1, 4, 2, 8), z(1, 4, 2), z(2),
                                       z(1, 4, 4), z(1, 4, 4), chunk=4)[0],
                      (1, 4, 2, 8))]
        for call, shape in stand_ins:
            out = call()
            assert out.device.type == "meta" and tuple(out.shape) == shape
    for call in calls:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()


@pytest.mark.parametrize("family, item", [
    ("moe", "item 14"), ("hybrid", "item 15"), ("ssm", "item 15"),
    ("encdec", "item 16"), ("vlm", "item 16")])
def test_unported_model_families_raise(family, item):
    """Every model family is ported: the moe (item 14), ssm and hybrid
    (item 15), encdec and vlm (item 16) families.  A dense config
    relabelled as one of them lacks its experts, SSM state, attention
    period or encoder and raises ``ValueError``; relabelled as a VLM it
    builds a projector and its prefill raises ``ValueError`` without patch
    embeddings; their archs build."""
    cfg = tiny_config("llama3-8b").replace(family=family)
    ported = {"moe": ("num_experts > 0", MOE_ARCHS, "moe"),
              "ssm": ("ssm_state > 0", SSM_ARCHS, "mamba"),
              "hybrid": ("attn_every > 0", HYBRID_ARCHS, "attn"),
              "encdec": ("enc_layers > 0", ENCDEC_ARCHS, "cross_attn"),
              "vlm": (None, VLM_ARCHS, "attn")}
    match, archs, leaf = ported[family]
    if family == "hybrid":
        cfg = cfg.replace(ssm_state=16)
    if match is None:
        model = build_model(cfg, device="cpu")
        assert tuple(model.projector.shape) == (64, 64)
        with pytest.raises(ValueError, match="needs patch_embeds"):
            model.prefill(torch.ones(1, 3, dtype=torch.long))
    else:
        with pytest.raises(ValueError, match=match):
            build_model(cfg, device="cpu")
    for arch in archs:
        model = build_model(tiny_config(arch), device="cpu")
        assert getattr(model.layers[0], leaf) is not None


def test_bf16_decode_scores_raise_and_model_defaults_to_cuda():
    """``decode_f32_scores=False`` is ported: the model builds and decodes
    on the CPU (each q.k rounded to bfloat16 before the scale), where it
    used to raise ``NotImplementedError``."""
    model = build_model(tiny_config("llama3-8b", decode_f32_scores=False),
                        device="cpu").init(torch.Generator().manual_seed(0))
    caches, _ = model.prefill(torch.ones(1, 3, dtype=torch.long), max_seq=5)
    _, logits = model.decode(caches, torch.ones(1, 1, dtype=torch.long), 3)
    assert logits.shape == (1, 1, 256) and torch.isfinite(logits).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(tiny_config("llama3-8b"))
    assert build_model(tiny_config("llama3-8b"),
                       device="cpu").embed.device.type == "cpu"


def test_moe_model_defaults_to_cuda():
    """The full-width MoE config lands on the card when no device is
    given (refused before any weight is allocated where there is none)."""
    from repro_torch.config import get_config
    if torch.cuda.is_available():
        cfg = tiny_config("qwen2-moe-a2.7b")
        assert build_model(cfg).layers[0].moe.wi.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(get_config("qwen2-moe-a2.7b"))


# ------------------------------------------------------------------ training
TRAINING_MODULES = ("training/optimizer.py", "training/compression.py",
                    "training/train_loop.py", "checkpoint/checkpointing.py",
                    "data/pipeline.py", "launch/steps.py", "launch/train.py")


def test_training_modules_import_neither_jax_repro_nor_ml_dtypes():
    """The training, checkpoint and data subpackages stand alone, and no
    port module or ``chip_smoke.py`` needs ``ml_dtypes`` (the card's
    machine has none)."""
    for rel in TRAINING_MODULES:
        mods = list(_imports(PORT / rel))
        assert mods, rel
        assert not [m for m in mods if m.split(".")[0]
                    in ("jax", "jaxlib", "repro", "ml_dtypes")], rel
    files = sorted(PORT.rglob("*.py")) + [PORT.parents[1] / "chip_smoke.py"]
    assert not [f for f in files for m in _imports(f)
                if m.split(".")[0] == "ml_dtypes"]


def test_training_entry_points_default_to_cuda(tmp_path):
    from repro_torch.config import TrainConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import train
    from repro_torch.training.train_loop import run_training
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    cfg = tiny_config("llama3-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(cfg, TrainConfig(), DataConfig(256, 8, 2),
                     total_steps=1, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1", "--ckpt", str(tmp_path)])


def test_autograd_wrappers_refuse_non_cuda_tensors():
    """Under autograd the model kernels' wrappers never take the plain
    version for a tensor that is not on the CPU: a ``meta`` tensor (the
    dry run's trace) takes the kernel's stand-in, which runs no operation
    but its output's allocation and charges the kernel's cost; the
    kernels themselves still refuse a tensor that is not on a card."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch.costs import CostCounter

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    z = lambda *s: torch.zeros(*s, device="meta",  # noqa: E731
                               requires_grad=True)
    calls = {"rmsnorm": lambda: rmsnorm(z(2, 3, 8), z(8)),
             "flash_attention": lambda: flash_attention(
                 z(1, 5, 4, 16), z(1, 5, 2, 16), z(1, 5, 2, 16)),
             "moe_gmm": lambda: moe_gmm(z(4, 2, 16), z(4, 16, 24)),
             "ssd_scan": lambda: ssd_scan(z(1, 4, 2, 8), z(1, 4, 2), z(2),
                                          z(1, 4, 4), z(1, 4, 4), chunk=4)}
    for name, call in calls.items():
        with CostCounter() as c, Ops() as ops:
            call()
        assert ops.names <= {"empty", "zeros", "zero_"}, (name, ops.names)
        assert list(c.kernels) == [name]
    kernels = [lambda: rms_kernel.rmsnorm_kernel(z(3, 8), z(8), eps=1e-5),
               lambda: fa_kernel.flash_attention_kernel(
                   z(1, 5, 4, 16), z(1, 5, 2, 16), z(1, 5, 2, 16),
                   causal=True),
               lambda: gmm_kernel.moe_gmm_kernel(z(4, 2, 16), z(4, 16, 24)),
               lambda: ssd_kernel.ssd_scan_kernel(
                   z(1, 4, 2, 8), z(1, 4, 2), z(2), z(1, 4, 4), z(1, 4, 4),
                   chunk=4)]
    for call in kernels:
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()
