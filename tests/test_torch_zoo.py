"""The port's model-config zoo drives the simulator as the reference's does:
``warmup_table_from_model`` and ``degrade_speedup`` equal the JAX package's
value for value for every configuration the port registers, which is every
configuration of the JAX package's registry (the encoder-decoder and VLM
ones since ROADMAP item 16)."""
import itertools

import pytest

from repro.apps.suite import build_knowledge_base as jax_kb
from repro.config import get_config as jax_get_config
from repro.config import list_configs as jax_list_configs
from repro.core.admission import degrade_speedup as jax_degrade_speedup
from repro.core.hermeslet import \
    warmup_table_from_model as jax_warmup_table
from repro.serving.simulator import ClusterSim as JaxClusterSim
from repro.serving.simulator import SimConfig as JaxSimConfig
from repro_torch.apps.suite import build_knowledge_base
from repro_torch.config import get_config, list_configs
from repro_torch.core.admission import DegradeConfig, degrade_speedup
from repro_torch.core.hermeslet import warmup_table_from_model
from repro_torch.serving.simulator import ClusterSim, SimConfig

ITEM_16 = ("whisper-large-v3", "internvl2-26b")


def test_port_registers_every_reference_config_but_the_item_16_ones():
    """Since item 16, every reference configuration, the item 16 ones
    included (the name is kept from when those two were not registered)."""
    assert set(jax_list_configs()) == set(list_configs())
    for name in ITEM_16:
        assert get_config(name).family == {"whisper-large-v3": "encdec",
                                           "internvl2-26b": "vlm"}[name]


@pytest.mark.parametrize("name", list_configs())
def test_warmup_table_matches_reference(name):
    assert warmup_table_from_model(name) == jax_warmup_table(name)
    assert (warmup_table_from_model(name, reference="qwen3-4b")
            == jax_warmup_table(name, reference="qwen3-4b"))


@pytest.mark.parametrize("pair", list(itertools.permutations(
    ("llama3-8b", "qwen3-4b", "qwen2-moe-a2.7b", "mamba2-1.3b",
     "jamba-1.5-large-398b"), 2)) + [("llama3-8b", "llama3-8b")])
@pytest.mark.parametrize("cap", [4.0, 1000.0])
def test_degrade_speedup_matches_reference(pair, cap):
    assert (degrade_speedup(*pair, max_speedup=cap)
            == jax_degrade_speedup(*pair, max_speedup=cap))


def test_degrade_speedup_covers_every_registered_config():
    for name in list_configs():
        assert (degrade_speedup("llama3-8b", name, max_speedup=1e9)
                == jax_degrade_speedup("llama3-8b", name, max_speedup=1e9))
    assert DegradeConfig().speedup() == jax_degrade_speedup(
        "llama3-8b", "qwen3-4b")


@pytest.mark.parametrize("name", ITEM_16)
def test_item_16_configs_raise_naming_the_item(name):
    """Since item 16 the encoder-decoder and VLM configurations no longer
    raise (the name is kept): they drive the warm-up table and the degrade
    speedup as the reference's, on either side."""
    assert warmup_table_from_model(name) == jax_warmup_table(name)
    assert (warmup_table_from_model("llama3-8b", reference=name)
            == jax_warmup_table("llama3-8b", reference=name))
    for cap in (4.0, 1e9):
        assert (degrade_speedup(name, "qwen3-4b", max_speedup=cap)
                == jax_degrade_speedup(name, "qwen3-4b", max_speedup=cap))
        assert (degrade_speedup("llama3-8b", name, max_speedup=cap)
                == jax_degrade_speedup("llama3-8b", name, max_speedup=cap))
    assert get_config(name).param_counts() == jax_get_config(
        name).param_counts()


def test_sim_builds_the_reference_warmup_table():
    sim = ClusterSim(build_knowledge_base(n_trials=10, seed=0),
                     SimConfig(warmup_model="llama3-8b", device="cpu"))
    ref = JaxClusterSim(jax_kb(n_trials=10, seed=0),
                        JaxSimConfig(warmup_model="llama3-8b"))
    assert sim.warmup_table == ref.warmup_table
    sim = ClusterSim(build_knowledge_base(n_trials=10, seed=0),
                     SimConfig(warmup_model="mamba2-1.3b",
                               warmup_table={"lora": 1.0}, device="cpu"))
    ref = JaxClusterSim(jax_kb(n_trials=10, seed=0),
                        JaxSimConfig(warmup_model="mamba2-1.3b",
                                     warmup_table={"lora": 1.0}))
    assert sim.warmup_table == ref.warmup_table == {"lora": 1.0}
