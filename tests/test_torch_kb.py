"""The port's knowledge base and packed tables against the JAX package."""
import numpy as np
import pytest

import torch

from repro.apps.suite import T_IN, T_OUT
from repro.apps.suite import build_knowledge_base as j_build_kb
from repro.core.pdgraph import pack_graphs as j_pack
from repro_torch.apps.suite import build_knowledge_base as t_build_kb
from repro_torch.core import pdgraph as tp

TABLES = ("samples", "counts", "cum_trans")


@pytest.fixture(scope="module")
def jax_kb():
    return j_build_kb(n_trials=40, seed=3)


def _assert_packed_equal(j, t):
    for k in TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(j, k)),
                                      getattr(t, k).numpy(), err_msg=k)
    np.testing.assert_array_equal(j.entry, t.entry)
    assert j.names == t.names
    assert j.unit_index == t.unit_index


@pytest.mark.parametrize("n_trials, seed", [(40, 3), (100, 3), (60, 11)])
def test_same_seed_builds_same_packed_tables(n_trials, seed):
    """Both packages draw their KB from numpy alone, so one seed gives the
    same tables bit for bit."""
    j = j_pack(j_build_kb(n_trials=n_trials, seed=seed), T_IN, T_OUT)
    t = tp.pack_graphs(t_build_kb(n_trials=n_trials, seed=seed), T_IN, T_OUT,
                       device="cpu")
    _assert_packed_equal(j, t)
    assert t.counts.dtype == torch.int32
    assert t.samples.dtype == t.cum_trans.dtype == torch.float32


def test_json_round_trip_carries_the_kb_across(jax_kb):
    """A JAX-package graph serialised with to_json loads into the port's
    PDGraph and packs to the same tables; the port's own to_json/from_json
    round trip is lossless."""
    graphs = {n: tp.PDGraph.from_json(g.to_json()) for n, g in jax_kb.items()}
    _assert_packed_equal(j_pack(jax_kb, T_IN, T_OUT),
                         tp.pack_graphs(graphs, T_IN, T_OUT, device="cpu"))
    for name, g in graphs.items():
        again = tp.PDGraph.from_json(g.to_json())
        assert again.to_json() == g.to_json() == jax_kb[name].to_json()


def test_packed_kb_from_arrays(jax_kb):
    """The port's PackedKB rebuilt from the reference's plain arrays."""
    j = j_pack(jax_kb, T_IN, T_OUT)
    t = tp.packed_kb_from_arrays(
        j.names, j.unit_index, j.entry, np.asarray(j.samples),
        np.asarray(j.counts), np.asarray(j.cum_trans), device="cpu")
    _assert_packed_equal(j, t)
    assert t.device.type == "cpu" and t.n_units == j.n_units \
        and t.n_samples == j.n_samples


def test_recording_matches(jax_kb):
    """record_trial updates the same unit statistics in both packages."""
    tkb = t_build_kb(n_trials=40, seed=3)
    name = sorted(tkb)[0]
    obs = {"in": 120, "out": 40, "par": 2, "dur": 3.5}
    trace = [(u, obs) for u in sorted(tkb[name].units)[:2]]
    tkb[name].record_trial(trace)
    jg = jax_kb[name]
    ref = j_build_kb(n_trials=40, seed=3)[name]
    ref.record_trial(trace)
    assert ref.to_json() == tkb[name].to_json()
    assert jg.version + 1 == tkb[name].version


def test_cuda_is_the_default_device(jax_kb):
    """The port's entry points run on the card unless asked for the CPU:
    without a card, asking for it (explicitly or by default) raises."""
    graphs = {n: tp.PDGraph.from_json(g.to_json()) for n, g in jax_kb.items()}
    if torch.cuda.is_available():
        assert tp.pack_graphs(graphs, T_IN, T_OUT).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tp.pack_graphs(graphs, T_IN, T_OUT)
        with pytest.raises(RuntimeError):
            tp.pack_graphs(graphs, T_IN, T_OUT, device="cuda")
