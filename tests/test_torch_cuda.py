"""The fused walk kernel on the card against its plain version.

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere
(the fixture decides, at run time).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

import torch

from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
from repro_torch.core.pdgraph import pack_graphs
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.pdgraph_walk import ops
from repro_torch.kernels.pdgraph_walk.ref import walker_streams

pytestmark = pytest.mark.cuda

KEYS = ("probs", "edges", "ranks", "total", "a_hist", "a_lo", "a_span",
        "a_reach")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(packed, A, seed):
    rng = np.random.default_rng(seed)
    G, U, _ = packed.samples.shape
    d = packed.device
    gi = rng.integers(0, G, A)
    ovs = np.zeros((A, U, 16), np.float32)
    ovc = np.zeros((A, U), np.int32)
    for a in range(0, A, 3):
        n = int(rng.integers(1, 17))
        ovc[a, a % U] = n
        ovs[a, a % U, :n] = rng.uniform(0.1, 9.0, n)
    t = lambda x: torch.as_tensor(x, device=d)  # noqa: E731
    return dict(graph_idx=t(gi.astype(np.int32)),
                start=t(packed.entry[gi].astype(np.int32)),
                executed=t(rng.uniform(0, 1, A).astype(np.float32)),
                streams=walker_streams(5, np.arange(A), np.zeros(A), d),
                attained=t(rng.uniform(0, 9, A).astype(np.float32)),
                ov_samples=t(ovs), ov_counts=t(ovc),
                valid=t(np.arange(A) < A - 3))


@pytest.mark.parametrize("W", [32, 256, 512, 1024])
def test_kernel_matches_plain_bitwise(dev, W):
    packed = pack_graphs(build_knowledge_base(n_trials=60, seed=3), T_IN,
                         T_OUT, device=dev)
    r = _rows(packed, 64, W)

    def call(fn):
        return fn(packed.samples, packed.counts, packed.cum_trans,
                  r["graph_idx"], r["start"], r["executed"], r["streams"],
                  r["attained"], r["ov_samples"], r["ov_counts"],
                  valid=r["valid"], n_walkers=W, max_steps=64,
                  track_arrivals=True, with_total=True)

    before = LAUNCHES["pdgraph_walk_fused"]
    k = call(ops.pdgraph_walk_ranked)
    assert LAUNCHES["pdgraph_walk_fused"] == before + 1
    p = call(ops.pdgraph_walk_ranked_plain)
    torch.cuda.synchronize()
    for key in KEYS:
        assert torch.equal(k[key], p[key]), key
