"""The port's counter RNG and plain walk against the JAX package: the
streams, totals, arrival times and absorbed state are the same bits."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.apps.suite import T_IN, T_OUT, build_knowledge_base
from repro.core.pdgraph import ARRIVAL_NEVER, pack_graphs
from repro.kernels.pdgraph_walk import ref as jref
from repro_torch.kernels.pdgraph_walk import ref as tref

W, STEPS = 32, 48


def _u32(rng, n):
    x = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return x


def test_fmix32_and_uniforms_bitwise():
    rng = np.random.default_rng(0)
    x = _u32(rng, 4096)
    ctr = _u32(rng, 4096)
    t = torch.as_tensor(x.astype(np.int64))
    np.testing.assert_array_equal(
        np.asarray(jref.fmix32(jnp.asarray(x))).astype(np.int64),
        tref.fmix32(t).numpy())
    jr, jr2 = jref.counter_uniforms(jnp.asarray(x), jnp.asarray(ctr))
    tr, tr2 = tref.counter_uniforms(t, torch.as_tensor(ctr.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jr2), tr2.numpy())


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF, 123456789])
def test_walker_streams_bitwise(seed):
    rng = np.random.default_rng(1)
    kid = rng.integers(0, 2 ** 31 - 1, 512).astype(np.int32)
    rid = rng.integers(0, 1000, 512).astype(np.int32)
    j = jref.walker_streams(np.uint32(seed), kid, rid)
    t = tref.walker_streams(seed, kid, rid)
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


@pytest.fixture(scope="module")
def flat():
    p = pack_graphs(build_knowledge_base(n_trials=40, seed=3), T_IN, T_OUT)
    G, U, S = p.samples.shape
    return (np.asarray(p.samples).reshape(G * U, S),
            np.asarray(p.counts).reshape(G * U).astype(np.float32),
            np.asarray(p.cum_trans).reshape(G * U, U + 1), p.entry, G, U)


def _state(flat, A, seed):
    fs, fc, fcum, entry, G, U = flat
    rng = np.random.default_rng(seed)
    gi = rng.integers(0, G, A)
    start = np.where(rng.random(A) < 0.6, entry[gi], rng.integers(0, U, A))
    done = np.repeat(rng.random(A) < 0.2, W)          # invalid rows
    So = 8
    ovs = np.zeros((A * U, So), np.float32)
    ovc = np.zeros(A * U, np.float32)
    for r in rng.choice(A * U, A, replace=False):
        n = int(rng.integers(1, So + 1))
        ovc[r] = n
        ovs[r, :n] = rng.uniform(0.1, 9.0, n)
    streams = np.asarray(jref.walker_streams(np.uint32(3), np.arange(A),
                                             rng.integers(0, 5, A)))
    return dict(cur=np.repeat(start, W).astype(np.int32),
                total=np.zeros(A * W, np.float32), done=done,
                gi=np.repeat(gi, W).astype(np.int32),
                app=np.repeat(np.arange(A), W).astype(np.int32),
                stream=np.repeat(streams, W),
                lane=np.tile(np.arange(W, dtype=np.uint32), A),
                executed=np.repeat(rng.uniform(0, 1.5, A), W)
                .astype(np.float32), ovs=ovs, ovc=ovc)


def _run_jax(flat, st, ov, track, executed, step0=0, n_steps=STEPS,
             arr=None):
    fs, fc, fcum, *_ = flat
    U = fcum.shape[1] - 1
    if track and arr is None:
        arr = np.full((st["cur"].shape[0], U), ARRIVAL_NEVER, np.float32)
    out = jref.walk_phase_ref(
        jnp.asarray(fs), jnp.asarray(fc), jnp.asarray(fcum),
        jnp.asarray(st["ovs"]) if ov else None,
        jnp.asarray(st["ovc"]) if ov else None,
        jnp.asarray(st["cur"]), jnp.asarray(st["total"]),
        jnp.asarray(st["done"]), jnp.asarray(st["gi"]),
        jnp.asarray(st["app"]), jnp.asarray(st["stream"]),
        jnp.asarray(st["lane"]),
        jnp.asarray(st["executed"]) if executed else None,
        step0=step0, n_steps=n_steps, lanes_per_app=W,
        arrivals=jnp.asarray(arr) if track else None)
    return [np.asarray(o) for o in out]


def _run_torch(flat, st, ov, track, executed, step0=0, n_steps=STEPS,
               arr=None):
    fs, fc, fcum, *_ = flat
    U = fcum.shape[1] - 1
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    i64 = lambda a: t(np.asarray(a).astype(np.int64))  # noqa: E731
    if track and arr is None:
        arr = np.full((st["cur"].shape[0], U), ARRIVAL_NEVER, np.float32)
    out = tref.walk_phase_ref(
        t(fs), t(fc), t(fcum), t(st["ovs"]) if ov else None,
        t(st["ovc"]) if ov else None, i64(st["cur"]), t(st["total"]),
        t(st["done"]), i64(st["gi"]), i64(st["app"]), i64(st["stream"]),
        i64(st["lane"]), t(st["executed"]) if executed else None,
        step0=step0, n_steps=n_steps, lanes_per_app=W,
        arrivals=t(arr.copy()) if track else None)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("ov", [False, True], ids=["plain", "overrides"])
@pytest.mark.parametrize("track", [False, True], ids=["noarr", "arrivals"])
@pytest.mark.parametrize("executed", [False, True], ids=["noexec", "exec"])
def test_walk_phase_bitwise(flat, ov, track, executed):
    """cur, total, done (and first-arrival times) after the walk, across
    overrides, the step-0 executed offset and padding (done) rows."""
    st = _state(flat, 24, seed=int(ov) * 4 + int(track) * 2 + int(executed))
    j = _run_jax(flat, st, ov, track, executed)
    t = _run_torch(flat, st, ov, track, executed)
    assert len(j) == len(t) == (4 if track else 3)
    for name, a, b in zip(("cur", "total", "done", "arrivals"), j, t):
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)


def test_phases_compose_exactly(flat):
    """Walking in two phases (the counter is indexed by global step) gives
    the single-phase bits — and the port's early stop changes nothing."""
    st = _state(flat, 16, seed=11)
    one = _run_torch(flat, st, True, True, True)
    cur, total, done, arr = _run_torch(flat, st, True, True, True,
                                       n_steps=5)
    st2 = dict(st, cur=cur, total=total, done=done)
    two = _run_torch(flat, st2, True, True, False, step0=5,
                     n_steps=STEPS - 5, arr=arr)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)
