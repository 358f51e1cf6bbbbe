"""The port across processes: the sharded refresh and the expert-parallel
MoE with one position a process over ``torch.distributed`` (gloo, CPU).

One world is spawned for each world size of 2, 4 and 8
(``launch.procs.spawn``); each runs all its checks in every rank
(``torch_procs_ranks.py``) and returns what it saw.  The ranks hold
themselves, bit for bit, to the one-process port in the same process; the
tests below hold what they return to the JAX package, computed in two
subprocesses that see 4 and 8 host devices (the main process must see one
JAX device), started before the worlds and read after them.

(a) Every rank of every world finds no mismatch: the mesh tick at 2, 4
and 8 ranks against the delta tick (uniform, skewed and lane-balanced
dirty sets, K2's walk, a repack epoch with posterior rows; at 8 ranks the
repack and the reference's scenario below), the EP layer at meshes
(1, 2), (2, 2) and (1, 4) against the one-process body at
``capacity_factor`` 8.0 and 0.5, the tiny MoE's expert share as drawn and
its EP prefill, and ``RefreshMesh``'s guard against a group of another
size.
(b) Every rank ticks the same slots: the walked and ranked sets of every
mesh tick agree across the ranks.
(c) The EP layer's data shards, gathered from the ranks, within 1e-4 of
the reference's ``shard_map`` at ``capacity_factor`` 8.0.
(d) At 8 ranks, ``tests/test_torch_mesh.py``'s (c) scenario against the
reference's ``shard_map`` mesh at 8 host devices and its delta tick, held
as that test holds the one-process port (ROADMAP §3, the 2-ulp finding).
(e) ``run_sim`` at ``mesh_shards=4`` over 4 ranks: the same result on
every rank, and the reference's default run's.
(f) ``init_process_mesh``'s guards, without spawning.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.apps.suite import T_IN, T_OUT
from repro.apps.suite import build_knowledge_base as j_kb
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.procs import spawn
from repro_torch.models.layers import padded_experts
from repro_torch.testing import tiny_config

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_procs_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
EP_TAGS = ("16/8.0", "12/8.0", "16/0.5")
EP_SHAPES = {2: [(1, 2)], 4: [(2, 2), (1, 4)], 8: []}
ENV = {"OMP_NUM_THREADS": "1"}

_EP_REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed.sharding import ShardCtx, use_shard_ctx
from repro.models import moe as X
from repro.testing import tiny_config
assert jax.device_count() == 4
inp = dict(np.load(sys.argv[1]))
out = {}
for tag in ("16/8.0", "12/8.0"):
    ne, cf = tag.split("/")
    cfg = tiny_config("qwen2-moe-a2.7b", capacity_factor=float(cf),
                      num_experts=int(ne), dtype="float32", moe_impl="ep")
    p = {k[len(tag) + 3:]: jnp.asarray(v) for k, v in inp.items()
         if k.startswith(tag + "/p/")}
    x = jnp.asarray(inp[tag + "/x"])
    for shape in ((1, 2), (2, 2), (1, 4)):
        devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        mesh = Mesh(devs, ("data", "model"))
        with use_shard_ctx(ShardCtx(mesh)), mesh:
            y = jax.jit(lambda pp, xx: X.moe_apply(pp, xx, cfg))(p, x)
        out[f"{tag}/{shape}"] = np.asarray(y)
np.savez(sys.argv[2], **out)
print("done")
"""

_MESH_REFERENCE = """
import json, numpy as np
from repro.apps.suite import T_IN, T_OUT, build_knowledge_base as j_kb
from repro.core.refresh_config import RefreshConfig as JRC
from repro.core.scheduler import HermesScheduler as JS
import jax
assert jax.device_count() == 8

def filled(mesh, lane, rik):
    s = JS(j_kb(n_trials=60, seed=3), policy="hermes_ddl", t_in=T_IN,
           t_out=T_OUT, mc_walkers=32, seed=11, prewarm=True,
           refresh=JRC(mode="fused_delta", mesh_shards=mesh,
                       lane_balance=lane, rank_in_kernel=rik))
    names = sorted(s.kb)
    for i in range(24):
        aid = f"a{i:03d}"
        s.on_arrival(aid, names[i % len(names)], now=0.25 * i,
                     tenant=f"t{i % 4}", deadline=200.0 + 3.0 * i)
        s.on_progress(aid, 0.05 * i)
    return s

def run(s):
    out = [s.priorities(10.0)]
    for i in range(0, 24, 4):
        aid = f"a{i:03d}"
        s.on_unit_start(aid, s.apps[aid].current_unit, 11.0)
    out.append(s.priorities(12.0))
    p = s.take_prewarm_plan()
    out.append(sorted(zip(p.app_ids, p.resource_keys,
                          map(float, p.fire_at), map(float, p.p_reach))))
    qs = s._qstate
    out.append({a: [float(qs.sup[i]), float(qs.opt[i]), float(qs.mean[i])]
                for a, i in qs.slot.items()})
    return out

res = {}
for lane in (None, 0.0):
    for rik in (None, False):
        res[f"{lane}/{rik}"] = {"ref_mesh": run(filled(8, lane, rik)),
                                "ref_delta": run(filled(None, None, rik))}
print(json.dumps(res))
"""


def _ep_inputs():
    """The EP layer's weights and tokens (float32, from a seed)."""
    rng = np.random.default_rng(0)
    out = {}
    for tag in EP_TAGS:
        ne, cf = tag.split("/")
        cfg = tiny_config("qwen2-moe-a2.7b", num_experts=int(ne),
                          capacity_factor=float(cf))
        D, F = cfg.d_model, cfg.d_ff_expert or cfg.d_ff
        E, Fs = padded_experts(int(ne)), cfg.num_shared_experts * F
        p = {"router": rng.normal(size=(D, int(ne))),
             "wi": rng.normal(size=(E, D, F)) / D ** 0.5,
             "wg": rng.normal(size=(E, D, F)) / D ** 0.5,
             "wo": rng.normal(size=(E, F, D)) / F ** 0.5,
             "shared_wi": rng.normal(size=(D, Fs)) / D ** 0.5,
             "shared_wg": rng.normal(size=(D, Fs)) / D ** 0.5,
             "shared_wo": rng.normal(size=(Fs, D)) / Fs ** 0.5,
             "shared_gate": rng.normal(size=(D,)) / D ** 0.5}
        for k, v in p.items():
            out[f"{tag}/p/{k}"] = v.astype(np.float32)
        out[f"{tag}/x"] = rng.normal(size=(4, 16, D)).astype(np.float32)
    return out


def _jax(script, devices, *args):
    env = {"XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
           "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(script),
                             *map(str, args)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocesses, started first, then the three
    worlds, one after the other."""
    tmp = tmp_path_factory.mktemp("procs")
    inputs = _ep_inputs()
    np.savez(tmp / "in.npz", **inputs)
    ep_ref = _jax(_EP_REFERENCE, 4, tmp / "in.npz", tmp / "out.npz")
    mesh_ref = _jax(_MESH_REFERENCE, 8)
    worlds = {n: spawn(ranks.run_world, n, n, EP_SHAPES[n], inputs,
                       EP_TAGS, env=ENV, timeout_s=600.0)
              for n in (2, 4, 8)}
    _finish(ep_ref)
    mesh_out = _finish(mesh_ref)
    return {"worlds": worlds, "ep_ref": dict(np.load(tmp / "out.npz")),
            "mesh_ref": json.loads(mesh_out.strip().splitlines()[-1])}


@pytest.mark.parametrize("n", (2, 4, 8))
def test_every_rank_finds_no_mismatch(runs, n):
    world = runs["worlds"][n]
    assert [r["rank"] for r in world] == list(range(n))
    for r in world:
        assert r["fails"] == [], (r["rank"], r["fails"][:10])


@pytest.mark.parametrize("n", (2, 4, 8))
def test_every_rank_ticks_the_same_slots(runs, n):
    world = runs["worlds"][n]
    ticks = world[0]["ticks"]
    assert len(ticks) >= 8
    assert any(balanced for *_, balanced in ticks), "no balanced tick"
    assert any(len(walked) for walked, *_ in ticks)
    for r in world[1:]:
        assert r["ticks"] == ticks, r["rank"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)],
                         ids=["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("tag", ["16/8.0", "12/8.0"])
def test_ep_matches_the_reference_shard_map(runs, shape, tag):
    """Every model rank of a data shard returns the same rows; the data
    shards in order are the reference's output within 1e-4."""
    world = runs["worlds"][shape[0] * shape[1]]
    key = f"{tag}/{shape}"
    nd, n = shape
    shards = []
    for d in range(nd):
        rows = [world[d * n + r]["ep"][key] for r in range(n)]
        for r in range(1, n):
            np.testing.assert_array_equal(rows[r], rows[0])
        shards.append(rows[0])
    np.testing.assert_allclose(np.concatenate(shards),
                               runs["ep_ref"][key], rtol=0, atol=1e-4)


def test_mesh_tick_at_8_ranks_against_the_reference(runs):
    """Bitwise to the reference's delta tick in every case, and to its
    8-device mesh on the unbalanced ticks; within 1e-6 relative of its
    balanced mesh tick, which ranks a row of this scenario off its own
    delta tick (ROADMAP §3)."""
    ref = runs["mesh_ref"]
    assert len(ref) == 4
    for r in runs["worlds"][8]:
        port = json.loads(json.dumps(r["reference"]))
        for key, want in ref.items():
            got = port[key]
            assert got == want["ref_delta"], (r["rank"], key)
            if key.startswith("None/"):
                assert got == want["ref_mesh"], (r["rank"], key)
            for tick in (0, 1):
                ids = sorted(got[tick])
                np.testing.assert_allclose(
                    [got[tick][i] for i in ids],
                    [want["ref_mesh"][tick][i] for i in ids], rtol=1e-6,
                    err_msg=key)
            assert got[3] == want["ref_mesh"][3], key


@pytest.fixture(scope="module")
def reference_sim():
    """The reference's default run: its mesh would need 4 devices, and
    its delta tick gives its mesh's bits."""
    from repro.apps.workload import make_workload as j_workload
    from repro.serving.simulator import SimConfig as JConfig
    from repro.serving.simulator import run_sim as j_run
    return j_run(j_kb(n_trials=40, seed=3),
                 j_workload(30, 120.0, seed=29, t_in=T_IN, t_out=T_OUT),
                 JConfig(seed=5, n_llm_slots=8, mc_walkers=32))


@pytest.mark.parametrize("field", ["order", "acts", "calls_and_prewarm"])
def test_run_sim_at_4_shards_over_4_ranks(runs, reference_sim, field):
    """Every rank returns the same ``SimResult``, and it is the
    reference's: completion order, ACTs (bitwise here; the contract is
    1e-6), refresh calls and prewarm statistics."""
    sims = [r["sim"] for r in runs["worlds"][4]]
    assert all(s == sims[0] for s in sims[1:])
    j, t = reference_sim, sims[0]
    assert len(t["order"]) == 30
    if field == "order":
        assert t["order"] == list(j.completion_order)
    elif field == "acts":
        np.testing.assert_allclose(
            t["acts"], [j.acts[i] for i in j.completion_order], rtol=1e-6)
    else:
        assert t["policy_calls"] == j.policy_calls
        assert t["prewarm_stats"] == j.prewarm_stats


# ------------------------------------------------------------- (f) guards

def test_a_world_of_another_size_is_refused(monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="cannot hold a mesh of 4"):
        t_mesh.init_process_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        t_mesh.init_process_mesh((2,), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        monkeypatch.delenv("RANK")
        t_mesh.init_process_mesh((2,), ("shard",), device="cpu")


def test_ranks_sharing_a_card_need_gloo(monkeypatch):
    """Four local ranks on one card: no backend raises (NCCL refuses two
    ranks on one card, and gloo is never chosen silently), and so does
    asking for NCCL; one rank a card would take NCCL."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in (("RANK", "1"), ("WORLD_SIZE", "4"), ("LOCAL_RANK", "1"),
                 ("LOCAL_WORLD_SIZE", "4")):
        monkeypatch.setenv(k, v)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(ValueError, match="backend='gloo'"):
            t_mesh.init_process_mesh((1, 4), ("data", "model"),
                                     device=device)
        with pytest.raises(ValueError, match="one card a rank"):
            t_mesh.init_process_mesh((1, 4), ("data", "model"),
                                     device=device, backend="nccl")
    with pytest.raises(ValueError, match="not a card"):
        t_mesh.init_process_mesh((1, 4), ("data", "model"), device="cpu",
                                 backend="nccl")
