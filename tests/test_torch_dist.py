"""The port's logical sharding, meshes, steps trees, abstract specs and dry
run against the JAX package.

(a) ``ShardCtx``, ``shard``, ``use_shard_ctx`` and the meshes.
(b) ``param_pspecs`` of every parameter of each registered config's tiny
form equals the reference's ``param_pspecs(init_abstract())`` leaf, minus
its stacked-period entry.
(c) ``cell_functions``' specs (``named_shardings``, ``batch_shardings``,
``cache_shardings``, ``opt_state_shardings``) equal the reference's
``.spec`` at meshes (1, 1), (2, 2), (16, 16) and (2, 16, 16), the
reference's on an ``AbstractMesh`` (no devices needed).
(d) ``tree_device_bytes``, ``model_flops``, ``accounting_cfg``,
``extrapolate`` and ``applicable_shapes`` agree for every registered config,
and ``python -m repro_torch.launch.dryrun`` writes a record for a cell,
with the traced step's keys (``test_torch_dryrun.py`` holds the trace).
"""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest

import jax
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.config import SHAPES as J_SHAPES
from repro.config import applicable_shapes as j_applicable
from repro.config import get_config as j_get_config
from repro.distributed import sharding as J
from repro.launch import steps as j_steps
from repro.models.model import build_model as j_build
from repro.testing import tiny_config as j_tiny
from repro_torch.config import (H100_SXM, SHAPES, applicable_shapes,
                                get_config, list_configs)
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import (Mesh, make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model
from repro_torch.testing import tiny_config

# the reference's dry-run module appends a 512-device flag to XLA_FLAGS
# when imported; this process keeps its one-device backend (initialised
# first) and its environment
jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as j_dry  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

ARCHS = list_configs()
FAMILIES = ("llama3-8b", "qwen2-moe-a2.7b", "mamba2-1.3b",
            "jamba-1.5-large-398b", "whisper-large-v3", "internvl2-26b")
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ctxs(mesh_key, param_sharding="fsdp"):
    shape, axes = MESHES[mesh_key]
    return (S.ShardCtx(make_mesh(shape, axes, "meta"), param_sharding),
            J.ShardCtx(AbstractMesh(shape, axes), param_sharding))


def _flat(tree):
    """The reference's tree as {'/'-joined path: spec tuple}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, NamedSharding)))[0]
    return {J._path_str(p): tuple(getattr(v, "spec", v)) for p, v in leaves}


def _ref_path(name, cfg):
    """The reference leaf's path of a port parameter name, and whether the
    leaf is stacked over the periods (or layers)."""
    head, _, rest = name.partition(".")
    if head in ("embed", "lm_head", "projector"):
        return f"{head}/{'table' if head == 'embed' else 'kernel'}", False
    if head in ("pos_emb", "final_norm"):
        return name.replace(".", "/"), False
    if head == "enc_final_norm":
        return f"layers/{head}/{rest}", False
    layer, _, tail = rest.partition(".")
    tail = tail.replace(".", "/")
    if head == "encoder":
        return f"layers/enc/{tail}", True
    if cfg.family == "encdec":
        return f"layers/dec/{tail}", True
    return f"layers/sub{int(layer) % len(T.layer_plan(cfg))}/{tail}", True


def _same_param_specs(cfg, port, ref):
    """Every port parameter's spec is its reference leaf's without the
    stacked entry, and every reference leaf is some parameter's."""
    seen = set()
    for name, spec in port.items():
        path, stacked = _ref_path(name, cfg)
        want = ref[path]
        if stacked and want:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert tuple(spec) == want, (name, spec, want)
        seen.add(path)
    assert seen == set(ref)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("param_sharding", ["fsdp", "dp", "zero1"])
def test_logical_axes_match_the_reference(mesh_key, param_sharding):
    ctx, jctx = _ctxs(mesh_key, param_sharding)
    assert ctx.batch_axes == jctx.batch_axes
    assert ctx.model_axis == jctx.model_axis
    for name in (None, "batch", "fsdp", "model", "seq", "expert", "heads",
                 "vocab", "mlp"):
        assert ctx.logical(name) == jctx.logical(name), name
    assert tuple(ctx.pspec("batch", None, "model")) == tuple(
        jctx.pspec("batch", None, "model"))
    for c in (ctx, jctx):
        with pytest.raises(KeyError, match="unknown logical axis"):
            c.logical("rows")
    spec = S.P(("batch", "model"), "fsdp", None, "seq")
    assert tuple(S.resolve_pspec(ctx, spec)) == tuple(
        J.resolve_pspec(jctx, JP(*spec)))


def test_shard_returns_its_input_and_the_context_is_thread_local():
    x = torch.zeros(4, 6)
    assert S.shard(x, "rows", None) is x            # no context: no-op
    ctx, _ = _ctxs("2x2")
    assert S.current_ctx() is None
    with S.use_shard_ctx(ctx) as c:
        assert c is ctx and S.current_ctx() is ctx
        assert S.shard(x, "batch", "model") is x
        with pytest.raises(KeyError):
            S.shard(x, "rows", None)
        other = []
        t = threading.Thread(target=lambda: other.append(S.current_ctx()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and other == [None]
        inner, _ = _ctxs("1x1")
        with S.use_shard_ctx(inner):
            assert S.current_ctx() is inner
        assert S.current_ctx() is ctx
    assert S.current_ctx() is None


def test_meshes():
    m = make_production_mesh()
    assert dict(m.shape) == {"data": 16, "model": 16} and m.size == 256
    assert {d.type for d in m.devices.flat} == {"meta"}
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model")
    assert m.devices.shape == (2, 16, 16)
    for mp in (1, 2, 4):
        h = make_host_mesh(mp, device="cpu")
        assert dict(h.shape) == {"data": 1, "model": mp}
        assert {d.type for d in h.devices.flat} == {"cpu"}
    g = make_mesh((2, 2), ("data", "model"))
    assert dict(g.shape) == {"data": 2, "model": 2}
    with pytest.raises(ValueError):
        Mesh(np.empty((2, 2), object), ("data",))


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_the_reference(arch):
    jcfg, cfg = j_tiny(arch), tiny_config(arch)
    max_seq = 40 if cfg.rope_theta <= 0 else 0
    ref = _flat(J.param_pspecs(j_build(jcfg).init_abstract(max_seq)))
    params = build_model(cfg, device="meta").init_abstract(max_seq)
    port = S.param_pspecs(params, len(T.layer_plan(cfg)))
    _same_param_specs(cfg, port, ref)


# ---------------------------------------------------------------- (c)

_PERM = {"k": (0, 1, 3, 2, 4), "v": (0, 1, 3, 2, 4), "xk": (0, 1, 3, 2, 4),
         "xv": (0, 1, 3, 2, 4)}


def _same_cache_specs(port, ref):
    """The port's caches by kind, ``(n, B, K, S, hd)`` for the attention
    ones, against each of the reference's sub-layer caches ``(n, B, S, K,
    hd)`` of that kind."""
    kinds = {}
    for path, spec in ref.items():
        kinds.setdefault(path.rsplit("/", 1)[-1], []).append(spec)
    assert set(kinds) == set(port)
    for name, spec in port.items():
        perm = _PERM.get(name, tuple(range(len(spec))))
        for want in kinds[name]:
            assert tuple(spec) == tuple(want[j] for j in perm), (name, spec,
                                                                 want)


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_cell_shardings_match_the_reference(arch, mesh_key):
    jcfg, cfg = j_tiny(arch), tiny_config(arch)
    ctx, jctx = _ctxs(mesh_key, cfg.param_sharding)
    model = build_model(cfg, device="meta")
    for shape in applicable_shapes(cfg):
        with S.use_shard_ctx(ctx):
            fn, args, ins, outs = steps.cell_functions(model, SHAPES[shape],
                                                       ctx)
        with J.use_shard_ctx(jctx):
            _, jargs, jins, jouts = j_steps.cell_functions(
                j_build(jcfg), J_SHAPES[shape], jctx)
        _same_param_specs(cfg, ins[0], _flat(jins[0]))
        kind = SHAPES[shape].kind
        if kind == "train":
            opt, jopt = ins[1], jins[1]
            assert tuple(opt.step) == tuple(jopt.step.spec) == ()
            _same_param_specs(cfg, opt.m, _flat(jopt.m))
            _same_param_specs(cfg, opt.v, _flat(jopt.v))
            assert opt.m == ins[0] and outs[2] is None and jouts[2] is None
            assert {str(t.dtype).split(".")[-1] for t in args[1].m.values()
                    } == {str(a.dtype) for a in
                          jax.tree_util.tree_leaves(jargs[1].m)}
        if kind in ("train", "prefill"):
            batch, jbatch = ins[-1], _flat(jins[-1])
            assert {k: tuple(v) for k, v in batch.items()} == jbatch
            for k, t in args[-1].items():
                j = jargs[-1][k]
                assert tuple(t.shape) == tuple(j.shape), k
                assert str(t.dtype).split(".")[-1] == str(j.dtype), k
        else:
            _same_cache_specs(ins[1], _flat(jins[1]))
            assert tuple(ins[2]) == tuple(jins[2].spec)
            assert tuple(ins[3]) == tuple(jins[3].spec) == ()
            assert outs == (ins[1], ins[2])
            assert tuple(args[2].shape) == tuple(jargs[2].shape)
            assert args[3].shape == () and args[3].dtype == torch.int32


# ---------------------------------------------------------------- (d)

@pytest.mark.parametrize("mesh_key", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_device_bytes_and_model_flops_match_the_reference(arch, mesh_key):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    ctx, jctx = _ctxs(mesh_key, cfg.param_sharding)
    max_seq = 4104 if cfg.rope_theta <= 0 else 0
    pa = j_build(jcfg).init_abstract(max_seq)
    want = j_dry.tree_device_bytes(J.named_shardings(jctx, pa), pa)
    params = build_model(cfg, device="meta").init_abstract(max_seq)
    got = dryrun.tree_device_bytes(
        S.named_shardings(ctx, params, len(T.layer_plan(cfg))), params,
        ctx.mesh.shape)
    assert got == want
    assert sum(t.numel() for t in params.values()) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(pa))
    n = ctx.mesh.size
    for shape in SHAPES:
        assert dryrun.model_flops(cfg, SHAPES[shape], n) == \
            j_dry.model_flops(jcfg, J_SHAPES[shape], n)


@pytest.mark.parametrize("arch", ARCHS)
def test_accounting_and_shapes_match_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert applicable_shapes(cfg) == j_applicable(jcfg)
    for k in (1, 2):
        assert dataclasses.asdict(dryrun.accounting_cfg(cfg, k)) == \
            dataclasses.asdict(j_dry.accounting_cfg(jcfg, k))
    rng = np.random.default_rng(len(arch))
    m1, m2 = ({"flops": float(a), "bytes": float(b),
               "coll": {"all-gather": float(c), "total_wire_bytes": float(d)}}
              for a, b, c, d in rng.uniform(-5, 50, (2, 4)))
    for n in (1, 2, 9, 72):
        assert dryrun.extrapolate(m1, m2, n) == j_dry.extrapolate(m1, m2, n)


def test_dryrun_writes_a_record(tmp_path, capsys):
    argv = ["--arch", "qwen2-moe-a2.7b", "--shape", "train_4k", "--mesh",
            "single", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    path = tmp_path / "single" / "qwen2-moe-a2.7b__train_4k.json"
    rec = json.loads(path.read_text())
    cfg, jcfg = get_config("qwen2-moe-a2.7b"), j_get_config("qwen2-moe-a2.7b")
    jctx = J.ShardCtx(AbstractMesh((16, 16), ("data", "model")))
    pa = j_build(jcfg).init_abstract()
    mf = j_dry.model_flops(jcfg, J_SHAPES["train_4k"], 256)
    assert rec["ok"] is True and rec["n_devices"] == 256
    assert rec["params_bytes_per_dev"] == j_dry.tree_device_bytes(
        J.named_shardings(jctx, pa), pa)
    assert rec["model_flops_per_dev"] == mf
    # the traced step's keys, the reference's; nothing is compiled
    for k in ("hlo_flops_per_dev", "hlo_bytes_per_dev", "collectives",
              "scanned_program", "memory_analysis", "useful_flops_ratio",
              "lower_s"):
        assert k in rec, k
    assert "compile_s" not in rec
    assert rec["roofline"]["compute_s"] == \
        rec["hlo_flops_per_dev"] / H100_SXM.peak_flops
    assert rec["roofline"]["memory_s"] == \
        rec["hlo_bytes_per_dev"] / H100_SXM.hbm_bw
    assert rec["roofline"]["collective_s"] == \
        rec["collectives"]["total_wire_bytes"] / H100_SXM.ici_bw
    assert rec["useful_flops_ratio"] == mf / rec["hlo_flops_per_dev"]
    ex = rec["extrapolated"]
    assert ex["params_bytes_per_dev"] == rec["params_bytes_per_dev"]
    assert ex["model_flops_per_dev"] == pytest.approx(mf, rel=1e-12)
    # an existing cell is kept; a failing one is recorded and counted
    path.write_text(json.dumps(dict(rec, marker=1)))
    assert dryrun.main(argv) == 0
    assert json.loads(path.read_text())["marker"] == 1
    bad = ["--arch", "jamba-1.5-large-398b", "--shape", "train_4k", "--mesh",
           "multi", "--out", str(tmp_path), "--set", "num_layers=3"]
    assert dryrun.main(bad) == 1
    rec = json.loads((tmp_path / "multi" /
                      "jamba-1.5-large-398b__train_4k__num_layers-3.json"
                      ).read_text())
    assert rec["ok"] is False and "ValueError" in rec["error"]
    out = capsys.readouterr().out
    assert "failures=1" in out
    assert ("| jamba-1.5-large-398b train_4k multi num_layers=3 | failed: "
            "ValueError") in out
