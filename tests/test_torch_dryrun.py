"""The traced dry run, ``run_training(mesh=)`` for the EP presets and
``decode_f32_scores=False`` through the decode-attention kernel's plain
version, against the JAX package.

(a) The tiny (2, 2) train cells of ``scripts/torch_dryrun_compare.py``
(8 x 128 tokens, float32; the dense Llama-3 and the Qwen1.5-MoE EP
preset), each traced as rank 0 of a 4-rank stand-in world: the
parameter, argument and output bytes a device equal the reference's
compiled ones (its ``_compile_cell`` in a subprocess at 4 host devices),
less the 8 bytes a leaf of its output tuple for the output (XLA's
bookkeeping, which eager PyTorch does not have), and the EP cell's
all-to-all wire bytes equal the reference's extrapolated all-to-all
bytes.
(b) The full-depth trace's product FLOPs equal the one- and two-period
extrapolation's within 1e-9 relative at a tiny config of 3 periods of
the dense, MoE (EP), SSM, encoder-decoder and VLM families (the hybrid's
24 tiny layers take ~10 s to trace; its sub-layers are theirs), and
the ranks of the (2, 2) world count the same but for the global norm's
blocks (rank 0, the one traced, sums every block it holds).
(c) The ``meta`` stand-ins of the kernels K3-K7: each ``cost`` equals a
count by hand at one shape, the stand-in returns the kernel's output
shapes, and a counter around it is charged exactly that cost.
(d) Two production cells, ``qwen2-moe-a2.7b`` ``train_4k`` on the
single-pod mesh with the sort and the EP dispatch, through ``python -m
repro_torch.launch.dryrun``: records with the reference's keys over 256
devices, and all-to-all bytes under EP.
(e) ``run_training(mesh=)`` of the tiny EP preset over a (2, 2) gloo world
(``torch_dryrun_ranks.py``): the same losses as the placed train step
taken by hand, whose first gradients are the one-process EP body's.
(f) ``decode_f32_scores=False``: the plain decode attention equals the
reference's ``decode_attention_xla(f32_scores=False)`` within 2e-2 in
bfloat16 (and changes nothing at float32), and a tiny bfloat16 Llama
decodes 4 teacher-forced steps within the model tests' 5e-2 of the
reference's with the same option, its logits not those of float32
scores.
"""
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import decode_attention_xla
from repro.models.model import build_model as jax_build_model
from repro.testing import tiny_config as jax_tiny_config
from repro_torch.config import ShapeConfig
from repro_torch.distributed.sharding import (Placement, ShardCtx,
                                              block_slices, use_shard_ctx)
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import dryrun
from repro_torch.launch.costs import CostCounter
from repro_torch.launch.mesh import ProcessMesh, make_mesh, stand_in_mesh
from repro_torch.launch.procs import spawn
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model, params_from_jax
from repro_torch.models.transformer import layer_kinds, layer_plan
from repro_torch.testing import tiny_config

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(ROOT / "scripts"))
import torch_dryrun_compare as cmp  # noqa: E402
import torch_dryrun_ranks as ranks  # noqa: E402

ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's compiles of the (2, 2) cells, started first, and
    the (2, 2) world of (e) while they run."""
    path = tmp_path_factory.mktemp("dryrun") / "reference.json"
    proc = cmp.start_reference(path, accounting=("ep",))
    world = spawn(ranks.run_world, 4, None, env=ENV, timeout_s=300.0)
    return {"reference": cmp.read_reference(proc, path), "world": world}


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("name", list(cmp.CELLS))
def test_tiny_cells_match_the_reference_compile(runs, name):
    want = runs["reference"][name]
    got = cmp.port(name)
    mem, wmem = got["main"]["memory_analysis"], want["main"][
        "memory_analysis"]
    assert got["main"]["params_bytes"] == want["main"]["params_bytes_per_dev"]
    assert mem["argument_size_in_bytes"] == wmem["argument_size_in_bytes"]
    assert mem["output_size_in_bytes"] == (wmem["output_size_in_bytes"]
                                           - cmp.TUPLE_ENTRY
                                           * want["main"]["output_leaves"])
    if name == "ep":
        a2a = got["tot"]["coll"]["all-to-all"]
        assert a2a > 0 and a2a == want["tot"]["coll"]["all-to-all"]


# ------------------------------------------------------------------ (b)
SMALL = ShapeConfig("t", 32, 4, "train")


def _three_periods(arch):
    cfg = tiny_config(arch, dtype="float32")
    over = {"num_layers": 3 * len(layer_plan(cfg))}
    if cfg.enc_layers:
        over["enc_layers"] = 3
    if cfg.num_experts:
        over["moe_impl"] = "ep"
    return cfg.replace(**over)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b", "whisper-large-v3",
                                  "internvl2-26b"])
def test_product_flops_extrapolate_exactly(arch):
    cfg = _three_periods(arch)
    with stand_in_mesh((2, 2), cmp.AXES) as pm:
        main = dryrun._trace(cfg, SMALL, pm)
        m1, m2 = (dryrun._trace(dryrun.accounting_cfg(cfg, k), SMALL, pm)
                  for k in (1, 2))
    n = len(layer_kinds(cfg)) // len(layer_plan(cfg))
    assert n == 3
    want = m1["product_flops"] + (n - 1) * (m2["product_flops"]
                                            - m1["product_flops"])
    assert main["product_flops"] > 0
    assert main["product_flops"] == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", list(cmp.CELLS))
def test_every_rank_counts_the_same(name, monkeypatch):
    """The global norm sums only the blocks a rank counts
    (``Placement.counted_here``: the first rank along every axis that
    replicates a block), the one rank-dependent work of a step.  With
    every block counted on every rank the four ranks count the same, and
    that is what rank 0, the dry run's, counts as it runs."""
    cfg = cmp.config(name)

    def counts(rank):
        with stand_in_mesh((2, 2), cmp.AXES, rank) as pm:
            m = dryrun._trace(cfg, SMALL, pm)
        return {k: m[k] for k in ("flops", "bytes", "coll", "product_flops",
                                  "memory_analysis", "kernels",
                                  "params_bytes")}

    as_run = counts(0)
    monkeypatch.setattr(Placement, "counted_here", lambda self, n: True)
    every = [counts(r) for r in range(4)]
    assert all(c == every[0] for c in every[1:])
    assert as_run == every[0]
    with stand_in_mesh((1, 2), cmp.AXES):
        with pytest.raises(RuntimeError, match="already in place"):
            with stand_in_mesh((1, 2), cmp.AXES):
                pass


# ------------------------------------------------------------------ (c)
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _charged(call):
    with CostCounter() as c:
        out = call()
    return out, c.kernels


def test_rmsnorm_stand_in():
    rows, D = 6, 64
    assert rms_ops.cost(rows, D, 2) == (4.0 * rows * D,
                                        2 * rows * D * 2 + 4 * D)
    out, k = _charged(lambda: rms_ops.rmsnorm(
        _meta(2, 3, D), _meta(D, dtype=torch.float32)))
    assert out.shape == (2, 3, D) and out.dtype == torch.bfloat16
    assert k == {"rmsnorm": [1, *rms_ops.cost(rows, D, 2)]}


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_stand_in(causal):
    B, Sq, Skv, H, K, hd = 2, 5, 7, 4, 2, 16
    pairs = sum(min(i + 1, Skv) for i in range(Sq)) if causal else Sq * Skv
    assert fa_ops.cost(B, Sq, Skv, H, K, hd, 2, causal) == (
        4.0 * B * H * hd * pairs, 2 * (2 * B * Sq * H * hd
                                       + 2 * B * Skv * K * hd))
    q = _meta(B, Sq, H, hd).requires_grad_()
    out, k = _charged(lambda: fa_ops.flash_attention(
        q, _meta(B, Skv, K, hd), _meta(B, Skv, K, hd), causal=causal))
    assert out.shape == (B, Sq, H, hd)
    assert k == {"flash_attention": [1, *fa_ops.cost(
        B, Sq, Skv, H, K, hd, 2, causal)]}


@pytest.mark.parametrize("partial", [False, True])
def test_decode_attention_stand_in(partial):
    B, H, K, hd, Smax, pos = 2, 8, 2, 32, 40, 20
    G = H // K
    rows_pos = B * K * Smax if partial else B * K * (pos + 1)
    kv = 2 * hd * 2 * rows_pos
    want_bytes = (kv + B * H * hd * 2 + 4 * (B * H * hd + B * H) + 4 * B * K
                  if partial else kv + 2 * B * H * hd * 2 + 4 * B * K)
    assert dec_ops.cost(B, H, K, hd, rows_pos, 2, partial) == (
        4.0 * G * hd * rows_pos, want_bytes)
    q, kc = _meta(B, 1, H, hd), _meta(B, Smax, K, hd)
    if partial:
        lengths = torch.empty(B * K, dtype=torch.int32, device="meta")
        (o, lse), k = _charged(lambda: dec_ops.decode_attention_partials(
            q, kc, kc, lengths))
        assert o.shape == (B, 1, H, hd) and lse.shape == (B, 1, H)
        assert o.dtype == lse.dtype == torch.float32
        assert k == {"decode_attention_partial": [1, *dec_ops.cost(
            B, H, K, hd, rows_pos, 2, True)]}
    else:
        out, k = _charged(lambda: dec_ops.decode_attention(q, kc, kc, pos))
        assert out.shape == (B, 1, H, hd) and out.dtype == torch.bfloat16
        assert k == {"decode_attention": [1, *dec_ops.cost(
            B, H, K, hd, rows_pos, 2)]}


def test_moe_gmm_stand_in():
    E, C, D, N = 4, 8, 64, 96
    assert gmm_ops.cost(E, C, D, N, 2) == (2.0 * E * C * D * N,
                                           2 * (E * C * D + E * D * N
                                                + E * C * N))
    x = _meta(E, C, D).requires_grad_()
    out, k = _charged(lambda: gmm_ops.moe_gmm(x, _meta(E, D, N)))
    assert out.shape == (E, C, N)
    assert k == {"moe_gmm": [1, *gmm_ops.cost(E, C, D, N, 2)]}


def test_ssd_scan_stand_in():
    B, S, H, P, N, chunk = 2, 20, 3, 16, 8, 8
    lens = (8, 8, 4)
    flops = B * sum(L * (L + 1) * (N + H * P) + 4 * H * L * N * P
                    for L in lens)
    n_bytes = (2 * B * S * H * P * 2 + 2 * B * S * N * 2 + 4 * B * S * H
               + 4 * H + 4 * B * H * N * P)
    assert ssd_ops.cost(B, S, H, P, N, chunk, 2) == (float(flops), n_bytes)
    f32 = torch.float32
    (y, final), k = _charged(lambda: ssd_ops.ssd_scan(
        _meta(B, S, H, P), _meta(B, S, H, dtype=f32), _meta(H, dtype=f32),
        _meta(B, S, N), _meta(B, S, N), chunk=chunk))
    assert y.shape == (B, S, H, P) and final.shape == (B, H, N, P)
    assert final.dtype == f32
    assert k == {"ssd_scan": [1, *ssd_ops.cost(B, S, H, P, N, chunk, 2)]}


# ------------------------------------------------------------------ (d)
KEYS = ("lower_s", "hlo_flops_per_dev", "hlo_bytes_per_dev", "collectives",
        "scanned_program", "memory_analysis", "useful_flops_ratio",
        "params_bytes_per_dev", "model_flops_per_dev", "extrapolated",
        "roofline")


@pytest.mark.parametrize("impl", ["sort", "ep"])
def test_production_cell_traces(tmp_path, impl):
    argv = ["--arch", "qwen2-moe-a2.7b", "--shape", "train_4k", "--mesh",
            "single", "--out", str(tmp_path)]
    if impl == "ep":
        argv += ["--set", "moe_impl=ep"]
    assert dryrun.main(argv) == 0
    path, = (tmp_path / "single").iterdir()
    rec = json.loads(path.read_text())
    assert rec["ok"] is True and rec["n_devices"] == 256
    assert not [k for k in KEYS if k not in rec]
    assert "compile_s" not in rec
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes"}
    coll = rec["collectives"]
    assert set(coll) == {"all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute",
                         "total_wire_bytes", "num_collectives"}
    roof = rec["roofline"]
    assert set(roof) == {"compute_s", "memory_s", "collective_s",
                         "dominant", "step_s_lower_bound",
                         "roofline_fraction"}
    assert (coll["all-to-all"] > 0) == (impl == "ep")
    assert rec["scanned_program"]["product_flops"] == pytest.approx(
        rec["extrapolated"]["product_flops_per_dev"], rel=1e-9)
    assert 0 < rec["useful_flops_ratio"] < 1
    assert rec["scanned_program"]["kernels"]["moe_gmm"][0] == 24 * 6


# ------------------------------------------------------------------ (e)
def test_run_training_trains_the_ep_preset_placed(runs):
    cfg, dcfg = ranks.ep_preset(), ranks.data_config()
    model = build_model(cfg, device="cpu").init(
        torch.Generator(device="cpu").manual_seed(dcfg.seed)).trainable()
    from repro_torch.data.pipeline import batch_at
    with use_shard_ctx(ShardCtx(make_mesh((2, 2), cmp.AXES))):
        loss, grads = make_train_step(model, ranks.train_config()) \
            .gradients(model.params(), batch_at(dcfg, 0))
    for r in runs["world"]:
        assert r["placed"] and r["experts"] == 8    # 16 padded, 2 ranks
        assert r["run_training"] == r["by_hand"]
        assert abs(r["by_hand"][0] - float(loss)) <= 1e-5 * abs(float(loss))
        # the rank's position, no process group needed
        pm = ProcessMesh((2, 2), cmp.AXES, r["rank"], torch.device("cpu"),
                         "gloo", {})
        for n, g in grads.items():
            want = g[block_slices(g.shape, r["specs"][n], pm)].numpy()
            scale = max(float(g.abs().max()), 1e-30)
            np.testing.assert_allclose(r["grads"][n], want, rtol=0,
                                       atol=1e-4 * scale, err_msg=n)


# ------------------------------------------------------------------ (f)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B, H, K, hd, Smax, pos",
                         [(2, 8, 2, 32, 64, 40), (1, 4, 4, 16, 33, 32)])
def test_bf16_scores_match_the_reference(dtype, B, H, K, hd, Smax, pos):
    rng = np.random.default_rng(B * Smax)
    q, kc, vc = (rng.normal(size=s).astype(np.float32) for s in
                 ((B, 1, H, hd), (B, Smax, K, hd), (B, Smax, K, hd)))
    jdt = jnp.dtype(dtype)
    want = decode_attention_xla(*(jnp.asarray(a, jdt) for a in (q, kc, vc)),
                                jnp.asarray(pos), f32_scores=False)
    tdt = getattr(torch, dtype)
    got = dec_ops.decode_attention(
        *(torch.tensor(a).to(tdt) for a in (q, kc, vc)), pos,
        f32_scores=False)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    f32 = dec_ops.decode_attention(
        *(torch.tensor(a).to(tdt) for a in (q, kc, vc)), pos)
    # the option changes nothing at float32, and the output at bfloat16
    assert torch.equal(got, f32) == (dtype == "float32")
    # the plain version's two modes on one row layout
    G = H // K
    lengths = torch.full((B * K,), pos + 1, dtype=torch.int32)
    qf = torch.tensor(q).to(tdt).reshape(B * K, G, hd)
    kf = torch.tensor(kc).to(tdt).permute(0, 2, 1, 3).reshape(B * K, Smax, hd)
    vf = torch.tensor(vc).to(tdt).permute(0, 2, 1, 3).reshape(B * K, Smax, hd)
    assert torch.equal(decode_attention_ref(qf, kf, vf, lengths, False)
                       .reshape(B, 1, H, hd), got)


def test_bf16_score_model_decodes_as_the_reference():
    jcfg = jax_tiny_config("llama3-8b", dtype="bfloat16",
                           decode_f32_scores=False)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(3))
    full = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    cfg = tiny_config("llama3-8b", dtype="bfloat16", decode_f32_scores=False)
    pm = build_model(cfg, device="cpu").load_params(full)
    pf = build_model(cfg.replace(decode_f32_scores=True),
                     device="cpu").load_params(full)
    rng = np.random.default_rng(11)
    S, steps = 9, 4
    Smax = S + steps
    prompt = rng.integers(1, 256, (2, S)).astype(np.int32)
    forced = rng.integers(1, 256, (2, steps)).astype(np.int32)
    jc, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)})
    pad = [(0, 0)] * 5
    pad[2] = (0, Smax - S)
    jc = jax.tree_util.tree_map(lambda a: jnp.pad(a, pad), jc)
    pc, _ = pm.prefill(torch.as_tensor(prompt, dtype=torch.long),
                       max_seq=Smax)
    fc, _ = pf.prefill(torch.as_tensor(prompt, dtype=torch.long),
                       max_seq=Smax)
    jdec = jax.jit(jm.decode)
    differs = 0.0
    for t in range(steps):
        tok = forced[:, t:t + 1]
        jc, jl = jdec(jp, jc, jnp.asarray(tok), jnp.asarray(S + t, jnp.int32))
        pc, pl = pm.decode(pc, torch.as_tensor(tok, dtype=torch.long), S + t)
        fc, fl = pf.decode(fc, torch.as_tensor(tok, dtype=torch.long), S + t)
        np.testing.assert_allclose(pl.numpy(),
                                   np.asarray(jl.astype(jnp.float32)),
                                   rtol=5e-2, atol=5e-2,
                                   err_msg=f"decode step {t}")
        assert np.isfinite(pl.numpy()).all()
        differs = max(differs, float((pl - fl).abs().max()))
    assert differs > 0
    assert math.isfinite(differs)
