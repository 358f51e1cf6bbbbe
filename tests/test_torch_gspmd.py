"""The GSPMD-sharded paths across processes: the FSDP and tensor-parallel
train step, the sequence-sharded decode and the elastic restore, with one
mesh position a process over ``torch.distributed`` (gloo, CPU).

One world of 4 ranks is spawned (``launch.procs.spawn``) and runs every
check (``torch_gspmd_ranks.py``) on the tiny float32 Llama-3; the JAX
package's (2, 2) mesh runs in one subprocess that sees 4 host devices
(the main process must see one JAX device), started before the world and
read after it.  Weights are the JAX package's (``params_from_jax``), cut
to each rank's blocks by ``shard_params``.

(i) The train step at meshes (2, 2), (4, 1) and (1, 4), one and two
microbatches, ``grad_compression`` off and int8, on a batch with a
ragged loss mask: the loss within 1e-5 relative, and the gathered
gradients, parameters and moments within 1e-4 of each tensor's largest
magnitude (tensor parallelism sums in another order), against the
one-process port and the reference's jitted step on its (2, 2) mesh (its
``test_train_step_shards_and_runs_on_mesh`` setup); every rank's tensors
have their block's shape.  Under int8 compression a gradient element
that sits at a rounding boundary of its leaf's quantum (amax / 127) may
round one way in one summation order and the other way in another, a
jump far above 1e-4: there the updated parameters and moments are held
at 1e-4 to the one-process compression and AdamW applied to the world's
own gathered gradients, and to the other steps with at most one element
in a thousand of each tensor beyond 1e-4.  The dense family's
``qk_norm`` (tiny Qwen3) and ``qkv_bias`` (tiny Qwen2) configurations at
(2, 2) and (1, 4), their weights drawn by the placed ``init``: the
one-process port's gradients and updated parameters.
(ii) The reference's sequence-sharded decode-attention inputs (its
``test_seq_sharded_decode_attention_matches_single_device``) over (1, 4),
ranks 2 and 3 holding no valid position: within 1e-5 of
``decode_attention_xla``.  ``Model.decode`` at (1, 2) and (2, 2), and at
(2, 1, 2) with a pod axis and one row (the reference's batch-1 cell: the
positions split over pod and model): a prefill and 4 greedy steps, the
one-process port's tokens, its logits within 1e-4.
(iii) The reference's elastic restore (saved from (4, 1) under ``P("data",
None)``, restored onto (2, 2) under ``P(None, "model")``) bitwise; a
checkpoint the JAX package wrote restored onto (2, 2) bitwise;
``run_training`` restarted from a (2, 2) checkpoint at (1, 4) and (4, 1),
its losses within 1e-5 relative of the one-process run's.
(iv) The other families and the fallback: the SSM, hybrid,
encoder-decoder and VLM families are placed over a process mesh and
decode as one process does, and a model axis the heads or widths do not
divide gives the reference's replicated fallback, the layers computed
whole from blocks that may split them (``test_torch_gspmd_families.py``
holds every placed family and the fallback whole).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jax_ckpt
from repro.models.layers import decode_attention_xla
from repro.models.model import build_model as jax_build_model
from repro.testing import tiny_config as jax_tiny_config
from repro_torch.config import TrainConfig
from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.launch.procs import spawn
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model, params_from_jax
from repro_torch.testing import tiny_config
from repro_torch.training.compression import compress_decompress
from repro_torch.training.optimizer import adamw_update, init_opt_state
from repro_torch.training.train_loop import run_training

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_gspmd_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ENV = {"OMP_NUM_THREADS": "1"}
B, S = 8, 16

_REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.config import TrainConfig
from repro.distributed.sharding import (ShardCtx, named_shardings,
                                        use_shard_ctx)
from repro.launch.steps import make_train_step, opt_state_shardings
from repro.models.model import build_model
from repro.testing import tiny_config
from repro.training.optimizer import init_opt_state
assert jax.device_count() == 4
inp = dict(np.load(sys.argv[1]))


def nest(prefix):
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = jnp.asarray(v)
    return out


def flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


cfg = tiny_config("llama3-8b", dtype="float32")
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
ctx = ShardCtx(mesh, param_sharding="fsdp")
model = build_model(cfg)
batch = {k: jnp.asarray(inp["b/" + k]) for k in ("tokens", "labels",
                                                 "loss_mask")}
out = {}
with use_shard_ctx(ctx), mesh:
    p0 = nest("p/")
    for n_mb in (1, 2):
        for comp in ("none", "int8"):
            params = jax.device_put(p0, named_shardings(ctx, p0))
            opt = jax.device_put(init_opt_state(params),
                                 opt_state_shardings(ctx, params))
            step = jax.jit(make_train_step(model, TrainConfig(
                warmup_steps=1, microbatch=n_mb, grad_compression=comp)))
            p2, o2, m = step(params, opt, batch)
            tag = f"{n_mb}/{comp}"
            out[f"{tag}/loss"] = np.asarray(m["loss"])
            out.update(flat(p2, f"{tag}/params/"))
            out.update(flat(o2.m, f"{tag}/m/"))
            out.update(flat(o2.v, f"{tag}/v/"))
    params = jax.device_put(p0, named_shardings(ctx, p0))
    loss, g = jax.jit(jax.value_and_grad(model.train_loss))(params, batch)
    out["grad/loss"] = np.asarray(loss)
    out.update(flat(g, "grad/grads/"))
np.savez(sys.argv[2], **out)
print("done")
"""


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat, prefix):
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = v
    return out


def _batch():
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, S + 1, B)
    lengths[0] = S
    return {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 256, (B, S)).astype(np.int32),
            "loss_mask": (np.arange(S)[None] < lengths[:, None]
                          ).astype(np.float32)}


def _seq_inputs():
    """The reference test's inputs, drawn as it draws them."""
    rng = np.random.default_rng(0)
    return {"q": rng.normal(size=(2, 1, 8, 32)).astype(np.float32),
            "kc": rng.normal(size=(2, 256, 4, 32)).astype(np.float32),
            "vc": rng.normal(size=(2, 256, 4, 32)).astype(np.float32),
            "pos": 100}


def _one_process(full, batch, n_mb, comp):
    """The one-process port's step from ``full``: loss, gradients and the
    parameters and moments after it."""
    model = build_model(ranks.config(), device="cpu").load_params(full)
    model.trainable()
    step = make_train_step(model, ranks.train_config(n_mb, comp))
    params = model.params()
    _, grads = step.gradients(params, batch)
    state = init_opt_state(params)
    params, state, metrics = step(params, state, batch)
    np_ = lambda d: {n: t.detach().numpy() for n, t in d.items()}  # noqa
    return {"loss": float(metrics["loss"]), "grads": np_(grads),
            "params": np_(params), "m": np_(state.m), "v": np_(state.v)}


def _one_process_decode(full, prompt):
    model = build_model(ranks.config(), device="cpu").load_params(full)
    caches, logits = model.prefill(prompt, max_seq=ranks.DECODE_MAX_SEQ)
    out, toks = [logits], []
    for t in range(ranks.DECODE_STEPS):
        tok = out[-1][:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
        caches, logits = model.decode(caches, tok, prompt.shape[1] + t)
        out.append(logits)
    return (torch.cat(out, dim=1).numpy(), torch.cat(toks, dim=1).numpy())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd")
    jm = jax_build_model(jax_tiny_config("llama3-8b", dtype="float32"))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jm.init)(jax.random.PRNGKey(0)))
    batch = _batch()
    np.savez(tmp / "in.npz", **_flat(tree, "p/"),
             **{f"b/{k}": v for k, v in batch.items()})
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                            str(tmp / "in.npz"), str(tmp / "out.npz")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    seq = _seq_inputs()
    ref_tree = {"w": np.random.default_rng(3).normal(size=(16, 16))
                .astype(np.float32),
                "b16": np.random.default_rng(4).normal(size=(8, 8))
                .astype(np.float32)}
    jax_ckpt.save_checkpoint(str(tmp / "ref_ckpt"), 0, {
        "w": jnp.asarray(ref_tree["w"]),
        "b16": jnp.asarray(ref_tree["b16"], jnp.bfloat16)}, {"step": 0})
    ref_tree["b16"] = np.asarray(jnp.asarray(ref_tree["b16"], jnp.bfloat16)
                                 .astype(jnp.float32))
    full = params_from_jax(tree)
    prompt = np.random.default_rng(8).integers(0, 256, (2, 7))
    inp = {"params": {n: t.numpy() for n, t in full.items()},
           "batch": batch, "prompt": prompt, "seq_ref": seq,
           "arr": np.arange(256, dtype=np.float32).reshape(16, 16),
           "ref_ckpt": str(tmp / "ref_ckpt"), "ref_tree": ref_tree,
           "tmp": str(tmp)}
    world = spawn(ranks.run_world, 4, inp, env=ENV, timeout_s=300.0)
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    jref = dict(np.load(tmp / "out.npz"))
    torch.manual_seed(0)
    return {"world": world, "jax": jref, "full": full, "batch": batch,
            "prompt": prompt, "seq": seq, "ref_tree": ref_tree,
            "arr": inp["arr"]}


@pytest.fixture(scope="module")
def one_process(runs):
    return {f"{mb}/{comp}": _one_process(runs["full"], runs["batch"], mb,
                                         comp)
            for mb, comp in ranks.TRAIN_CASES}


def _close(got, want, what, flips=False):
    """Each tensor within 1e-4 of its largest magnitude; with ``flips``
    (int8 compression), but for at most one element in a thousand."""
    assert set(got) == set(want), what
    for n, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        if not flips:
            np.testing.assert_allclose(got[n], w, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{what} {n}")
            continue
        off = int((np.abs(got[n] - w) > 1e-4 * scale).sum())
        assert off <= max(1, w.size // 1000), (what, n, off)


def _update_from(full, grads, n_mb, comp):
    """The one-process compression and AdamW step on given gradients."""
    model = build_model(ranks.config(), device="cpu").load_params(full)
    params = model.params()
    g = {n: torch.tensor(a) for n, a in grads.items()}
    if comp == "int8":
        g = compress_decompress(g)
    state = init_opt_state(params)
    params, state, _ = adamw_update(g, state, params,
                                    ranks.train_config(n_mb, comp))
    np_ = lambda d: {n: t.detach().numpy() for n, t in d.items()}  # noqa
    return {"params": np_(params), "m": np_(state.m), "v": np_(state.v)}


def _jax_case(jref, tag, kind):
    return params_from_jax(_nest(jref, f"{tag}/{kind}/"))


CASES = [(shape, mb, comp) for shape in ranks.TRAIN_SHAPES
         for mb, comp in ranks.TRAIN_CASES]
IDS = [f"{s[0]}x{s[1]}-mb{mb}-{comp}" for s, mb, comp in CASES]


@pytest.mark.parametrize("shape,mb,comp", CASES, ids=IDS)
def test_train_step_matches_one_process(runs, one_process, shape, mb, comp):
    got = runs["world"][0]["train"][f"{shape}/{mb}/{comp}"]
    want = one_process[f"{mb}/{comp}"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    _close(got["grads"], want["grads"], f"{shape} grads")
    int8 = comp == "int8"
    same_grads = _update_from(runs["full"], got["grads"], mb, comp) \
        if int8 else want
    for kind in ("params", "m", "v"):
        _close(got[kind], same_grads[kind], f"{shape} {kind}")
        _close(got[kind], want[kind], f"{shape} {kind}", flips=int8)


@pytest.mark.parametrize("shape,mb,comp", CASES, ids=IDS)
def test_train_step_matches_the_reference_mesh(runs, shape, mb, comp):
    got = runs["world"][0]["train"][f"{shape}/{mb}/{comp}"]
    jref, tag = runs["jax"], f"{mb}/{comp}"
    want = float(jref[f"{tag}/loss"])
    assert abs(got["loss"] - want) <= 1e-5 * abs(want)
    for kind in ("params", "m", "v"):
        _close(got[kind], {n: t.numpy() for n, t in
                           _jax_case(jref, tag, kind).items()}, kind,
               flips=comp == "int8")
    if mb == 1:
        assert abs(got["grad_loss"] - float(jref["grad/loss"])) <= \
            1e-5 * abs(want)
        _close(got["grads"], {n: t.numpy() for n, t in
                              _jax_case(jref, "grad", "grads").items()},
               "grads")


@pytest.mark.parametrize("shape", ranks.VARIANT_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ranks.VARIANTS)
def test_qk_norm_and_qkv_bias_variants(runs, name, shape):
    """Replicated scales and biases read by a rank's heads (``q_norm``,
    ``k_norm``, ``bk``/``bv`` where a rank keeps the KV head its query
    heads share) get the whole gradient; the placed ``init`` draws the
    one-process weights."""
    cfg = tiny_config(name, dtype="float32")
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(ranks.VARIANT_SEED)).trainable()
    step = make_train_step(model, ranks.train_config(1, "none"))
    params = model.params()
    loss, grads = step.gradients(params, runs["batch"])
    want_g = {n: g.detach().numpy() for n, g in grads.items()}
    params, _, _ = step.apply(params, init_opt_state(params), loss, grads)
    got = runs["world"][0]["variants"][f"{name}/{shape}"]
    assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    _close(got["grads"], want_g, f"{name} grads")
    # bk's gradient is zero but for rounding (a key bias shifts every
    # score of a query alike), so Adam's first step moves it by lr times
    # the sign of that noise, on both sides: its gradient is compared
    want_p = {n: p.detach().numpy() for n, p in params.items()
              if not n.endswith(".attn.bk")}
    _close({n: got["params"][n] for n in want_p}, want_p,
           f"{name} params")


def test_every_rank_holds_its_blocks(runs):
    whole = sum(t.numel() * t.element_size() for t in runs["full"].values())
    for r in runs["world"]:
        for key, case in r["train"].items():
            assert case["shapes_ok"], (r["rank"], key)
            # a quarter of the weights, but for the replicated norm scales
            assert whole / 4 <= case["bytes"] < whole / 4 + 4 * 64 * 6, key


def test_seq_sharded_decode_attention_matches_reference(runs):
    seq = runs["seq"]
    want = np.asarray(decode_attention_xla(
        jnp.asarray(seq["q"]), jnp.asarray(seq["kc"]),
        jnp.asarray(seq["vc"]), jnp.asarray(seq["pos"], jnp.int32)))
    outs = [r["seq_attention"] for r in runs["world"]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    assert float(np.abs(outs[0] - want).max()) < 1e-5


@pytest.mark.parametrize("mesh", ["(1, 2)", "(2, 2)", "(2, 1, 2) pod"])
def test_decode_over_a_process_mesh(runs, mesh):
    prompt = runs["prompt"][:1] if "pod" in mesh else runs["prompt"]
    logits, tokens = _one_process_decode(runs["full"], torch.tensor(prompt))
    slices = 4 if "pod" in mesh else 2
    for r in runs["world"]:
        got = r["decode"][mesh]
        assert got["cache_positions"] == ranks.DECODE_MAX_SEQ // slices
        b = prompt.shape[0] // (2 if mesh == "(2, 2)" else 1)
        rows = slice(got["data_shard"] * b, (got["data_shard"] + 1) * b)
        np.testing.assert_array_equal(got["tokens"], tokens[rows])
        np.testing.assert_allclose(got["logits"], logits[rows], rtol=0,
                                   atol=1e-4)


def test_elastic_restore_across_mesh_shapes(runs):
    for r in runs["world"]:
        ck = r["checkpoint"]
        assert ck["elastic_block"] and ck["elastic_step"] == 0
        np.testing.assert_array_equal(ck["elastic_whole"], runs["arr"])


def test_a_leaf_gathers_whole_onto_rank_0(runs):
    for r in runs["world"]:
        cases = r["checkpoint"]["gather_whole"]
        assert len(cases) == 8 and all(cases.values()), (r["rank"], cases)


def test_reference_checkpoint_restores_onto_a_process_mesh(runs):
    assert all(r["checkpoint"]["reference_blocks"] for r in runs["world"])


def test_run_training_restarts_onto_another_mesh_shape(runs):
    want = run_training(ranks.config(),
                        TrainConfig(warmup_steps=1, checkpoint_every=2),
                        ranks.data_config(), total_steps=6, device="cpu",
                        verbose=False).losses
    for r in runs["world"]:
        res = r["restart"]
        np.testing.assert_allclose(res["first"], want[:4], rtol=1e-5)
        for shape in ("(1, 4)", "(4, 1)"):
            assert res[shape]["restarts"] == 1
            np.testing.assert_allclose(res[shape]["losses"], want[4:],
                                       rtol=1e-5)


# ----------------------------------------------------------- (iv) guards

def _fake_mesh(shape):
    """A process mesh's shape and coordinates, no process group: enough
    for the guards, which raise before any collective."""
    return ProcessMesh(shape, ("data", "model"), 0, torch.device("cpu"),
                       "gloo", {})


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-1.5-large-398b",
                                  "whisper-large-v3", "internvl2-26b"])
def test_other_families_raise_over_a_process_mesh(request, name):
    """Every family is placed there (each rank its blocks: the Mamba
    in_proj_x, the encoder-decoder's decoder wq, the VLM's projector
    split over both axes) and decodes as one process does (the world's
    (2, 2) decode, weights drawn by the placed ``init``); an unplaced
    model under the process mesh's context raises, naming ``mesh=``.
    (Before the encoder-decoder and VLM families were placed, this test
    held their refusal.)"""
    cfg = tiny_config(name, dtype="float32")
    pm = _fake_mesh((2, 2))
    model = build_model(cfg, device="cpu", mesh=pm,
                        max_seq=ranks.DECODE_MAX_SEQ)
    place = model.placement
    assert place is not None
    assert all(tuple(p.shape) == place.block_shape(n)
               for n, p in model.params().items())
    D, hd = cfg.d_model, cfg.resolved_head_dim()
    if cfg.family in ("ssm", "hybrid"):
        split = model.layers[1].mamba.in_proj_x, (D // 2, cfg.d_inner // 2)
    elif cfg.family == "encdec":
        split = model.layers[0].self_attn.wq, (D // 2,
                                               cfg.num_heads * hd // 2)
    else:
        split = model.projector, (D // 2, D // 2)
    assert tuple(split[0].shape) == split[1]
    with use_shard_ctx(ShardCtx(pm)):
        with pytest.raises(ValueError, match="mesh="):
            build_model(cfg, device="cpu").decode(
                {}, torch.zeros((1, 1), dtype=torch.long), 0)
    prompt = torch.tensor(request.getfixturevalue("runs")["prompt"])
    one = build_model(cfg, device="cpu", max_seq=ranks.DECODE_MAX_SEQ).init(
        torch.Generator().manual_seed(ranks.VARIANT_SEED))
    n = ranks.family_cache_len(cfg)
    caches, logits = one.prefill(prompt, max_seq=n,
                                 **ranks.family_side(cfg, prompt.shape[0]))
    S = prompt.shape[1] + n - ranks.DECODE_MAX_SEQ
    out, toks = [logits], []
    for t in range(ranks.DECODE_STEPS):
        toks.append(out[-1][:, -1].argmax(-1, keepdim=True))
        caches, logits = one.decode(caches, toks[-1], S + t)
        out.append(logits)
    logits, toks = torch.cat(out, 1).numpy(), torch.cat(toks, 1).numpy()
    for r in request.getfixturevalue("runs")["world"]:
        got = r["families"][name]
        rows = slice(got["data_shard"], got["data_shard"] + 1)
        np.testing.assert_array_equal(got["tokens"], toks[rows])
        np.testing.assert_allclose(got["logits"], logits[rows], rtol=0,
                                   atol=1e-4)
    # one rank a process, no axis above 1: today's one-process path
    if cfg.family in ("encdec", "vlm"):
        assert build_model(cfg, device="cpu", max_seq=24,
                           mesh=_fake_mesh((1, 1))).placement is not None


def test_a_model_axis_that_does_not_divide_raises_for_an_moe_model():
    """A shared-expert width the model axis does not divide (90 over 4)
    takes the reference's replicated fallback: the shared expert is
    computed whole on every rank (its weights gathered from their
    blocks), the experts stay split; the same model over an axis that
    divides it is placed as before.  (Before the fallback, this test held
    the refusal; ``test_torch_gspmd_families.py`` holds the fallback's
    train step and decode to the reference.)"""
    cfg = tiny_config("qwen2-moe-a2.7b", d_ff_expert=90, dtype="float32")
    model = build_model(cfg, device="cpu", mesh=_fake_mesh((1, 4)))
    moe = model.layers[0].moe
    assert moe.whole == {"shared_wi", "shared_wg", "shared_wo",
                         "shared_gate"}
    assert moe.wi.shape[0] == model.placement.full["layers.0.moe.wi"][0] // 4
    assert moe.shared_wi.shape == (cfg.d_model, 90)   # 90 does not split
    assert all(tuple(p.shape) == model.placement.block_shape(n)
               for n, p in model.params().items())
    # the same model over an axis that divides it is placed
    placed = build_model(tiny_config("qwen2-moe-a2.7b", dtype="float32"),
                         device="cpu", mesh=_fake_mesh((1, 4)))
    assert placed.placement and not placed.layers[0].moe.whole


def test_a_dense_model_must_be_placed_over_a_process_mesh():
    """An unplaced model under a process mesh's context raises; 6 heads
    over a model axis of 4 take the reference's replicated fallback: the
    attention is computed whole on every rank, though each rank holds a
    quarter of ``wq``'s 96 columns (a head and a half).  (Before the
    fallback, the 6-head model raised.)"""
    cfg = tiny_config("llama3-8b", dtype="float32")
    model = build_model(cfg, device="cpu")
    with use_shard_ctx(ShardCtx(_fake_mesh((1, 2)))):
        with pytest.raises(ValueError, match="mesh="):
            model.prefill(torch.zeros((1, 4), dtype=torch.long))
    six = build_model(tiny_config("llama3-8b", num_heads=6, num_kv_heads=2,
                                  dtype="float32"), device="cpu",
                      mesh=_fake_mesh((1, 4)))
    attn = six.layers[0].attn
    assert attn.whole == {"wq", "wk", "wv", "wo"}
    assert attn.wq.shape == (64, 24) and attn.wo.shape == (24, 64)
    assert not six.layers[0].mlp.whole      # d_ff 128 splits four ways


# ------------------------------------- K5's partial mode, plain version

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_partials_of_slices_merge_to_the_reference(n):
    """The plain partial mode over ``n`` slices of the reference test's
    caches (slices past position 100 empty: o = 0, lse = -inf), merged in
    slice order: within 1e-5 of ``decode_attention_xla`` on the whole."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_partials, merge_partials)
    seq = _seq_inputs()
    want = np.asarray(decode_attention_xla(
        jnp.asarray(seq["q"]), jnp.asarray(seq["kc"]),
        jnp.asarray(seq["vc"]), jnp.asarray(seq["pos"], jnp.int32)))
    q = torch.tensor(seq["q"])
    kc, vc = torch.tensor(seq["kc"]), torch.tensor(seq["vc"])
    B, Smax, K, _ = kc.shape
    Sl = Smax // n
    parts = []
    for s in range(n):
        ln = min(max(seq["pos"] + 1 - s * Sl, 0), Sl)
        lengths = torch.full((B * K,), ln, dtype=torch.int32)
        o, lse = decode_attention_partials(q, kc[:, s * Sl:(s + 1) * Sl],
                                           vc[:, s * Sl:(s + 1) * Sl],
                                           lengths)
        if ln == 0:
            assert bool((o == 0).all()) and bool((lse == -np.inf).all())
        parts.append((o, lse))
    got = merge_partials(parts, q.dtype).numpy()
    assert float(np.abs(got - want).max()) < 1e-5
