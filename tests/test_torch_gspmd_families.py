"""The MoE, SSM and hybrid families over a process mesh: the FSDP and
tensor-parallel train step, the sharded decode and the elastic restore
of the tiny float32 ``qwen2-moe-a2.7b`` (at ``capacity_factor`` 1.25,
where copies overflow), ``phi3.5-moe-42b-a6.6b``, ``mamba2-1.3b`` and
``jamba-1.5-large-398b``, with one mesh position a process over
``torch.distributed`` (gloo, CPU).

One world of 4 ranks is spawned (``launch.procs.spawn``) and runs every
check (``torch_gspmd_families_ranks.py``); the JAX package's (2, 2) mesh
runs in one subprocess that sees 4 host devices, started before the world
and read after it.  Weights are the JAX package's (``params_from_jax``),
cut to each rank's blocks by ``shard_params``.

(i) The train step at (2, 2), (4, 1) and (1, 4): the loss within 1e-5
relative, the gathered gradients and updated parameters within 1e-4 of
each tensor's largest magnitude, against the one-process port and the
reference's step on its (2, 2) mesh (its ``make_train_step`` at one
microbatch: ``value_and_grad`` and ``adamw_update``, each jitted). An
updated element whose two gradients agree less closely than 1e-4
relative (near zero) is held within 2 lr: Adam's first step takes the
gradient's sign. The updated parameters, plain and after the int8
compression, are held at 1e-4 to the one-process step on the world's own
gradients, and the gradient norm to their one-process norm; every rank's
tensors have their block's shape under the reference's
``named_shardings``.
(ii) The MoE sort dispatch: every token's experts are the one-process
port's and the reference's (no token rerouted), and the copies it keeps
within the capacity are the ones the reference's (2, 2) mesh keeps (the
reference's ``moe_apply_sort`` wrapped in a jitted forward with its
layers unrolled, its own routing packed as its body packs it).
(iii) The decode at (1, 2) and (2, 2): a prefill and 3 greedy steps, the
one-process port's and the reference's (2, 2) mesh's tokens, their logits
within 1e-4, and the caches gathered whole within 1e-4 of each cache's
largest magnitude.
(iv) ``run_training`` at (2, 2), restarted from its checkpoint at (1, 4):
the losses of the one-process run and of the reference's step on its
(2, 2) mesh from the same first weights and batches, within 1e-5
relative.
"""
import json
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jax_build_model
from repro.testing import tiny_config as jax_tiny_config
from repro_torch.data.pipeline import batch_at, side_inputs
from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.procs import spawn
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import (build_model, params_from_jax,
                                      reference_leaf)
from repro_torch.models.transformer import layer_plan
from repro_torch.training.compression import compress_decompress
from repro_torch.training.optimizer import (adamw_update, global_norm,
                                            init_opt_state)
from repro_torch.training.train_loop import run_training

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_gspmd_families_ranks as ranks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ENV = {"OMP_NUM_THREADS": "1"}
B, S = 8, 16
NAMES = list(ranks.FAMILIES)
FALLBACKS = list(ranks.FALLBACKS)
ALL = NAMES + FALLBACKS
SHAPES = [f"{s}" for s in ranks.TRAIN_SHAPES]
# a case whose reference results are another's (the same model, weights
# and inputs; only the specs differ, which the reference gives for each)
SAME_AS = {"whisper-large-v3@fsdp": "whisper-large-v3"}

_REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.config import TrainConfig
from repro.distributed.sharding import (ShardCtx, named_shardings,
                                        use_shard_ctx)
from repro.launch.steps import opt_state_shardings
from repro.models import moe as X
from repro.models.layers import padded_experts
from repro.models.model import build_model
from repro.testing import tiny_config
from repro.training.optimizer import adamw_update, init_opt_state
assert jax.device_count() == 4
inp = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
steps = int(sys.argv[4])


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


def flat(tree, prefix, leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/", leaf))
        else:
            out[prefix + k] = leaf(v)
    return out


def pad(caches, n):
    # the attention caches (periods, B, S, K, hd) padded to n positions
    def one(kind, a):
        if kind not in ("k", "v"):
            return a
        return jnp.pad(a, [(0, 0), (0, 0), (0, n - a.shape[2]), (0, 0),
                           (0, 0)])
    if "k" in caches:           # the encoder-decoder's: one stack
        return {kind: one(kind, a) for kind, a in caches.items()}
    return {sub: {kind: one(kind, a) for kind, a in c.items()}
            for sub, c in caches.items()}


# the reference's sort dispatch, its own routing packed as its body packs
# it: each call's expert ids and whether each copy is kept
calls = []
sort_dispatch = X.moe_apply_sort


def recording(p, x, cfg):
    B, S, D = x.shape
    T, k = B * S, cfg.top_k
    w, idx = X._route(p, x.reshape(T, D), cfg)
    E, C = padded_experts(cfg.num_experts), X.capacity(cfg, T)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e)
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.cumsum(counts) - counts
    keep = (jnp.arange(T * k) - starts[flat_e[order]]) < C
    calls.append((idx, jnp.zeros_like(keep).at[order].set(keep)))
    return sort_dispatch(p, x, cfg)


out, specs = {}, {}
for name, case in cases.items():
    mesh = Mesh(np.array(jax.devices()).reshape(case["mesh"]),
                ("data", "model"))
    ctx = ShardCtx(mesh, param_sharding=case["sharding"])
    side = lambda pre: {k: jnp.asarray(inp[f"{name}/{pre}/{k}"])
                        for k in case["side"]}
    with use_shard_ctx(ctx), mesh:
        cfg = tiny_config(case["arch"], dtype="float32", **case["over"])
        model = build_model(cfg)
        p0 = nest(f"{name}/p/")
        ns = named_shardings(ctx, p0)
        specs[name] = flat(ns, "", lambda s: [
            list(e) if isinstance(e, tuple) else e for e in s.spec])
        if case["specs_only"]:
            continue
        params = jax.device_put(p0, ns)
        opt = jax.device_put(init_opt_state(params),
                             opt_state_shardings(ctx, params))
        batch = {k: jnp.asarray(inp["b/" + k]) for k in ("tokens", "labels",
                                                         "loss_mask")}
        batch.update(side("side"))
        # make_train_step at one microbatch without compression, its two
        # halves jitted apart: the gradients are an output too
        grad_fn = jax.jit(jax.value_and_grad(model.train_loss))
        update = jax.jit(lambda g, o, p: adamw_update(
            g, o, p, TrainConfig(warmup_steps=1)))
        loss, g = grad_fn(params, batch)
        p2, _, _ = update(g, opt, params)
        out[f"{name}/grad_loss"] = out[f"{name}/loss"] = np.asarray(loss)
        out.update(flat(g, f"{name}/grads/"))
        out.update(flat(p2, f"{name}/params/"))
        # the greedy decode: a prefill, its caches padded to the case's
        # cache length (a VLM's prompt starts with its patches)
        caches, logits = jax.jit(model.prefill)(
            params, {"tokens": jnp.asarray(inp["prompt"]),
                     **side("pside")})
        S = inp["prompt"].shape[1] + (cfg.vision_patches
                                      if cfg.family == "vlm" else 0)
        caches = pad(caches, case["cache"])
        step = jax.jit(model.decode)
        lg = [logits]
        for t in range(steps):
            tok = jnp.argmax(lg[-1][:, -1], -1)[:, None].astype(jnp.int32)
            out[f"{name}/decode/tokens/{t}"] = np.asarray(tok)
            caches, logits = step(params, caches, tok,
                                  jnp.asarray(S + t, jnp.int32))
            lg.append(logits)
        out[f"{name}/decode/logits"] = np.asarray(jnp.concatenate(lg, 1))
        out.update(flat(caches, f"{name}/decode/caches/"))
        # training from the restart's first weights, its batches
        if case["run"]:
            run = nest(f"{name}/init/")
            opt = init_opt_state(run)
            placed = (named_shardings(ctx, run),
                      opt_state_shardings(ctx, run))
            for k in range(int(inp["run_steps"])):
                # placed as the first step's inputs were: no new compile
                run, opt = jax.device_put((run, opt), placed)
                loss, g = grad_fn(run, {
                    **{n: jnp.asarray(inp[f"run/{k}/{n}"])
                       for n in ("tokens", "labels", "loss_mask")},
                    **side(f"runside/{k}")})
                run, opt, _ = update(g, opt, run)
                out[f"{name}/run_losses/{k}"] = np.asarray(loss)
        if case["routes"]:
            # the layers unrolled (scan_layers=False), so each layer's
            # packing leaves the jitted forward as an output
            unrolled = build_model(tiny_config(case["arch"],
                                               dtype="float32",
                                               scan_layers=False,
                                               **case["over"]))

            def routes(params, batch):
                calls.clear()
                unrolled.train_loss(params, batch)
                return list(calls)
            X.moe_apply_sort = recording
            got = jax.jit(routes)(params, batch)
            X.moe_apply_sort = sort_dispatch
            for i, (idx, keep) in enumerate(got):
                out[f"{name}/routes/{i}/idx"] = np.asarray(idx)
                out[f"{name}/routes/{i}/keep"] = np.asarray(keep)
np.savez(sys.argv[2], **out)
json.dump(specs, open(sys.argv[2] + ".json", "w"))
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


def _jax_tree(params, cfg):
    """The JAX package's parameter tree of the port's parameters:
    ``params_from_jax`` inverted (each layer's leaf stacked over the
    periods of its sub-layer; the encoder-decoder's over its encoder and
    decoder layers)."""
    encdec = cfg.family == "encdec"
    period = 1 if encdec else len(layer_plan(cfg))
    tree, layers = {"layers": {}}, {}
    for n, t in params.items():
        a = t.detach().numpy()
        head, _, rest = n.partition(".")
        if head in ("layers", "encoder"):
            j, group, leaf = rest.split(".")
            sub = (("dec" if head == "layers" else "enc") if encdec
                   else f"sub{int(j) % period}")
            layers.setdefault((sub, group, leaf), {})[int(j) // period] = a
        elif head == "enc_final_norm":
            tree["layers"].setdefault(head, {})[rest] = a
        elif head in ("embed", "lm_head", "projector"):
            tree[head] = {"table" if head == "embed" else "kernel": a}
        elif head == "pos_emb":
            tree[head] = a
        else:
            tree.setdefault(head, {})[rest] = a
    for (sub, group, leaf), by_p in layers.items():
        tree["layers"].setdefault(sub, {}).setdefault(group, {})[leaf] = \
            np.stack([by_p[p] for p in sorted(by_p)])
    return tree


def _port_caches(jref, name):
    """The reference's decode caches ({sub<i>: {kind: (periods, B, ...)}},
    or the encoder-decoder's {kind: (layers, B, ...)}) in the port's
    layout: stacked by kind in layer order, attention caches (B, K, S,
    hd)."""
    cfg = ranks.config(name)
    tree = _nest(jref, f"{name}/decode/caches/")
    attn = ("k", "v", "xk", "xv")
    if cfg.family == "encdec":
        return {k: a.transpose(0, 1, 3, 2, 4) for k, a in tree.items()}
    period = len(layer_plan(cfg))
    out = {}
    for j in range(cfg.num_layers):
        sub = tree[f"sub{j % period}"]
        for kind, a in sub.items():
            a = a[j // period]
            out.setdefault(kind, []).append(
                a.transpose(0, 2, 1, 3) if kind in attn else a)
    return {k: np.stack(v) for k, v in out.items()}


def _batch():
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, S + 1, B)
    lengths[0] = S
    return {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 256, (B, S)).astype(np.int32),
            "loss_mask": (np.arange(S)[None] < lengths[:, None]
                          ).astype(np.float32)}


def _np(d):
    return {n: t.detach().numpy() for n, t in d.items()}


def _model(name):
    """The one-process port of case ``name`` (its learned positions, where
    it has them, ``DECODE_MAX_SEQ`` rows, as the ranks')."""
    return build_model(ranks.config(name), device="cpu",
                       max_seq=ranks.DECODE_MAX_SEQ)


def _decode(model, prompt, side, max_seq):
    """A prefill into caches of ``cache_len`` positions and greedy steps:
    the logits, tokens and caches."""
    n = ranks.cache_len(model.cfg, max_seq)
    caches, logits = model.prefill(prompt, max_seq=n, **side)
    S0 = prompt.shape[1] + n - max_seq
    lg, toks = [logits], []
    for t in range(ranks.DECODE_STEPS):
        tok = lg[-1][:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
        caches, logits = model.decode(caches, tok, S0 + t)
        lg.append(logits)
    return dict(logits=torch.cat(lg, 1).numpy(),
                tokens=torch.cat(toks, 1).numpy(), caches=_np(caches))


def _one_process(name, full, batch, prompt):
    """The one-process port from ``full``: the train step's loss,
    gradients and updated parameters, the sort dispatch's packing, the
    decode's logits, tokens and caches (one decode a cache length of a
    fallback case)."""
    cfg = ranks.config(name)
    model = _model(name).load_params(full).trainable()
    batch = {**batch, **ranks.side(cfg, B, 11)}
    out = {}
    if name in ranks.MOE:
        with ranks.RouteRecorder() as rec, torch.no_grad():
            model.train_loss(batch)
        out["routes"] = rec.calls
    step = make_train_step(model, ranks.train_config())
    params = model.params()
    loss, grads = step.gradients(params, batch)
    out.update(grad_loss=float(loss), grads=_np(grads))
    params, _, metrics = step.apply(params, init_opt_state(params), loss,
                                    grads)
    out.update(loss=float(metrics["loss"]), params=_np(params))
    model = _model(name).load_params(full)
    prompt = torch.as_tensor(prompt)
    side = ranks.side(cfg, prompt.shape[0], 12)
    lens = (ranks.FALLBACK_MAX_SEQS if name in ranks.FALLBACKS
            else (ranks.DECODE_MAX_SEQ,))
    out["decode"] = {n: _decode(model, prompt, side, n) for n in lens}
    out.update(out["decode"][ranks.DECODE_MAX_SEQ])
    return out


def _case(name):
    """What the reference's subprocess runs for case ``name``."""
    cfg = ranks.config(name)
    fb = name in ranks.FALLBACKS
    return {"arch": ranks.arch(name),
            "over": (ranks.FALLBACKS if fb else ranks.FAMILIES)[name],
            "sharding": ranks.SHARDING.get(name, "fsdp"),
            "mesh": list(ranks.FALLBACK_MESH if fb else (2, 2)),
            "cache": ranks.cache_len(cfg, max(ranks.FALLBACK_MAX_SEQS)
                                     if fb else ranks.DECODE_MAX_SEQ),
            "side": sorted(ranks.side(cfg, 1, 0)), "run": not fb,
            "routes": name in ranks.MOE,
            "specs_only": name in SAME_AS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd_families")
    batch = _batch()
    prompt = np.random.default_rng(8).integers(0, 256, (2, 7))
    cases = {name: _case(name) for name in ALL}
    arrays, trees = {}, {}
    for name in ALL:
        cfg = ranks.config(name)
        jm = jax_build_model(jax_tiny_config(ranks.arch(name),
                                             dtype="float32",
                                             **cases[name]["over"]))
        trees[name] = jax.tree_util.tree_map(np.asarray, jax.jit(partial(
            jm.init, max_seq=ranks.DECODE_MAX_SEQ))(jax.random.PRNGKey(0)))
        arrays.update(_flat(trees[name], f"{name}/p/"))
        for pre, rows, seed in (("side", B, 11), ("pside", 2, 12)):
            arrays.update({f"{name}/{pre}/{k}": v.numpy() for k, v in
                           ranks.side(cfg, rows, seed).items()})
    for name in NAMES:      # the restart's first weights (its draw)
        cfg = ranks.config(name)
        dcfg = ranks.data_config()
        first = build_model(cfg, device="cpu").init(torch.Generator(
            device="cpu").manual_seed(dcfg.seed)).params()
        arrays.update(_flat(_jax_tree(first, cfg), f"{name}/init/"))
        for k in range(ranks.RESTART_STEPS[1]):     # and batches
            arrays.update({f"{name}/runside/{k}/{n}": v for n, v in
                           side_inputs(cfg, dcfg, k).items()})
    for k in range(ranks.RESTART_STEPS[1]):
        arrays.update({f"run/{k}/{n}": v for n, v in
                       batch_at(ranks.data_config(), k).items()})
    np.savez(tmp / "in.npz", **arrays,
             **{f"b/{k}": v for k, v in batch.items()},
             prompt=prompt.astype(np.int32),
             run_steps=np.asarray(ranks.RESTART_STEPS[1]))
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                            str(tmp / "in.npz"), str(tmp / "out.npz"),
                            json.dumps(cases), str(ranks.DECODE_STEPS)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    full = {name: params_from_jax(t) for name, t in trees.items()}
    inp = {"params": {name: {n: t.numpy() for n, t in f.items()}
                      for name, f in full.items()},
           "batch": batch, "prompt": prompt, "tmp": str(tmp)}
    world = spawn(ranks.run_world, 4, inp, env=ENV, timeout_s=900.0)
    out, err = ref.communicate(timeout=900)
    assert ref.returncode == 0, err[-3000:]
    jref = dict(np.load(tmp / "out.npz"))
    for name, same in SAME_AS.items():
        jref.update({f"{name}/{k[len(same) + 1:]}": v for k, v in
                     list(jref.items()) if k.startswith(f"{same}/")})
    specs = json.load(open(tmp / "out.npz.json"))
    torch.manual_seed(0)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    one = {name: _one_process(name, full[name], tb, prompt)
           for name in ALL}
    return {"world": world, "jax": jref, "specs": specs, "one": one,
            "full": full, "prompt": prompt}


def _close(got, want, what):
    """Each tensor within 1e-4 of its largest magnitude."""
    assert set(got) == set(want), what
    for n, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[n], w, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"{what} {n}")


def _close_update(got, want, got_g, want_g, what):
    """Updated parameters within 1e-4 of each tensor's largest magnitude
    where the element's two gradients agree to 1e-4 relative: Adam's step
    is a function of the element's own gradient, ``lr * g / (|g| +
    eps)`` on the first step.  Elsewhere (gradients near zero, which
    agree only within their tensor's tolerance) the two first steps may
    take opposite signs: within 2 lr."""
    lr = ranks.train_config().learning_rate
    assert set(got) == set(want), what
    for n, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        sure = np.abs(got_g[n] - want_g[n]) <= 1e-4 * np.abs(want_g[n])
        diff = np.abs(got[n] - w)
        assert float(diff[sure].max(initial=0)) <= 1e-4 * scale, \
            f"{what} {n}"
        assert float(diff[~sure].max(initial=0)) <= 2 * lr + 1e-4 * scale, \
            f"{what} {n} (gradients near zero)"


def _update_from(full, name, grads, comp="none"):
    """The one-process AdamW step (after the int8 compression with
    ``comp="int8"``) on given gradients."""
    cfg = ranks.config(name)
    model = _model(name).load_params(full)
    params = model.params()
    g = {n: torch.tensor(a) for n, a in grads.items()}
    if comp == "int8":
        g = compress_decompress(g, len(layer_plan(cfg)))
    params, _, _ = adamw_update(g, init_opt_state(params), params,
                                ranks.train_config(comp))
    return _np(params)


def _jax(runs, name, kind):
    return {n: t.numpy() for n, t in params_from_jax(
        _nest(runs["jax"], f"{name}/{kind}/")).items()}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_one_process(runs, name, shape):
    got = runs["world"][0][name]["train"][shape]
    want = runs["one"][name]
    for key in ("grad_loss", "loss"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key
    _close(got["grads"], want["grads"], f"{name} {shape} grads")
    _close(got["params"], _update_from(runs["full"][name], name,
                                       got["grads"]),
           f"{name} {shape} params from its own gradients")
    _close_update(got["params"], want["params"], got["grads"],
                  want["grads"], f"{name} {shape} params")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_global_norm_and_int8_scales_cover_every_leaf(runs, name, shape):
    """The step's gradient norm counts every block once over the mesh
    (the one-process norm of the gathered gradients), and the int8
    compression scales each of the reference's leaves by its largest
    magnitude over every block: the world's updates from its own
    gradients are the one-process compression and AdamW's."""
    got = runs["world"][0][name]["train"][shape]
    want = float(global_norm({n: torch.tensor(a)
                              for n, a in got["grads"].items()}))
    assert abs(got["grad_norm"] - want) <= 1e-5 * want
    _close(got["params_int8"], _update_from(runs["full"][name], name,
                                            got["grads"], "int8"),
           f"{name} {shape} int8 params from its own gradients")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_the_reference_mesh(runs, name, shape):
    got = runs["world"][0][name]["train"][shape]
    jref = runs["jax"]
    for key in ("grad_loss", "loss"):
        want = float(jref[f"{name}/{key}"])
        assert abs(got[key] - want) <= 1e-5 * abs(want), key
    grads = _jax(runs, name, "grads")
    _close(got["grads"], grads, f"{name} grads")
    _close_update(got["params"], _jax(runs, name, "params"), got["grads"],
                  grads, f"{name} params")


# the reference's leaf of the port's whole-tensor names
_LEAVES = {"embed": "embed/table", "lm_head": "lm_head/kernel",
           "projector": "projector/kernel"}


def _reference_entries(ref, n, cfg):
    """The reference's spec of the port's parameter ``n`` (``ref``: its
    ``named_shardings`` by leaf path), less a layer's stacked dim."""
    head, _, rest = n.partition(".")
    if cfg.family == "encdec" and head in ("encoder", "layers",
                                           "enc_final_norm"):
        if head == "enc_final_norm":
            path = f"layers/{n.replace('.', '/')}"
        else:
            _, tail = rest.split(".", 1)
            path = (f"layers/{'enc' if head == 'encoder' else 'dec'}/"
                    f"{tail.replace('.', '/')}")
    else:
        leaf = reference_leaf(n, len(layer_plan(cfg)))
        path = _LEAVES.get(leaf, leaf.replace(".", "/"))
    entries = [tuple(e) if isinstance(e, list) else e for e in ref[path]]
    return entries[1:] if head in ("layers", "encoder") else entries


def _blocks_are_named_shardings(runs, name, ref_shape):
    """Each rank's tensors are its blocks under the reference's
    ``named_shardings`` at ``ref_shape``, and their bytes those blocks'
    bytes, at every mesh the case trains over."""
    ref = runs["specs"][name]
    cfg = ranks.config(name)
    full = runs["full"][name]
    for r in runs["world"]:
        for shape, case in r[name]["train"].items():
            assert case["shapes_ok"], (r["rank"], shape)
            sizes = dict(zip(ranks.AXES, (int(c) for c in
                                          shape.strip("()").split(","))))
            want = 0
            for n, spec in case["specs"].items():
                blocks = int(np.prod([sizes[a] for e in spec if e
                                      for a in (e if isinstance(e, tuple)
                                                else (e,))]))
                want += full[n].numel() * full[n].element_size() // blocks
            assert case["bytes"] == want, (r["rank"], shape)
        for n, spec in r[name]["train"][ref_shape]["specs"].items():
            entries = _reference_entries(ref, n, cfg)
            entries += [None] * (len(spec) - len(entries))
            assert tuple(entries) == spec, (n, entries, spec)


@pytest.mark.parametrize("name", NAMES)
def test_every_rank_holds_the_blocks_named_shardings_gives_it(runs, name):
    """Each rank's tensors are its blocks under the reference's
    ``named_shardings`` at (2, 2) (a layer's stacked leaf less its period
    dim; at the case's ``param_sharding``: Whisper's learned positions
    replicated under its "dp", split over the data axes under "fsdp"),
    and their bytes those blocks' bytes, at every mesh."""
    _blocks_are_named_shardings(runs, name, "(2, 2)")
    specs = runs["world"][0][name]["train"]["(2, 2)"]["specs"]
    if "pos_emb" in specs:
        assert specs["pos_emb"] == ((None, "data") if ranks.SHARDING.get(
            name, "fsdp") == "fsdp" else (None, None))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ranks.MOE)
def test_no_token_is_rerouted(runs, name, shape):
    """Every sort dispatch of the placed model routes every token of the
    global batch to the experts the one-process port and the reference
    route it to."""
    want = runs["one"][name]["routes"]
    jref = runs["jax"]
    for r in runs["world"]:
        got = r[name]["train"][shape]["routes"]
        assert len(got) == len(want) == ranks.config(name).num_layers
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g["idx"], w["idx"])
            np.testing.assert_array_equal(g["idx"],
                                          jref[f"{name}/routes/{i}/idx"])


@pytest.mark.parametrize("name", ranks.MOE)
def test_sort_dispatch_keeps_the_reference_copies(runs, name):
    """The copies kept within the global capacity, on every rank at every
    mesh, are those the reference's (2, 2) mesh keeps; at capacity_factor
    1.25 some overflow."""
    jref = runs["jax"]
    for r in runs["world"]:
        for shape in SHAPES:
            for i, g in enumerate(r[name]["train"][shape]["routes"]):
                np.testing.assert_array_equal(
                    g["keep"], jref[f"{name}/routes/{i}/keep"].reshape(-1))
    keeps = [c["keep"] for c in runs["one"][name]["routes"]]
    overflow = ranks.config(name).capacity_factor < 2
    assert all(not k.all() for k in keeps) == overflow


def _decode_matches(runs, name, got, want, rows, what):
    """One rank's decode against the one-process port's and the
    reference's rows: tokens equal, logits within 1e-4."""
    jref = runs["jax"]
    ref_logits = jref[f"{name}/decode/logits"]
    ref_tokens = np.concatenate([jref[f"{name}/decode/tokens/{t}"]
                                 for t in range(ranks.DECODE_STEPS)], 1)
    np.testing.assert_array_equal(got["tokens"], want["tokens"][rows], what)
    np.testing.assert_allclose(got["logits"], want["logits"][rows], rtol=0,
                               atol=1e-4, err_msg=what)
    np.testing.assert_array_equal(got["tokens"], ref_tokens[rows], what)
    np.testing.assert_allclose(got["logits"], ref_logits[rows], rtol=0,
                               atol=1e-4, err_msg=what)


def _positions(caches, n):
    """The attention caches cut or zero-padded to ``n`` positions."""
    out = {}
    for k, a in caches.items():
        if k in ("k", "v") and a.shape[3] != n:
            widths = [(0, 0)] * a.ndim
            widths[3] = (0, max(n - a.shape[3], 0))
            a = np.pad(a, widths)[:, :, :, :n]
        out[k] = a
    return out


@pytest.mark.parametrize("mesh", ["(1, 2)", "(2, 2)"])
@pytest.mark.parametrize("name", NAMES)
def test_decode_over_a_process_mesh(runs, name, mesh):
    want = runs["one"][name]
    nd = 2 if mesh == "(2, 2)" else 1
    for r in runs["world"]:
        got = r[name]["decode"][mesh]
        b = want["tokens"].shape[0] // nd
        rows = slice(got["data_shard"] * b, (got["data_shard"] + 1) * b)
        _decode_matches(runs, name, got, want, rows, f"{name} {mesh}")
        if r["rank"] == 0:
            _close(got["caches"], want["caches"], f"{name} {mesh} caches")
            ref = _port_caches(runs["jax"], name)
            _close(got["caches"], _positions(ref, ranks.cache_len(
                ranks.config(name))), f"{name} {mesh} caches, the "
                "reference's")
        for k, (shape, spec) in got["cache_shapes"].items():
            whole = want["caches"][k].shape
            if k in ("k", "v"):     # this rank's slice of the positions
                assert shape[3] == whole[3] // 2 and spec[3] == "model"
            elif k in ("xk", "xv"):     # every KV head and frame
                assert shape[2:] == whole[2:] and set(spec[2:]) == {None}
            else:                   # its heads or its channels
                assert shape[2 if k == "ssm" else 3] * 2 == \
                    whole[2 if k == "ssm" else 3], k
            assert shape[1] * nd == whole[1], k


@pytest.mark.parametrize("name", NAMES)
def test_run_training_restarts_onto_another_mesh_shape(runs, name):
    first, total = ranks.RESTART_STEPS
    want = run_training(ranks.config(name), ranks.train_config(),
                        ranks.data_config(), total_steps=total,
                        device="cpu", verbose=False).losses
    ref = [float(runs["jax"][f"{name}/run_losses/{k}"])
           for k in range(total)]
    np.testing.assert_allclose(want, ref, rtol=1e-5)
    for r in runs["world"]:
        res = r[name]["restart"]
        assert res["restarts"] == 1
        for got in (res["first"] + res["losses"],):
            np.testing.assert_allclose(got, want, rtol=1e-5)
            np.testing.assert_allclose(got, ref, rtol=1e-5)


# ------------------------------------ the divisibility fallback at (1, 4)

@pytest.mark.parametrize("name", FALLBACKS)
def test_fallback_train_step_matches_one_process_and_the_reference(runs,
                                                                   name):
    """A layer whose heads or width the model axis does not divide is
    computed whole on every rank from its weights' blocks: the train step
    at (1, 4) against the one-process port and the reference's own (1, 4)
    mesh (loss within 1e-5 relative, gradients within 1e-4 of each
    tensor's largest magnitude, the updated parameters as the families'
    are held)."""
    shape = f"{ranks.FALLBACK_MESH}"
    got = runs["world"][0][name]["train"][shape]
    want = runs["one"][name]
    jref = runs["jax"]
    for key in ("grad_loss", "loss"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key
        ref = float(jref[f"{name}/{key}"])
        assert abs(got[key] - ref) <= 1e-5 * abs(ref), key
    _close(got["grads"], want["grads"], f"{name} grads")
    grads = _jax(runs, name, "grads")
    _close(got["grads"], grads, f"{name} grads, the reference's")
    _close(got["params"], _update_from(runs["full"][name], name,
                                       got["grads"]),
           f"{name} params from its own gradients")
    _close_update(got["params"], want["params"], got["grads"],
                  want["grads"], f"{name} params")
    _close_update(got["params"], _jax(runs, name, "params"), got["grads"],
                  grads, f"{name} params, the reference's")


@pytest.mark.parametrize("name", FALLBACKS)
def test_fallback_blocks_are_named_shardings(runs, name):
    """Each rank holds exactly its blocks under the reference's
    ``named_shardings`` at (1, 4), though they split a layer computed
    whole (the 6-head ``wq``'s 96 columns four ways, in the middle of a
    head; the 2-head Mamba's ``d_inner``)."""
    shape = f"{ranks.FALLBACK_MESH}"
    _blocks_are_named_shardings(runs, name, shape)
    specs = runs["world"][0][name]["train"][shape]["specs"]
    split = {"llama3-8b@6-heads": "layers.0.attn.wq",
             "qwen2-moe-a2.7b@d_ff_expert-90": "layers.0.moe.wi",
             "mamba2-1.3b@2-heads": "layers.0.mamba.in_proj_x"}[name]
    assert specs[split][-1] == "model" or specs[split][0] == "model"


@pytest.mark.parametrize("max_seq", ranks.FALLBACK_MAX_SEQS)
@pytest.mark.parametrize("name", FALLBACKS)
def test_fallback_decode(runs, name, max_seq):
    """The decode at (1, 4) with the layers the axis does not divide
    computed whole: caches of 16 positions split four ways (the decode
    kernel's partial mode), and of 18, which the seq axis does not divide,
    kept whole on every rank (its normal mode); tokens equal, logits
    within 1e-4, caches within 1e-4 of the one-process port's and the
    reference's, each cache its block under ``cache_shardings``."""
    want = runs["one"][name]["decode"][max_seq]
    ref = _port_caches(runs["jax"], name)
    for r in runs["world"]:
        got = r[name]["decode"][max_seq]
        _decode_matches(runs, name, got, want, slice(None),
                        f"{name} {max_seq}")
        assert got["seq_split"] == (max_seq % 4 == 0)
        if r["rank"] == 0:
            _close(got["caches"], want["caches"], f"{name} caches")
            _close(got["caches"], _positions(ref, max_seq),
                   f"{name} caches, the reference's")
        for k, (shape, spec) in got["cache_shapes"].items():
            whole = want["caches"][k].shape
            blocks = [4 if e == "model" else 1 for e in spec]
            assert tuple(shape) == tuple(w // b for w, b in
                                         zip(whole, blocks)), k
            if k in ("k", "v"):
                assert (spec[3] == "model") == got["seq_split"], k


def test_placed_ep_dispatch_matches_one_process(runs):
    """``moe_impl="ep"`` on a placed expert share (``expert_share=False``):
    each rank's data shard of the prefill logits, and the gradients of a
    train step gathered whole, against the one-process EP body over a
    logical (2, 2) mesh."""
    name = ranks.EP_NAME
    cfg = ranks.ep_config()
    model = build_model(cfg, device="cpu").load_params(
        runs["full"][name]).trainable()
    batch = {k: torch.tensor(v) for k, v in _batch().items()}
    prompt = torch.tensor(runs["prompt"])
    with use_shard_ctx(ShardCtx(make_mesh((2, 2), ranks.AXES))):
        loss, grads = make_train_step(model, ranks.train_config()) \
            .gradients(model.params(), batch)
        with torch.no_grad():
            _, logits = model.prefill(prompt)
    for r in runs["world"]:
        got = r["ep"]
        b = prompt.shape[0] // 2
        rows = slice(got["data_shard"] * b, (got["data_shard"] + 1) * b)
        np.testing.assert_allclose(got["logits"], logits[rows].numpy(),
                                   rtol=0, atol=1e-4)
    got = runs["world"][0]["ep"]
    assert got["placed"] and got["experts"] == 8
    assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    _close(got["grads"], _np(grads), "EP grads")


@pytest.mark.parametrize("wrap", [False, True],
                         ids=["ProcessMesh", "ShardCtx"])
def test_expert_share_is_chosen_by_name_not_by_mesh_type(wrap):
    """An ``moe_impl="ep"`` model over a process mesh keeps the expert
    share whether the mesh comes bare or in a ``ShardCtx``;
    ``expert_share=False`` places it, as ``shard_params`` cuts it."""
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.models.layers import padded_experts
    cfg = ranks.ep_config()
    pm = ProcessMesh((2, 2), ranks.AXES, 1, torch.device("cpu"), "gloo", {})
    mesh = ShardCtx(pm) if wrap else pm
    share = build_model(cfg, device="cpu", mesh=mesh)
    full = build_model(cfg, device="cpu").init(torch.Generator()
                                               .manual_seed(0)).params()
    rows = padded_experts(cfg.num_experts) // 2
    assert share.placement is None
    assert share.layers[0].moe.wi.shape[0] == rows
    assert shard_params(full, mesh, cfg)["layers.0.moe.wi"].shape[0] == rows
    placed = build_model(cfg, device="cpu", mesh=mesh, expert_share=False)
    cut = shard_params(full, mesh, cfg, expert_share=False)
    assert placed.placement is not None
    assert all(tuple(t.shape) == placed.placement.block_shape(n)
               for n, t in cut.items())
