"""The port's SSM and hybrid families against the JAX package on the CPU.

* The Mamba2 layer: ``mamba_apply`` (the prefill, through K7's plain
  version) and eight ``mamba_decode`` steps, caches included.
* The tiny ``mamba2-1.3b`` model: prefill logits, eight teacher-forced
  decode steps and the caches, with JAX-drawn weights carried across by
  ``params_from_jax``.
* The tiny ``jamba-1.5-large-398b`` (two periods of 8: attention in layer 0
  of each, MoE in every second layer): the same in float32, and
  ``params_from_jax`` / ``lora_from_jax`` on its period-8 tree.
* The engine on both against the JAX engine, and ``serve`` on the SSM
  model.

Tolerances: 1e-4 in float32 and 5e-2 in bfloat16, those of
``tests/test_torch_model.py``.  The bfloat16 Jamba is the exception: over
its 16 layers the JAX model's own bfloat16 logits lie 0.77 from its float32
logits (the two frameworks round bfloat16 elementwise chains at other
places), so no port can be held to them at 5e-2: each of its layers is
held to the reference's at 5e-2 instead, on the same input."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.models.model import build_model as jax_build_model
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.lora import LoraAdapter as JaxLoraAdapter
from repro.testing import tiny_config as jax_tiny_config
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.model import build_model, params_from_jax
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.serving.lora import lora_from_jax
from repro_torch.testing import tiny_config

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
N_DECODE = 8
SSM, HYBRID = "mamba2-1.3b", "jamba-1.5-large-398b"


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(port, want, tol, msg=""):
    np.testing.assert_allclose(port.float().numpy(), _f32(want), rtol=tol,
                               atol=tol, err_msg=msg)


# ---------------------------------------------------------------- the layer
def _layer(dtype, seed=0):
    jcfg = jax_tiny_config(SSM, dtype=dtype)
    cfg = tiny_config(SSM, dtype=dtype)
    jd, td = DTYPES[dtype]
    p = JM.mamba_params(jax.random.PRNGKey(seed), jcfg, n=1, dtype=jd)
    p = jax.tree_util.tree_map(lambda a: a[0], p)
    m = M.Mamba(cfg, td, "cpu")
    own = dict(m.named_parameters())
    assert set(own) == set(p)
    with torch.no_grad():
        for k, v in p.items():
            assert tuple(own[k].shape) == v.shape, k
            own[k].copy_(torch.tensor(np.asarray(v, np.float32)))
    return jcfg, cfg, p, m


@pytest.mark.parametrize("S", [11, 20])     # one ragged chunk of 8; several
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_layer_matches_jax(dtype, S):
    jcfg, cfg, p, m = _layer(dtype)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, S + N_DECODE, cfg.d_model)).astype(np.float32)
    ju, tu = jnp.asarray(u, jd), torch.from_numpy(u).to(td)
    tol = TOL[dtype]
    jout, jcache = jax.jit(lambda p, u: JM.mamba_apply(p, u, jcfg))(
        p, ju[:, :S])
    k1 = cfg.ssm_conv - 1
    cache = {"ssm": torch.zeros((2, cfg.ssm_heads, cfg.ssm_state,
                                 cfg.ssm_head_dim)),
             "conv_x": torch.zeros((2, k1, cfg.d_inner), dtype=td),
             "conv_b": torch.zeros((2, k1, cfg.ssm_state), dtype=td),
             "conv_c": torch.zeros((2, k1, cfg.ssm_state), dtype=td)}
    out = M.mamba_apply(m, tu[:, :S], cfg, cache)
    assert out.dtype == td and tuple(out.shape) == (2, S, cfg.d_model)
    _close(out, jout, tol)
    for n in cache:
        _close(cache[n], jcache[n], tol, n)
    jdec = jax.jit(lambda p, c, u: JM.mamba_decode(p, c, u, jcfg))
    for t in range(S, S + N_DECODE):
        jout, jcache = jdec(p, jcache, ju[:, t:t + 1])
        out = M.mamba_decode(m, cache, tu[:, t:t + 1], cfg)
        _close(out, jout, tol, f"decode step {t - S}")
    for n in cache:
        _close(cache[n], jcache[n], tol, n)


def test_softplus_is_the_references_above_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.0, 20.5, 40.0, 100.0])
    np.testing.assert_allclose(M.softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(x.numpy())),
                               rtol=1e-7, atol=0)


def test_a_short_prompt_decodes_from_zero_padded_windows():
    """A prompt shorter than the conv's k - 1 inputs: the windows start
    with zero rows, as the causal conv pads, so prefilling one token and
    decoding two gives the logits of prefilling all three."""
    cfg = tiny_config(SSM, dtype="float32")
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(2))
    toks = torch.tensor([[5, 17, 99]])
    caches, _ = m.prefill(toks[:, :1])
    for t in (1, 2):
        caches, logits = m.decode(caches, toks[:, t:t + 1], t)
    _, want = m.prefill(toks)
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- the models
def _models(name, dtype, seed=3, **kw):
    jm = jax_build_model(jax_tiny_config(name, dtype=dtype, **kw))
    jp = jm.init(jax.random.PRNGKey(seed))
    pm = build_model(tiny_config(name, dtype=dtype, **kw), device="cpu")
    pm.load_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    return jm, jp, pm


def _port_caches(jc, pm, i, period):
    """The JAX caches {"sub<i>": {name: (n_periods, ...)}} of the port's
    kind-stacked cache ``i`` (k/v transposed to the port's layout)."""
    subs = [f"sub{s}" for s in range(period) if i in jc[f"sub{s}"]]
    parts = [_f32(jc[s][i]) for s in subs]
    a = np.stack([parts[k][p] for p in range(parts[0].shape[0])
                  for k in range(len(parts))])
    return a.transpose(0, 1, 3, 2, 4) if i in ("k", "v") else a


def _run_both(jm, jp, pm, S=11, Smax=24):
    """Prefill and eight teacher-forced decode steps on both sides: the
    logits of every step and the final caches."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 256, (2, S)).astype(np.int32)
    forced = rng.integers(1, 256, (2, N_DECODE)).astype(np.int32)
    jc, jl = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)})
    pc, pl = pm.prefill(torch.as_tensor(prompt, dtype=torch.long))
    jls, pls = [jl], [pl]
    pad = [(0, 0)] * 5
    pad[2] = (0, Smax - S)
    jc = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.pad(a, pad) if path[-1].key in ("k", "v") else a,
        jc)
    big = pm.new_caches(2, Smax)
    for n, t in pc.items():
        if n in ("k", "v"):
            big[n][:, :, :, :S] = t
        else:
            big[n].copy_(t)
    jdec = jax.jit(jm.decode)
    for t in range(N_DECODE):
        tok = forced[:, t:t + 1]
        jc, jl = jdec(jp, jc, jnp.asarray(tok), jnp.asarray(S + t, jnp.int32))
        big, pl = pm.decode(big, torch.as_tensor(tok, dtype=torch.long),
                            S + t)
        jls.append(jl)
        pls.append(pl)
    return jls, pls, jc, big


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssm_model_matches_jax(dtype):
    jm, jp, pm = _models(SSM, dtype)
    assert [layer.mixer for layer in pm.layers] == ["mamba", "mamba"]
    jls, pls, jc, caches = _run_both(jm, jp, pm)
    tol = TOL[dtype]
    for t, (pl, jl) in enumerate(zip(pls, jls)):
        assert pl.dtype == torch.float32
        _close(pl, jl, tol, f"step {t}")
    assert set(caches) == {"ssm", "conv_x", "conv_b", "conv_c"}
    for n in caches:
        np.testing.assert_allclose(caches[n].float().numpy(),
                                   _port_caches(jc, pm, n, 1), rtol=tol,
                                   atol=tol, err_msg=n)


def test_hybrid_model_matches_jax():
    jm, jp, pm = _models(HYBRID, "float32")
    kinds = [(layer.mixer, layer.ffn) for layer in pm.layers]
    assert len(kinds) == 16 and kinds[0] == kinds[8] == ("attn", "dense")
    assert kinds[1] == ("mamba", "moe") and kinds[2] == ("mamba", "dense")
    assert (pm.n_attn, pm.n_mamba) == (2, 14)
    jls, pls, jc, caches = _run_both(jm, jp, pm)
    for t, (pl, jl) in enumerate(zip(pls, jls)):
        _close(pl, jl, TOL["float32"], f"step {t}")
    assert set(caches) == {"k", "v", "ssm", "conv_x", "conv_b", "conv_c"}
    for n in caches:
        np.testing.assert_allclose(caches[n].numpy(),
                                   _port_caches(jc, pm, n, 8), rtol=1e-4,
                                   atol=1e-4, err_msg=n)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_hybrid_layers_match_jax(dtype):
    """Each of the eight sub-layers of a Jamba period (attention + MLP,
    Mamba + MoE, Mamba + MLP) on the same input as the reference's
    ``_apply_sub``: a prefill, then three decode steps, outputs within the
    model tolerance in both dtypes (the whole bfloat16 model is not
    comparable, see the module's docstring)."""
    jm, jp, pm = _models(HYBRID, dtype)
    cfg, jcfg = pm.cfg, jm.cfg
    jd, td = DTYPES[dtype]
    tol = TOL[dtype]
    B, S, Smax = 2, 11, 16
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S + 3, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    pc, caches = pm.new_caches(B, S), pm.new_caches(B, Smax)
    hd = cfg.resolved_head_dim()
    for j, (kind, layer) in enumerate(zip(JT.layer_plan(jcfg), pm.layers)):
        assert kind == (layer.mixer, layer.ffn)
        sub = jax.tree_util.tree_map(lambda a: a[0], jp["layers"][f"sub{j}"])

        def jrun(h, mode, cache, pos, positions):
            return jax.jit(lambda p, h, c, q: JT._apply_sub(
                p, h, jcfg, kind, mode, positions, c, q))(sub, h, cache, pos)

        jout, jcache = jrun(jx[:, :S], "prefill", None, None, jnp.arange(S))
        rope = L.rope_tables(torch.arange(S), hd, cfg.rope_theta)
        out = layer.run(tx[:, :S], cfg, "prefill", rope, pc)
        _close(out, jout, tol, f"sub{j} prefill")
        for n, c in pc.items():
            if n in ("k", "v"):
                caches[n][:, :, :, :S] = c
            else:
                caches[n].copy_(c)
        if kind[0] == "attn":
            pad = [(0, 0), (0, Smax - S), (0, 0), (0, 0)]
            jcache = {n: jnp.pad(a, pad) for n, a in jcache.items()}
        for t in range(S, S + 3):
            pos = jnp.asarray(t, jnp.int32)
            jout, jcache = jrun(jx[:, t:t + 1], "decode", jcache, pos,
                                pos[None])
            rope = L.rope_tables(torch.arange(t, t + 1), hd, cfg.rope_theta)
            lengths = torch.full((B * cfg.num_kv_heads,), t + 1,
                                 dtype=torch.int32)
            out = layer.run(tx[:, t:t + 1], cfg, "decode", rope, caches, t,
                            lengths)
            _close(out, jout, tol, f"sub{j} decode at {t}")


def test_params_from_jax_takes_a_period_8_tree():
    """Period p, sub-layer i of the JAX tree is port layer 8 p + i; the
    Mamba leaves keep their orientation and float32 leaves stay float32."""
    jm, jp, pm = _models(HYBRID, "bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    conv = params_from_jax(tree)
    assert set(conv) == set(pm.params())
    subs = tree["layers"]
    np.testing.assert_array_equal(conv["layers.8.attn.wq"].numpy(),
                                  _f32(subs["sub0"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(conv["layers.11.mamba.in_proj_x"].numpy(),
                                  _f32(subs["sub3"]["mamba"]["in_proj_x"][1]))
    np.testing.assert_array_equal(conv["layers.13.moe.wi"].numpy(),
                                  _f32(subs["sub5"]["moe"]["wi"][1]))
    assert pm.layers[3].mamba.dt_bias.dtype == torch.float32
    assert pm.layers[3].mamba.in_proj_x.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="one mixer"):
        params_from_jax({**tree, "layers": {"sub0": {
            "mixer_norm": subs["sub1"]["mixer_norm"]}}})


def test_lora_from_jax_maps_period_8_sub_layers():
    jm, jp, pm = _models(HYBRID, "float32")
    a = _adapter(jp, 0)
    port = lora_from_jax(a, period=8)
    assert sorted(port.deltas) == ["layers.0.attn.wq", "layers.0.attn.wv",
                                   "layers.8.attn.wq", "layers.8.attn.wv"]
    np.testing.assert_array_equal(port.deltas["layers.8.attn.wq"][0].numpy(),
                                  _f32(a.deltas["layers/sub0/attn/wq"][0][1]))
    with pytest.raises(ValueError, match="outside a period"):
        lora_from_jax(JaxLoraAdapter("x", 8, {"layers/sub3/attn/wq":
                                              a.deltas["layers/sub0/attn/wq"]},
                                     0.5), period=2)


def test_init_fills_the_mamba_leaves_as_the_reference():
    """``a_log`` = log 1 = 0 (so A = -1), ``dt_bias`` = softplus^-1 of a
    dt in [1e-3, 1e-1], ``d`` and ``norm_scale`` ones, the projections at
    std 1/sqrt(D) and the convs at 1/sqrt(k)."""
    cfg = tiny_config(SSM, dtype="float32", d_model=256)
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    mb = m.layers[1].mamba
    assert torch.equal(mb.a_log, torch.zeros(cfg.ssm_heads))
    dt = M.softplus(mb.dt_bias)
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert float(dt.max()) / float(dt.min()) > 3
    assert torch.equal(mb.d, torch.ones(cfg.ssm_heads))
    assert torch.equal(mb.norm_scale, torch.ones(cfg.d_inner))
    assert abs(float(mb.in_proj_x.std()) * 16 - 1) < 0.05
    assert abs(float(mb.out_proj.std()) * np.sqrt(cfg.d_inner) - 1) < 0.05
    assert abs(float(mb.conv_x.std()) * 2 - 1) < 0.1


# ---------------------------------------------------------------- the engine
PREFIXES = {"p1": list(range(10, 30)), "p2": list(range(40, 70))}
LOGITS_TOL = 1e-4


def _adapter(jp, i, rank=8):
    """A JAX-side adapter on the attention wq/wv of every period, from a
    numpy seed (none when the model has no attention)."""
    rng = np.random.default_rng(200 + i)
    deltas = {}
    for sub, groups in jp["layers"].items():
        if "attn" not in groups:
            continue
        for leaf in ("wq", "wv"):
            n, din, dout = groups["attn"][leaf].shape
            a = rng.normal(size=(n, din, rank)).astype(np.float32) * 0.02
            b = rng.normal(size=(n, rank, dout)).astype(np.float32) * 0.02
            deltas[f"layers/{sub}/attn/{leaf}"] = (jnp.asarray(a),
                                                   jnp.asarray(b))
    return JaxLoraAdapter(f"l{i}", rank, deltas, 0.5)


def _script(eng, R):
    """A warm prefix, a cold prefix hit by a second request in the same
    step, priority admission and LoRA pool eviction; prompts of at least
    three tokens (the JAX model's conv windows need k - 1 inputs)."""
    eng.prewarm_prefix("p1")
    eng.submit(R("w", prompt=[1, 2, 3], max_new_tokens=6, prefix_id="p1"))
    eng.submit(R("c", prompt=[5, 6, 7], max_new_tokens=4, prefix_id="p2",
                 app_id="mid"))
    eng.submit(R("d", prompt=[9, 8, 7], max_new_tokens=5, prefix_id="p2",
                 app_id="hi"))
    ranks = {"": 1.0, "mid": 0.5, "hi": 0.0}
    eng.run(rank_fn=lambda r: ranks[r.app_id])
    for i, lid in enumerate(["l0", "l1", "l2", "l0", "", "l2"]):
        eng.submit(R(f"r{i}", prompt=[7, i + 1, 3], max_new_tokens=3,
                     lora_id=lid, prefix_id="p2" if i % 2 else ""))
        eng.run()
    full = R("f", prompt=PREFIXES["p1"] + [1, 2, 3], max_new_tokens=6)
    eng.submit(full)
    eng.run()
    return ([(r.req_id, r.output, r.prefix_hit) for r in eng.done],
            (eng.lora.hits, eng.lora.misses, eng.lora.merges),
            (eng.prefix.hits, eng.prefix.misses))


@pytest.mark.parametrize("name", [SSM, HYBRID])
def test_engine_matches_jax(name):
    """The same tokens, prefix flags, order and LoRA counters; the warm
    prefix's tokens are those of the full prompt's prefill.  No argmax the
    JAX engine takes is within ten times the logits tolerance of a tie."""
    jm, jp, pm = _models(name, "float32", seed=4)
    period = len(jp["layers"])
    kw = dict(max_slots=2, max_seq=96, lora_capacity=2,
              prefix_prompts=PREFIXES)
    jeng, peng = JaxEngine(jm, jp, **kw), InferenceEngine(pm, **kw)
    for i in range(3):
        a = _adapter(jp, i)
        jeng.lora.register(a)
        peng.lora.register(lora_from_jax(a, period=period))
    margins = []

    def record(fn):
        def wrapped(*args):
            out = fn(*args)
            top = np.sort(np.asarray(out[1][0, -1], np.float64))[-2:]
            margins.append(top[1] - top[0])
            return out
        return wrapped

    jeng._prefill = record(jeng._prefill)
    jeng._decode = record(jeng._decode)
    want = _script(jeng, JaxRequest)
    got = _script(peng, Request)
    assert min(margins) > 10 * LOGITS_TOL
    assert got == want
    outputs = {r[0]: r[1] for r in got[0]}
    assert outputs["w"] == outputs["f"]
    assert peng.lora.merges > 0 and (name == SSM) == (not any(
        a.deltas for a in peng.lora.adapters.values()))


def test_serve_serves_the_ssm_model(capsys):
    """``serve`` on the tiny Mamba2 serves every LLM request of the
    ten-app trace: 47, 43 distinct ids, as on the dense model; the
    adapters touch nothing, and their merges still count."""
    run = serve.run(["--apps", "10"], cfg=tiny_config(SSM), device="cpu")
    out = capsys.readouterr().out
    assert int(re.search(r"(\d+) llm requests served", out).group(1)) == 43
    assert len(run.engine.done) == 47
    assert all(len(r.output) == r.max_new_tokens for r in run.engine.done)
    assert run.engine.lora.merges > 0
