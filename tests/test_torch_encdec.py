"""The port's encoder-decoder (whisper-large-v3) and VLM (internvl2-26b)
models against the JAX package's on the CPU, at the tiny configs (2
encoder and 2 decoder layers over 12 frames; 2 layers behind 8 patches):
JAX-drawn weights carried across with ``params_from_jax``, the same
numpy-seeded tokens and frames or patch embeddings, then prefill logits,
eight teacher-forced decode steps and every cache (the cross caches
``xk``/``xv`` included) compared.

Tolerances as ``test_torch_model.py``: 1e-4 in float32, 5e-2 in bfloat16
(the JAX model's XLA attention rounds its probabilities to bfloat16, also
in the cross-attention of a decode step, where the port's plain versions
keep them in float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jax_build_model
from repro.models.transformer import add_positions as jax_add_positions
from repro.testing import tiny_config as jax_tiny_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model, params_from_jax
from repro_torch.serving.engine import InferenceEngine
from repro_torch.testing import tiny_config

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
N_DECODE = 8
MAX_SEQ = 24                    # Whisper's learned positions (tiny)
ARCHS = ["whisper-large-v3", "internvl2-26b"]


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _models(name, dtype, max_seq=MAX_SEQ):
    jm = jax_build_model(jax_tiny_config(name, dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(3), max_seq=max_seq)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    pm = build_model(tiny_config(name, dtype=dtype), device="cpu",
                     max_seq=max_seq).load_params(params_from_jax(tree))
    return jm, jp, pm, tree


def _inputs(cfg, B, S, seed=5):
    """Tokens and the family's side input (frames or patch embeddings),
    numpy-seeded: the JAX batch dict and the port's keyword arguments."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(1, 256, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(prompt)}
    if cfg.family == "encdec":
        key, rows = "frames", cfg.enc_frames
    else:
        key, rows = "patch_embeds", cfg.vision_patches
    side = rng.normal(size=(B, rows, cfg.d_model)).astype(np.float32)
    batch[key] = jnp.asarray(side)
    forced = rng.integers(1, 256, (B, N_DECODE)).astype(np.int32)
    return prompt, batch, {key: torch.as_tensor(side)}, forced


def _jax_caches(jc, family):
    """The JAX caches by name, each (L, B, S, K, hd) in the port's
    (L, B, K, S, hd) layout."""
    named = jc if family == "encdec" else jc["sub0"]
    return {n: _f32(a).transpose(0, 1, 3, 2, 4) for n, a in named.items()}


def _close(a, b, tol, msg=""):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_jax(name, dtype):
    jm, jp, pm, _ = _models(name, dtype)
    cfg, tol = pm.cfg, TOL[dtype]
    B, S, Smax = 2, 7, 16
    prompt, batch, side, forced = _inputs(cfg, B, S)
    jc, jl = jax.jit(jm.prefill)(jp, batch)
    pc, pl = pm.prefill(torch.as_tensor(prompt, dtype=torch.long), **side)
    assert pl.dtype == torch.float32 and tuple(pl.shape) == jl.shape
    _close(pl.numpy(), _f32(jl), tol)
    want = _jax_caches(jc, cfg.family)
    names = {"k", "v", "xk", "xv"} if cfg.family == "encdec" else {"k", "v"}
    assert set(pc) == set(want) == names
    S0 = pc["k"].shape[3]       # the prompt, behind the patches of a VLM
    assert S0 == S + (cfg.vision_patches if cfg.family == "vlm" else 0)
    if cfg.family == "encdec":
        assert tuple(pc["xk"].shape) == (cfg.num_layers, B, cfg.num_kv_heads,
                                         cfg.enc_frames, 16)
    for n in names:
        _close(pc[n].float().numpy(), want[n], tol, n)

    # grow the self caches to S0 + Smax and decode teacher-forced tokens;
    # the cross caches are copied whole and only read
    def pad(a):
        widths = [(0, 0)] * 5
        widths[2] = (0, Smax)
        return jnp.pad(a, widths)
    if cfg.family == "encdec":
        jc = dict(jc, k=pad(jc["k"]), v=pad(jc["v"]))
    else:
        jc = jax.tree_util.tree_map(pad, jc)
    big = pm.new_caches(B, S0 + Smax)
    for n in names:
        if n in ("k", "v"):
            big[n][:, :, :, :S0] = pc[n]
        else:
            big[n].copy_(pc[n])
    cross = {n: big[n].clone() for n in names - {"k", "v"}}
    jdec = jax.jit(jm.decode)
    for t in range(N_DECODE):
        tok = forced[:, t:t + 1]
        jc, jl = jdec(jp, jc, jnp.asarray(tok), jnp.asarray(S0 + t,
                                                            jnp.int32))
        big, pl = pm.decode(big, torch.as_tensor(tok, dtype=torch.long),
                            S0 + t)
        _close(pl.numpy(), _f32(jl), tol, f"decode step {t}")
    want = _jax_caches(jc, cfg.family)
    for n in names:
        _close(big[n].float().numpy(), want[n], tol, n)
    for n, before in cross.items():
        assert torch.equal(big[n], before), f"decode wrote {n}"


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_jax_names_and_orientation(name):
    """Every port weight is filled, in the (in, out) orientation of the
    JAX leaf it came from: the encoder and decoder stacks unstacked by
    layer, the final encoder norm, the learned positions, the projector."""
    _, _, pm, tree = _models(name, "float32")
    conv = params_from_jax(tree)
    assert set(conv) == set(pm.params())
    eq = np.testing.assert_array_equal
    if name == "whisper-large-v3":
        enc, dec = tree["layers"]["enc"], tree["layers"]["dec"]
        eq(conv["encoder.1.attn.wq"].numpy(), enc["attn"]["wq"][1])
        eq(conv["encoder.0.mlp.wi"].numpy(), enc["mlp"]["wi"][0])
        eq(conv["encoder.1.mlp_norm.bias"].numpy(), enc["mlp_norm"]["bias"][1])
        eq(conv["layers.1.cross_attn.wk"].numpy(),
           dec["cross_attn"]["wk"][1])
        eq(conv["layers.0.self_attn.wo"].numpy(), dec["self_attn"]["wo"][0])
        eq(conv["layers.1.cross_norm.scale"].numpy(),
           dec["cross_norm"]["scale"][1])
        eq(conv["enc_final_norm.bias"].numpy(),
           tree["layers"]["enc_final_norm"]["bias"])
        eq(conv["final_norm.bias"].numpy(), tree["final_norm"]["bias"])
        eq(conv["pos_emb"].numpy(), tree["pos_emb"])
        assert tuple(conv["pos_emb"].shape) == (MAX_SEQ, 64)
        assert tuple(conv["layers.0.cross_attn.wq"].shape) == (64, 64)
        assert "projector" not in conv
    else:
        eq(conv["projector"].numpy(), tree["projector"]["kernel"])
        eq(conv["layers.1.attn.wk"].numpy(),
           tree["layers"]["sub0"]["attn"]["wk"][1])
        assert "pos_emb" not in conv   # RoPE: no learned positions
        assert tuple(conv["layers.0.attn.wk"].shape) == (64, 2 * 16)
    eq(conv["lm_head"].numpy(), tree["lm_head"]["kernel"])


def test_learned_positions_match_jax_and_raise_out_of_range():
    """``add_positions`` adds the same rows as the JAX package's inside the
    table; past ``max_seq``, where the JAX ``dynamic_slice`` clamps the
    window, the port raises ``ValueError`` (prefill and decode)."""
    _, jp, pm, _ = _models("whisper-large-v3", "float32")
    x = np.random.default_rng(1).normal(size=(2, 5, 64)).astype(np.float32)
    for offset in (0, 3, MAX_SEQ - 5):
        np.testing.assert_array_equal(
            T.add_positions(pm.pos_emb, torch.as_tensor(x), offset).numpy(),
            _f32(jax_add_positions(jp, jnp.asarray(x), offset)))
    for offset in (MAX_SEQ - 4, -1):
        with pytest.raises(ValueError, match="learned positions"):
            T.add_positions(pm.pos_emb, torch.as_tensor(x), offset)
    cfg = pm.cfg
    frames = torch.zeros(1, cfg.enc_frames, cfg.d_model)
    with pytest.raises(ValueError, match="learned positions"):
        pm.prefill(torch.ones(1, MAX_SEQ + 1, dtype=torch.long),
                   frames=frames)
    caches, _ = pm.prefill(torch.ones(1, 4, dtype=torch.long), frames=frames)
    big = pm.new_caches(1, MAX_SEQ + 4)
    big["xk"].copy_(caches["xk"])
    big["xv"].copy_(caches["xv"])
    pm.decode(big, torch.ones(1, 1, dtype=torch.long), MAX_SEQ - 1)
    with pytest.raises(ValueError, match="learned positions"):
        pm.decode(big, torch.ones(1, 1, dtype=torch.long), MAX_SEQ)


@pytest.mark.parametrize("name, key", [("whisper-large-v3", "frames"),
                                       ("internvl2-26b", "patch_embeds")])
def test_missing_or_misshapen_side_input_raises(name, key):
    """A prefill without the frames or patch embeddings its family needs,
    with ones of the wrong shape, or with the other family's, raises
    ``ValueError`` (the JAX package fails on a missing batch key)."""
    pm = build_model(tiny_config(name), device="cpu", max_seq=MAX_SEQ)
    cfg = pm.cfg
    tokens = torch.ones(2, 3, dtype=torch.long)
    rows = cfg.enc_frames if key == "frames" else cfg.vision_patches
    with pytest.raises(ValueError, match=f"needs {key}"):
        pm.prefill(tokens)
    for shape in ((1, rows, cfg.d_model), (2, rows, cfg.d_model + 1),
                  (2, rows, cfg.d_model, 1), (2, 0, cfg.d_model)):
        with pytest.raises(ValueError, match=f"{key} of shape"):
            pm.prefill(tokens, **{key: torch.zeros(shape)})
    other = "patch_embeds" if key == "frames" else "frames"
    with pytest.raises(ValueError, match=f"takes no {other}"):
        pm.prefill(tokens, **{key: torch.zeros(2, rows, cfg.d_model),
                              other: torch.zeros(2, rows, cfg.d_model)})
    dense = build_model(tiny_config("llama3-8b"), device="cpu")
    with pytest.raises(ValueError, match=f"takes no {key}"):
        dense.prefill(tokens, **{key: torch.zeros(2, rows, 64)})


@pytest.mark.parametrize("name", ARCHS)
def test_engine_and_serve_raise_for_side_input_families(name):
    """The engine feeds tokens only, as the JAX package's: it and ``serve``
    refuse these families with a ``ValueError`` (serve before it builds
    anything)."""
    pm = build_model(tiny_config(name), device="cpu", max_seq=MAX_SEQ)
    with pytest.raises(ValueError, match="feeds tokens only"):
        InferenceEngine(pm)
    with pytest.raises(ValueError, match="feeds tokens only"):
        serve.run(["--apps", "1"], cfg=tiny_config(name), device="cpu")


def test_init_draws_positions_and_projector_with_the_reference_scales():
    """``pos_emb`` std 0.02 and the VLM projector 1/sqrt(D), as the JAX
    package's ``embed_params``; LayerNorm scales ones and biases zeros."""
    cfg = tiny_config("internvl2-26b", dtype="float32", d_model=256)
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    assert abs(float(m.projector.std()) * 16 - 1) < 0.05
    assert m.pos_emb is None
    cfg = tiny_config("whisper-large-v3", dtype="float32", d_model=256)
    m = build_model(cfg, device="cpu", max_seq=448).init(
        torch.Generator().manual_seed(1))
    assert abs(float(m.pos_emb.std()) / 0.02 - 1) < 0.05
    assert m.projector is None
    assert torch.equal(m.enc_final_norm.scale, torch.ones(256))
    assert torch.equal(m.layers[1].cross_norm.bias, torch.zeros(256))
    assert abs(float(m.encoder[0].attn.wq.std()) * 16 - 1) < 0.05
    assert build_model(cfg, device="cpu").pos_emb is None   # max_seq 0
