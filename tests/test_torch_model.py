"""The port's dense model against the JAX package's on the CPU: JAX-drawn
weights carried across with ``params_from_jax``, then prefill logits, eight
teacher-forced decode steps and the caches compared.

Tolerances: 1e-4 in float32 (the same algorithm; sums in another order).
In bfloat16 5e-2: the JAX model's XLA attention rounds the probabilities to
bfloat16 before the product with V (``flash_attention_xla``,
``decode_attention_xla``) where the port's kernels keep them in float32, and
the two frameworks round bfloat16 elementwise results at other places."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.testing import tiny_config as jax_tiny_config
from repro_torch.config import ModelConfig
from repro_torch.models.model import build_model, params_from_jax
from repro_torch.testing import tiny_config

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
N_DECODE = 8


def _jax_model(name, dtype):
    cfg = jax_tiny_config(name, dtype=dtype)
    m = jax_build_model(cfg)
    params = m.init(jax.random.PRNGKey(3))
    return m, params


def _port_model(name, dtype, params):
    m = build_model(tiny_config(name, dtype=dtype), device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, params)
    return m.load_params(params_from_jax(tree))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _cache(caches, name):
    """The JAX caches {"sub0": {name: (L, B, S, K, hd)}} in the port's
    (L, B, K, S, hd) layout."""
    return _f32(caches["sub0"][name]).transpose(0, 1, 3, 2, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-4b", "qwen2-moe-a2.7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_prefill_and_decode_match_jax(name, dtype):
    jm, jp = _jax_model(name, dtype)
    pm = _port_model(name, dtype, jp)
    tol = TOL[dtype]
    rng = np.random.default_rng(5)
    S, Smax = 11, 24
    prompt = rng.integers(1, 256, (2, S)).astype(np.int32)
    forced = rng.integers(1, 256, (2, N_DECODE)).astype(np.int32)

    jc, jl = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)})
    pc, pl = pm.prefill(torch.as_tensor(prompt, dtype=torch.long))
    assert pl.dtype == torch.float32 and tuple(pl.shape) == jl.shape
    np.testing.assert_allclose(pl.numpy(), _f32(jl), rtol=tol, atol=tol)
    for n in ("k", "v"):
        np.testing.assert_allclose(pc[n].float().numpy(), _cache(jc, n),
                                   rtol=tol, atol=tol)

    # pad both to Smax and decode teacher-forced tokens
    pad = [(0, 0)] * 5
    pad[2] = (0, Smax - S)
    jc = jax.tree_util.tree_map(lambda a: jnp.pad(a, pad), jc)
    big = pm.new_caches(2, Smax)
    for n in ("k", "v"):
        big[n][:, :, :, :S] = pc[n]
    jdec = jax.jit(jm.decode)
    for t in range(N_DECODE):
        tok = forced[:, t:t + 1]
        jc, jl = jdec(jp, jc, jnp.asarray(tok), jnp.asarray(S + t, jnp.int32))
        big, pl = pm.decode(big, torch.as_tensor(tok, dtype=torch.long), S + t)
        np.testing.assert_allclose(pl.numpy(), _f32(jl), rtol=tol, atol=tol,
                                   err_msg=f"decode step {t}")
    for n in ("k", "v"):
        np.testing.assert_allclose(big[n].float().numpy(), _cache(jc, n),
                                   rtol=tol, atol=tol)


def test_params_from_jax_names_and_orientation():
    """Every port weight is filled, in the (in, out) orientation of the
    stacked JAX leaf it came from."""
    jm, jp = _jax_model("qwen3-4b", "float32")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    conv = params_from_jax(tree)
    pm = build_model(tiny_config("qwen3-4b", dtype="float32"), device="cpu")
    assert set(conv) == set(pm.params())
    sub = tree["layers"]["sub0"]
    np.testing.assert_array_equal(conv["layers.1.attn.wq"].numpy(),
                                  sub["attn"]["wq"][1])
    np.testing.assert_array_equal(conv["layers.0.attn.k_norm"].numpy(),
                                  sub["attn"]["k_norm"][0])
    np.testing.assert_array_equal(conv["lm_head"].numpy(),
                                  tree["lm_head"]["kernel"])


@pytest.mark.parametrize("arch, family, item", [
    ("qwen2-moe-a2.7b", "moe", "item 14"),
    ("phi3.5-moe-42b-a6.6b", "moe", "item 14"),
    ("jamba-1.5-large-398b", "hybrid", "item 15"),
    ("mamba2-1.3b", "ssm", "item 15"),
    ("whisper-large-v3", "encdec", "item 16"),
    ("internvl2-26b", "vlm", "item 16"),
])
def test_unported_families_raise(arch, family, item):
    """Every family of the JAX package's registry is ported: the moe
    family (item 14), the ssm and hybrid families (item 15) and the encdec
    and vlm families (item 16) build on the CPU (tiny: an MoE layer in
    every decoder layer; a Mamba layer in every layer; two periods of one
    attention and seven Mamba layers, MoE in every second; an encoder and
    a decoder of two layers each, self- and cross-attention in every
    decoder layer; two dense layers behind a patch projector), and a
    config without experts, SSM state, attention period or encoder
    raises."""
    cfg = ModelConfig(**dataclasses.asdict(jax_get_config(arch)))
    assert cfg.family == family
    tiny = tiny_config(arch, dtype="float32")
    if family == "encdec":
        m = build_model(tiny, device="cpu", max_seq=32)
        assert len(m.encoder) == tiny.enc_layers == 2
        assert len(m.layers) == tiny.num_layers == 2
        assert all(hasattr(layer, "cross_attn") and hasattr(layer, "self_attn")
                   for layer in m.layers)
        assert m.enc_final_norm.bias is not None and m.projector is None
        assert tuple(m.pos_emb.shape) == (32, tiny.d_model)
        with pytest.raises(ValueError, match="enc_layers"):
            build_model(tiny.replace(enc_layers=0), device="cpu")
        return
    if family == "vlm":
        m = build_model(tiny, device="cpu")
        assert tuple(m.projector.shape) == (tiny.d_model, tiny.d_model)
        assert [(layer.mixer, layer.ffn) for layer in m.layers] == \
            [("attn", "dense")] * 2
        assert m.pos_emb is None and not hasattr(m, "encoder")
        return
    if family == "moe":
        m = build_model(tiny, device="cpu")
        assert all(layer.ffn == "moe" and not hasattr(layer, "mlp")
                   for layer in m.layers)
        with pytest.raises(ValueError, match="num_experts"):
            build_model(tiny.replace(num_experts=0), device="cpu")
        return
    if family == "ssm":
        m = build_model(tiny, device="cpu")
        assert [(layer.mixer, layer.ffn) for layer in m.layers] == \
            [("mamba", "none")] * 2
        assert not any(hasattr(layer, "attn") for layer in m.layers)
        with pytest.raises(ValueError, match="ssm_state"):
            build_model(tiny.replace(ssm_state=0), device="cpu")
        return
    if family == "hybrid":
        m = build_model(tiny, device="cpu")
        kinds = [(layer.mixer, layer.ffn) for layer in m.layers]
        assert len(kinds) == 16 and kinds[:8] == kinds[8:]
        assert [k[0] for k in kinds[:8]] == ["attn"] + ["mamba"] * 7
        assert [k[1] for k in kinds[:8]] == ["dense", "moe"] * 4
        with pytest.raises(ValueError, match="attn_every"):
            build_model(tiny.replace(attn_every=0), device="cpu")
        with pytest.raises(ValueError, match="whole periods"):
            build_model(tiny.replace(num_layers=12), device="cpu")
        return
    raise AssertionError(f"no arm for the {family} family")


def test_init_draws_on_the_device_with_the_reference_scales():
    """``init`` draws from the generator it is given: the same seed gives
    the same weights; std per weight as the JAX package's init."""
    cfg = tiny_config("llama3-8b", dtype="float32", d_model=256, d_ff=512)
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    std = lambda t: float(t.std())  # noqa: E731
    assert abs(std(a.embed) / 0.02 - 1) < 0.05
    assert abs(std(a.layers[0].attn.wq) * 16 - 1) < 0.05
    assert abs(std(a.layers[1].mlp.wo) * np.sqrt(512) - 1) < 0.05
    assert torch.equal(a.layers[0].mixer_norm.scale, torch.ones(256))


def test_params_from_jax_takes_an_moe_tree():
    """The ``moe`` group: expert stacks (E, in, out), the router
    (D, num_experts) and the shared weights (in, out), float32 router and
    gate kept float32 in a bfloat16 model."""
    jm, jp = _jax_model("qwen2-moe-a2.7b", "bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    conv = params_from_jax(tree)
    pm = build_model(tiny_config("qwen2-moe-a2.7b", dtype="bfloat16"),
                     device="cpu")
    assert set(conv) == set(pm.params())
    moe = tree["layers"]["sub0"]["moe"]
    for name in ("wi", "wo", "router", "shared_wg", "shared_gate"):
        np.testing.assert_array_equal(conv[f"layers.1.moe.{name}"].numpy(),
                                      _f32(moe[name][1]))
    assert tuple(conv["layers.0.moe.wi"].shape) == (16, 64, 96)
    assert tuple(conv["layers.0.moe.wo"].shape) == (16, 96, 64)
    assert tuple(conv["layers.0.moe.router"].shape) == (64, 4)
    pm.load_params(conv)
    assert pm.layers[0].moe.router.dtype == torch.float32
    assert pm.layers[0].moe.shared_gate.dtype == torch.float32
    assert pm.layers[0].moe.wi.dtype == torch.bfloat16


def test_moe_init_draws_every_weight_with_the_reference_scales():
    """No MoE weight is left to the norm fill of ones (``Model.init``
    fills any parameter without an ``init_std``): router and gate std
    1/sqrt(D), expert stacks 1/sqrt(D) in and 1/sqrt(Fe) out, shared
    output 1/sqrt(Fs)."""
    cfg = tiny_config("qwen2-moe-a2.7b", dtype="float32", d_model=256,
                      d_ff_expert=384)
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    moe = m.layers[1].moe
    want = {"router": 256, "wi": 256, "wg": 256, "wo": 384,
            "shared_wi": 256, "shared_wg": 256, "shared_wo": 384,
            "shared_gate": 256}
    assert set(want) == {n for n, _ in moe.named_parameters()}
    for name, fan_in in want.items():
        t = getattr(moe, name)
        assert abs(float(t.std()) * np.sqrt(fan_in) - 1) < 0.1, name
        assert abs(float(t.mean())) < 0.1 / np.sqrt(fan_in), name
