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
@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-4b"])
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
    cfg = ModelConfig(**dataclasses.asdict(jax_get_config(arch)))
    assert cfg.family == family
    with pytest.raises(NotImplementedError, match=item):
        build_model(cfg, device="cpu")


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
