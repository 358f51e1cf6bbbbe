"""The plain versions of the port's model kernels — RMSNorm (K3), prefill
attention (K4) and decode attention (K5) — against the JAX package on the
CPU: its ``ref.py`` oracles, its Pallas kernels (``ops``, interpret mode, as
``tests/test_kernels.py`` runs them) and the XLA functions its model calls
(``layers.rms_norm``, ``flash_attention_xla``, ``decode_attention_xla``) at
the model layout.  Shapes and tolerances of ``tests/test_kernels.py`` (2e-5
in float32, 2e-2 in bfloat16), plus odd sequence lengths.  Inputs are drawn
in float32 with numpy and rounded to the working dtype the same way on both
sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_dec_ops
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_dec_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_fa_ops
from repro.kernels.flash_attention.ref import attention_ref as jax_fa_ref
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rms_ops
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rms_ref
from repro.models import layers as jax_layers
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor."""
    x = rng.normal(size=shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _check(port, *jax_outs, dtype):
    p = port.float().numpy()
    for j in jax_outs:
        np.testing.assert_allclose(p, np.asarray(j, np.float32), **_tol(dtype))


@pytest.mark.parametrize("shape", [(8, 64), (4, 32, 128), (3, 5, 7, 64),
                                   (5, 33)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_plain_matches_jax(shape, dtype):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    jx, tx = _pair(rng, shape, dtype)
    js, ts = _pair(rng, shape[-1:], "float32")
    port = rmsnorm(tx, ts, eps=1e-5)
    assert port.dtype == tx.dtype
    _check(rmsnorm_ref(tx, ts, 1e-5), jax_rms_ref(jx, js), dtype=dtype)
    _check(port, jax_rms_ref(jx, js), jax_rms_ops(jx, js),
           jax_layers.rms_norm(jx, js, 1e-5), dtype=dtype)
    _check(layers.rms_norm(tx, ts, 1e-5), jax_layers.rms_norm(jx, js, 1e-5),
           dtype=dtype)


def _kernel_layout_q(q, B, S, K, G, hd):
    return q.reshape(B, S, K, G, hd).transpose(0, 2, 3, 1, 4) \
        .reshape(B * K * G, S, hd)


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd", [
    (1, 128, 128, 4, 4, 32),     # MHA
    (2, 256, 256, 8, 2, 64),     # GQA 4:1
    (1, 64, 256, 4, 1, 128),     # MQA, rectangular
    (1, 23, 23, 4, 2, 16),       # odd length
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_jax(B, Sq, Skv, H, K, hd, dtype,
                                           causal):
    rng = np.random.default_rng(Sq * 3 + Skv + hd)
    jq, tq = _pair(rng, (B, Sq, H, hd), dtype)
    jk, tk = _pair(rng, (B, Skv, K, hd), dtype)
    jv, tv = _pair(rng, (B, Skv, K, hd), dtype)
    G = H // K
    # the kernel layout: the port's oracle against the JAX oracle
    kl = lambda a: a.transpose(0, 2, 1, 3).reshape(B * K, Skv, hd)  # noqa
    tkl = lambda a: a.permute(0, 2, 1, 3).reshape(B * K, Skv, hd)  # noqa
    tql = (tq.reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)
           .reshape(B * K * G, Sq, hd))
    _check(attention_ref(tql, tkl(tk), tkl(tv), causal=causal),
           jax_fa_ref(_kernel_layout_q(jq, B, Sq, K, G, hd), kl(jk), kl(jv),
                      causal=causal), dtype=dtype)
    # the model layout: against the Pallas kernel and the model's XLA path
    port = flash_attention(tq, tk, tv, causal=causal)
    assert port.shape == tq.shape and port.dtype == tq.dtype
    _check(port, jax_fa_ops(jq, jk, jv, causal=causal, block_q=64,
                            block_kv=64),
           jax_layers.flash_attention_xla(jq, jk, jv, causal, block_q=64),
           dtype=dtype)


@pytest.mark.parametrize("B,H,K,hd,Smax,pos", [
    (2, 8, 4, 64, 512, 300),
    (1, 4, 4, 32, 256, 255),
    (3, 6, 2, 128, 1024, 17),
    (1, 8, 2, 128, 77, 40),      # odd Smax
    (2, 4, 2, 16, 33, 0),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_plain_matches_jax(B, H, K, hd, Smax, pos, dtype):
    rng = np.random.default_rng(Smax + pos)
    jq, tq = _pair(rng, (B, 1, H, hd), dtype)
    jk, tk = _pair(rng, (B, Smax, K, hd), dtype)
    jv, tv = _pair(rng, (B, Smax, K, hd), dtype)
    port = decode_attention(tq, tk, tv, pos)
    assert port.shape == tq.shape and port.dtype == tq.dtype
    G = H // K
    jl = jnp.full((B * K,), pos + 1, jnp.int32)
    kl = lambda a: a.transpose(0, 2, 1, 3).reshape(B * K, Smax, hd)  # noqa
    jref = jax_dec_ref(jq.reshape(B * K, G, hd), kl(jk), kl(jv), jl)
    block_s = 128 if Smax % 128 == 0 else Smax
    _check(port, jref.reshape(B, 1, H, hd),
           jax_dec_ops(jq, jk, jv, jnp.asarray(pos, jnp.int32),
                       block_s=block_s),
           jax_layers.decode_attention_xla(jq, jk, jv,
                                           jnp.asarray(pos, jnp.int32)),
           dtype=dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_per_row_lengths_match_jax(dtype):
    rng = np.random.default_rng(8)
    BK, G, hd, Smax = 6, 4, 64, 150
    jq, tq = _pair(rng, (BK, G, hd), dtype)
    jk, tk = _pair(rng, (BK, Smax, hd), dtype)
    jv, tv = _pair(rng, (BK, Smax, hd), dtype)
    lengths = rng.integers(1, Smax + 1, BK).astype(np.int32)
    _check(decode_attention_ref(tq, tk, tv, torch.from_numpy(lengths)),
           jax_dec_ref(jq, jk, jv, jnp.asarray(lengths)), dtype=dtype)
