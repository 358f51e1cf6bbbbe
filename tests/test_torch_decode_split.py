"""The decode-attention kernel's split of the sequence, in its plain form
(``decode_attention_split_ref``: per-split partials merged in fixed split
order), against the JAX package's ``decode_attention_ref`` on the CPU at the
reference's float32 tolerance, over several split counts and ragged lengths
whose last splits hold no position."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_dec_ref
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)

LENGTHS = {
    "full": lambda Smax, n: [Smax] * n,
    "one": lambda Smax, n: [1] * n,
    "ragged": lambda Smax, n: [1, Smax // 3, Smax // 2 + 1, Smax - 1,
                               Smax, 7][:n],
}


@pytest.mark.parametrize("n_splits", [1, 2, 5, 16])
@pytest.mark.parametrize("lengths", list(LENGTHS))
@pytest.mark.parametrize("BK,G,hd,Smax", [(6, 4, 64, 200), (4, 7, 32, 77),
                                          (3, 1, 128, 16)])
def test_split_merge_matches_jax(n_splits, lengths, BK, G, hd, Smax):
    rng = np.random.default_rng(n_splits * 131 + Smax + G)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((BK, G, hd), (BK, Smax, hd), (BK, Smax, hd)))
    lens = np.asarray(LENGTHS[lengths](Smax, BK), np.int32)
    want = np.asarray(jax_dec_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lens)))
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lens))
    got = decode_attention_split_ref(tq, tk, tv, tl, n_splits=n_splits)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), decode_attention_ref(tq, tk, tv, tl).numpy(),
        rtol=1e-5, atol=1e-5)


def test_split_boundaries_and_empty_splits():
    """Lengths that end inside the first split, on a split boundary and one
    past it, with the later splits empty; bfloat16 operands round once."""
    rng = np.random.default_rng(5)
    BK, G, hd, Smax, n = 4, 4, 64, 64, 4          # 16 positions a split
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((BK, G, hd), (BK, Smax, hd), (BK, Smax, hd)))
    lens = np.asarray([5, 16, 17, 64], np.int32)
    want = np.asarray(jax_dec_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lens)))
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lens))
    got = decode_attention_split_ref(tq, tk, tv, tl, n_splits=n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    bf = [t.to(torch.bfloat16) for t in (tq, tk, tv)]
    jbf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    got = decode_attention_split_ref(*bf, tl, n_splits=n)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jax_dec_ref(*jbf, jnp.asarray(lens)), np.float32),
        rtol=2e-2, atol=2e-2)
