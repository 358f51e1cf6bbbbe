"""The port's MoE layer and its grouped expert matmul (K6) against the JAX
package on the CPU.

* K6's plain version against the JAX ``moe_gmm`` (its Pallas kernel in
  interpret mode, as ``tests/test_kernels.py`` runs it) and ``moe_gmm_ref``
  at that test's shapes and tolerances (1e-4 in float32, 2e-2 in bfloat16:
  float32 sums in another order; a bf16 output one rounding apart).
* Routing and capacity: the same expert ids, weights within 1e-6; the same
  capacity over a sweep of token counts; at ``capacity_factor=0.25`` the
  same tokens dropped.
* The layer: ``moe_apply`` with ``sort``, ``ep`` and ``dense`` on the tiny
  ``qwen2-moe-a2.7b`` (shared expert) and ``phi3.5-moe-42b-a6.6b`` (none),
  1e-4 in float32, 5e-2 in bfloat16 (the model tolerance of
  ``tests/test_torch_model.py``).

Weights are drawn by JAX and copied into the port's ``MoE``; inputs are
drawn with numpy and rounded to the working dtype the same way on both
sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ops import moe_gmm as jax_moe_gmm
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.models import moe as JX
from repro.models.layers import padded_experts as jax_padded_experts
from repro.testing import tiny_config as jax_tiny_config
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.models import moe as X
from repro_torch.models.layers import padded_experts
from repro_torch.testing import tiny_config

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"]


def _pair(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("E,C,D,N,bc,bn,bd", [
    (4, 64, 128, 256, 32, 128, 64),
    (2, 128, 256, 128, 128, 128, 256),
    (8, 32, 64, 64, 32, 64, 64),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_gmm_plain_matches_jax(E, C, D, N, bc, bn, bd, dtype):
    rng = np.random.default_rng(E * 1000 + C + D + N)
    jx, tx = _pair(rng.normal(size=(E, C, D)).astype(np.float32), dtype)
    w = (rng.normal(size=(E, D, N)) * 0.1).astype(np.float32)
    jw, tw = _pair(w, dtype)
    port = moe_gmm(tx, tw)
    assert port.dtype == tx.dtype and tuple(port.shape) == (E, C, N)
    assert torch.equal(port, moe_gmm_ref(tx, tw))
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    for want in (jax_moe_gmm(jx, jw, block_c=bc, block_n=bn, block_d=bd),
                 jax_moe_gmm_ref(jx, jw)):
        np.testing.assert_allclose(port.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_moe_gmm_takes_a_repeated_token_buffer():
    """The dense path passes one token buffer repeated across the experts
    (a stride-0 view): the same as the copied buffer."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(3, 64)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(16, 64, 96)), dtype=torch.float32)
    rep = x.unsqueeze(0).expand(16, 3, 64)
    assert rep.stride(0) == 0
    assert torch.equal(moe_gmm(rep, w), moe_gmm(rep.contiguous(), w))


def _layer(name, dtype, seed=0, **over):
    """The JAX MoE parameters of one layer and the port's ``MoE`` holding
    the same values."""
    jcfg = jax_tiny_config(name, dtype=dtype, **over)
    cfg = tiny_config(name, dtype=dtype, **over)
    jd, td = DTYPES[dtype]
    p = JX.moe_params(jax.random.PRNGKey(seed), jcfg, n=1, dtype=jd)
    p = jax.tree_util.tree_map(lambda a: a[0], p)
    m = X.MoE(cfg, td, "cpu")
    own = dict(m.named_parameters())
    assert set(own) == set(p)
    with torch.no_grad():
        for k, v in p.items():
            assert tuple(own[k].shape) == v.shape, k
            own[k].copy_(torch.tensor(np.asarray(v, np.float32)))
    return jcfg, cfg, p, m


def _tokens(cfg, dtype, shape=(2, 16), seed=1):
    x = np.random.default_rng(seed).normal(
        size=(*shape, cfg.d_model)).astype(np.float32)
    return _pair(x, dtype)


def test_padded_experts_and_tiny_shapes():
    for e in (4, 16, 60, 61):
        assert padded_experts(e) == jax_padded_experts(e)
    assert padded_experts(60) == 64 and padded_experts(4) == 16
    cfg = tiny_config("qwen2-moe-a2.7b")
    assert (cfg.num_experts, padded_experts(cfg.num_experts), cfg.top_k,
            cfg.num_shared_experts, cfg.d_ff_expert,
            cfg.capacity_factor) == (4, 16, 2, 1, 96, 16.0)
    m = X.MoE(cfg, torch.float32, "cpu")
    assert tuple(m.wi.shape) == (16, 64, 96)
    assert tuple(m.wo.shape) == (16, 96, 64)
    assert tuple(m.router.shape) == (64, 4)
    assert tuple(m.shared_wi.shape) == (64, 96)
    assert m.router.dtype == m.shared_gate.dtype == torch.float32


@pytest.mark.parametrize("name", ARCHS)
def test_route_matches_jax(name):
    jcfg, cfg, p, m = _layer(name, "float32")
    jx, tx = _tokens(cfg, "float32", (4, 32))
    jw, ji = JX._route(p, jx.reshape(-1, cfg.d_model), jcfg)
    w, i = X.route(m, tx.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    assert int(i.max()) < cfg.num_experts


def test_route_breaks_ties_to_the_lower_index():
    """Equal probabilities: the lower expert index first, as
    ``jax.lax.top_k`` orders them."""
    jcfg, cfg, p, m = _layer("qwen2-moe-a2.7b", "float32")
    with torch.no_grad():
        m.router.zero_()
    xf = torch.ones((3, cfg.d_model))
    w, i = X.route(m, xf, cfg)
    jw, ji = JX._route({"router": jnp.zeros((cfg.d_model, cfg.num_experts))},
                       jnp.ones((3, cfg.d_model)), jcfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i.tolist() == [[0, 1]] * 3


@pytest.mark.parametrize("name", ARCHS)
def test_capacity_matches_jax(name):
    for cf in (0.25, 1.25, 16.0):
        jcfg = jax_tiny_config(name).replace(capacity_factor=cf)
        cfg = tiny_config(name).replace(capacity_factor=cf)
        for T in (1, 2, 7, 8, 16, 24, 33, 100, 1000, 4096):
            assert X.capacity(cfg, T) == JX.capacity(jcfg, T), (cf, T)


@pytest.mark.parametrize("name", ARCHS)
def test_capacity_drops_the_tokens_the_reference_drops(name):
    """At ``capacity_factor=0.25`` copies are dropped: the port's output is
    the reference's within 1e-5 and differs from the drop-free dense
    oracle, as ``tests/test_moe.py`` asserts of the reference."""
    jcfg, cfg, p, m = _layer(name, "float32", capacity_factor=0.25)
    jx, tx = _tokens(cfg, "float32")
    T = tx.shape[0] * tx.shape[1]
    _, idx = X.route(m, tx.reshape(T, -1), cfg)
    counts = torch.bincount(idx.reshape(-1), minlength=16)
    assert int(counts.max()) > X.capacity(cfg, T)      # something dropped
    y = X.moe_apply_sort(m, tx, cfg).numpy()
    want = np.asarray(jax.jit(lambda p, x: JX.moe_apply_sort(p, x, jcfg))(
        p, jx))
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
    assert np.all(np.isfinite(y))
    assert not np.allclose(y, X.moe_apply_dense(m, tx, cfg).numpy())


@pytest.mark.parametrize("impl", ["sort", "ep", "dense"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_matches_jax(name, dtype, impl):
    jcfg, cfg, p, m = _layer(name, dtype, moe_impl=impl)
    jx, tx = _tokens(cfg, dtype)
    want = jax.jit(lambda p, x: JX.moe_apply(p, x, jcfg))(p, jx)
    y = X.moe_apply(m, tx, cfg)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    tol = MOE_TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ARCHS)
def test_sort_and_dense_agree_without_drops(name):
    """Drop-free (the tiny configs' capacity factor 16): both dispatch
    paths compute the same function, as the reference's oracle test."""
    _, cfg, _, m = _layer(name, "float32")
    _, tx = _tokens(cfg, "float32")
    np.testing.assert_allclose(X.moe_apply_sort(m, tx, cfg).numpy(),
                               X.moe_apply_dense(m, tx, cfg).numpy(),
                               rtol=2e-5, atol=2e-5)
