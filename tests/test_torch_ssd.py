"""The plain versions of the port's SSD chunk scan (K7) against the JAX
package on the CPU.

* ``ops.ssd_scan`` (the chunked plain version on a CPU tensor) and the
  sequential oracle ``ssd_scan_ref`` against the JAX Pallas ``ssd_scan`` (in
  interpret mode, as ``tests/test_kernels.py`` runs it) and its oracle, at
  that test's sweep and tolerances (1e-4 float32, 5e-2 bfloat16).
* The chunked version against ``repro.models.mamba.ssd_chunked``, y and the
  final state, with a ragged S (the zero-padded tail) and ``chunk < S``,
  the model's path.
* The kernel binding's chunk choice by shared memory.

Inputs are drawn with numpy and rounded to the working dtype the same way
on both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(B, S, H, P, N, dtype, seed):
    """The reference test's distributions: x, B, C normal; dt uniform in
    [0.001, 0.1]; A in [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    jax_in = (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
              jnp.asarray(Bm, jd), jnp.asarray(Cm, jd))
    port_in = (torch.from_numpy(x).to(td), torch.from_numpy(dt),
               torch.from_numpy(A), torch.from_numpy(Bm).to(td),
               torch.from_numpy(Cm).to(td))
    return jax_in, port_in


def _close(port, want, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 128, 2, 32, 16, 32),
    (2, 256, 4, 64, 32, 64),
    (1, 64, 8, 16, 8, 64),      # chunk == S
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_scan_matches_the_pallas_kernel(B, S, H, P, N, chunk, dtype):
    jin, tin = _inputs(B, S, H, P, N, dtype, seed=S + H + P)
    y, final = ssd_scan(*tin, chunk=chunk)
    assert y.dtype == tin[0].dtype and tuple(y.shape) == (B, S, H, P)
    assert final.dtype == torch.float32 and tuple(final.shape) == (B, H, N, P)
    oracle = ssd_scan_ref(*tin)
    for want in (jax_ssd_scan(*jin, chunk=chunk), jax_ssd_scan_ref(*jin)):
        _close(y, want, dtype)
        _close(oracle, want, dtype)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 300, 4, 16, 8, 128),    # two full chunks and a 44-position tail
    (2, 37, 3, 8, 4, 8),        # chunk < S, ragged
    (1, 24, 2, 16, 16, 128),    # S < chunk: one padded chunk
    (1, 8, 64, 64, 128, 128),   # mamba2-1.3b's heads at a serve prompt
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_matches_the_models_ssd_chunked(B, S, H, P, N, chunk, dtype):
    jin, tin = _inputs(B, S, H, P, N, dtype, seed=B + S + N)
    y, final = ssd_chunked(*tin, chunk)
    jy, jfinal = jax_ssd_chunked(*jin, chunk)
    _close(y, jy, dtype)
    # the state is float32 on both sides, from the same rounded inputs
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(ssd_scan(*tin, chunk=chunk)[1], final)


def test_final_state_continues_the_scan():
    """Scanning the first part, then the rest from its final state, gives
    the whole scan: the state the prefill hands to decode is the one the
    sequence leaves."""
    _, (x, dt, A, Bm, Cm) = _inputs(1, 50, 3, 8, 4, "float32", seed=9)
    y, final = ssd_chunked(x, dt, A, Bm, Cm, 16)
    cut = 21
    y1, s1 = ssd_chunked(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                         Cm[:, :cut], 16)
    y2, s2 = ssd_chunked(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                         Cm[:, cut:], 16, init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(s2, final, rtol=1e-5, atol=1e-5)


def test_shared_memory_plan(monkeypatch):
    """The chunk the float32 kernel takes: ``min(chunk, S)``, halved while
    a block would need more shared memory than the card offers (a chunk of
    128 at Jamba's P = 128 becomes 64); a shape that does not fit at chunk
    1 raises.  The block's size is the source's layout
    (``f32_smem_bytes``, held to ``ssd_scan_smem_bytes`` on the card in
    ``test_torch_cuda.py``): here a size linear in the chunk stands in for
    it."""
    monkeypatch.setattr(kernel, "f32_smem_bytes",
                        lambda L, N, P: 4 * (L * (N + P) + N * P))
    assert kernel.fitting_chunk(128, 2048, 128, 64) == 128
    assert kernel.fitting_chunk(128, 24, 128, 64) == 24
    assert kernel.fitting_chunk(128, 2048, 256, 128) == 64
    assert kernel.fitting_chunk(100, 2048, 256, 128) == 50
    with pytest.raises(ValueError, match="shared memory at chunk 1"):
        kernel.fitting_chunk(128, 2048, 512, 128)
