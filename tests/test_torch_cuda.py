"""The kernels on the card against their plain versions: the fused walk
(with and without posterior tables), the per-phase walk, and the model
kernels (RMSNorm, prefill attention, decode attention).

Marked ``cuda``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere
(the fixture decides, at run time).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

import torch

from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
from repro_torch.core.pdgraph import pack_graphs
from repro_torch.kernels import LAUNCHES
from repro_torch.core.posterior import posterior_tables, prior_mean, row_width
from repro_torch.kernels.pdgraph_walk import kernel, ops
from repro_torch.kernels.pdgraph_walk.ref import walk_phase_ref, walker_streams

pytestmark = pytest.mark.cuda

KEYS = ("probs", "edges", "ranks", "total", "a_hist", "a_lo", "a_span",
        "a_reach")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(packed, A, seed):
    rng = np.random.default_rng(seed)
    G, U, _ = packed.samples.shape
    d = packed.device
    gi = rng.integers(0, G, A)
    ovs = np.zeros((A, U, 16), np.float32)
    ovc = np.zeros((A, U), np.int32)
    for a in range(0, A, 3):
        n = int(rng.integers(1, 17))
        ovc[a, a % U] = n
        ovs[a, a % U, :n] = rng.uniform(0.1, 9.0, n)
    t = lambda x: torch.as_tensor(x, device=d)  # noqa: E731
    return dict(graph_idx=t(gi.astype(np.int32)),
                start=t(packed.entry[gi].astype(np.int32)),
                executed=t(rng.uniform(0, 1, A).astype(np.float32)),
                streams=walker_streams(5, np.arange(A), np.zeros(A), d),
                attained=t(rng.uniform(0, 9, A).astype(np.float32)),
                ov_samples=t(ovs), ov_counts=t(ovc),
                valid=t(np.arange(A) < A - 3))


def _posterior(packed, gi, seed):
    """Posterior walk tables from random statistics rows (a third of the
    units unobserved)."""
    rng = np.random.default_rng(seed)
    A = gi.shape[0]
    G, U, _ = packed.samples.shape
    rows = np.zeros((A, U, row_width(U)), np.float32)
    seen = rng.random((A, U)) < 0.67
    rows[..., :U + 1] = rng.integers(0, 6, (A, U, U + 1)) * seen[..., None]
    rows[..., U + 2] = rng.integers(1, 9, (A, U)) * seen
    rows[..., U + 1] = rows[..., U + 2] * rng.uniform(0.1, 30.0, (A, U))
    g = gi.long()
    return posterior_tables(torch.as_tensor(rows, device=packed.device),
                            packed.cum_trans[g],
                            prior_mean(packed.samples, packed.counts)[g],
                            branch_strength=8.0, demand_strength=8.0)


@pytest.mark.parametrize("posterior", [False, True], ids=["prior", "post"])
@pytest.mark.parametrize("W", [32, 256, 512, 1024])
def test_kernel_matches_plain_bitwise(dev, W, posterior):
    packed = pack_graphs(build_knowledge_base(n_trials=60, seed=3), T_IN,
                         T_OUT, device=dev)
    r = _rows(packed, 64, W)
    po = dict(zip(("po_cum", "po_scale"), _posterior(packed, r["graph_idx"],
                                                      W))) if posterior else {}

    def call(fn, **kw):
        return fn(packed.samples, packed.counts, packed.cum_trans,
                  r["graph_idx"], r["start"], r["executed"], r["streams"],
                  r["attained"], r["ov_samples"], r["ov_counts"],
                  valid=r["valid"], n_walkers=W, max_steps=64,
                  track_arrivals=True, with_total=True, **po, **kw)

    name = kernel.POSTERIOR_NAME if posterior else kernel.NAME
    before = dict(LAUNCHES)
    k = call(ops.pdgraph_walk_ranked)
    assert LAUNCHES == dict(before, **{name: before[name] + 1})
    # single-phase, as the kernel walks
    p = call(ops.pdgraph_walk_ranked_plain, compact_schedule=())
    torch.cuda.synchronize()
    for key in KEYS:
        assert torch.equal(k[key], p[key]), key


@pytest.mark.parametrize("posterior", [False, True], ids=["prior", "post"])
@pytest.mark.parametrize("arrivals", [False, True])
@pytest.mark.parametrize("W", [32, 100, 256])
def test_phase_kernel_matches_plain_bitwise(dev, W, arrivals, posterior):
    """Each launch of the per-phase walk against ``walk_phase_ref`` on the
    same state, through a compacted walk, with posterior tables or without;
    then ``pdgraph_walk`` against its CPU version (single-phase with
    posterior tables, as the walk runs them on the card)."""
    packed = pack_graphs(build_knowledge_base(n_trials=60, seed=3), T_IN,
                         T_OUT, device=dev)
    A = 64
    G, U, S = packed.samples.shape
    r = _rows(packed, A, W)
    N = A * W
    po = (_posterior(packed, r["graph_idx"], W) if posterior
          else (None, None))
    fpo = ((po[0].reshape(A * U, U + 1), po[1].reshape(A * U)) if posterior
           else (None, None))
    rep = lambda t: torch.repeat_interleave(t, W)  # noqa: E731
    i32 = torch.int32
    st = [rep(r["start"]).to(i32), torch.zeros(N, device=dev),
          rep(~r["valid"]), rep(r["graph_idx"]).to(i32),
          torch.arange(A, device=dev, dtype=i32).repeat_interleave(W),
          rep(r["streams"]).to(torch.int64),
          torch.arange(W, device=dev, dtype=i32).repeat(A)]
    arr = (torch.full((U, N), 1e30, device=dev) if arrivals else None)
    ovs = r["ov_samples"].reshape(A * U, -1)
    ovc = r["ov_counts"].reshape(A * U).float()
    ex = rep(r["executed"])
    for step0, n_steps, keep in ((0, 4, N // 2), (4, 60, None)):
        cur, total, done, gi, app, stream, lane = st
        s32 = torch.where(stream >= 2 ** 31, stream - 2 ** 32,
                          stream).to(i32)
        before = LAUNCHES[kernel.PHASE_NAME]
        k = kernel.pdgraph_walk_kernel(
            packed.samples, packed.counts.float(), packed.cum_trans, ovs,
            ovc, *fpo, cur, total, done, gi, app, s32, lane, ex, arr,
            step0=step0, n_steps=n_steps, lanes_per_app=W, n_apps=A)
        assert LAUNCHES[kernel.PHASE_NAME] == before + 1
        p = walk_phase_ref(
            packed.samples.reshape(G * U, S),
            packed.counts.reshape(G * U).float(),
            packed.cum_trans.reshape(G * U, U + 1), ovs, ovc, cur.long(),
            total, done, gi.long(), app.long(), stream, lane.long(), ex,
            step0=step0, n_steps=n_steps, lanes_per_app=W,
            arrivals=None if arr is None else arr.t().clone(),
            fpo_cum=fpo[0], fpo_scale=fpo[1])
        torch.cuda.synchronize()
        assert torch.equal(k[0].long(), p[0]) and torch.equal(k[1], p[1])
        assert torch.equal(k[2], p[2])
        if arrivals:
            assert torch.equal(k[3], p[3].t())
        if keep is None:
            break
        order = torch.argsort(k[2].to(i32), stable=True)[:keep]
        st = [k[0][order], k[1][order], k[2][order]] + \
            [t[order] for t in st[3:]]
        arr = None if arr is None else k[3][:, order]
        ex = None
        N = keep
    kw = dict(n_walkers=W, max_steps=64, track_arrivals=arrivals,
              compact_after=6, compact_shrink=2, valid=r["valid"])
    cpu_kw = dict(compact_schedule=()) if posterior else {}
    args = [r[k] for k in ("graph_idx", "start", "executed", "streams",
                           "ov_samples", "ov_counts")]
    before = LAUNCHES[kernel.PHASE_NAME]
    k = ops.pdgraph_walk(packed.samples, packed.counts, packed.cum_trans,
                         *args[:4], *args[4:], po_cum=po[0], po_scale=po[1],
                         **kw)
    assert LAUNCHES[kernel.PHASE_NAME] == before + (1 if posterior else 2)
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    p = ops.pdgraph_walk(cpu(packed.samples), cpu(packed.counts),
                         cpu(packed.cum_trans), *map(cpu, args[:4]),
                         *map(cpu, args[4:]), po_cum=cpu(po[0]),
                         po_scale=cpu(po[1]),
                         **dict(kw, valid=cpu(r["valid"]), **cpu_kw))
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# model kernels: RMSNorm (K3), prefill attention (K4), decode attention (K5),
# held to their plain versions at the JAX package's kernel tolerances
# (tests/test_kernels.py: 2e-5 in float32, 2e-2 in bfloat16)

from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


def _normal(rng, shape, dtype, dev):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device=dev).to(dtype)


def _close(a, b, dtype):
    torch.testing.assert_close(a.float(), b.float(), **_tol(dtype))


@pytest.mark.parametrize("shape", [(8, 64), (4, 32, 128), (3, 5, 7, 64),
                                   (37, 1000), (9, 4096), (5, 5000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = _normal(rng, shape, dtype, dev)
    s = _normal(rng, shape[-1:], torch.float32, dev)
    before = LAUNCHES[rms_kernel.NAME]
    out = rms_ops.rmsnorm(x, s, eps=1e-5)
    assert LAUNCHES[rms_kernel.NAME] == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, rmsnorm_ref(x, s, 1e-5), dtype)


def _attention_plain(q, k, v, causal):
    return fa_ops.flash_attention(q.cpu(), k.cpu(),
                                  v.cpu(), causal=causal)


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd", [
    (1, 128, 128, 4, 4, 32),     # the JAX package's kernel test shapes
    (2, 256, 256, 8, 2, 64),
    (1, 64, 256, 4, 1, 128),
    (1, 23, 23, 8, 2, 16),       # odd lengths
    (2, 37, 70, 32, 8, 128),     # Llama-3 heads, ragged blocks
    (1, 9, 9, 28, 4, 128),       # G = 7
])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(dev, B, Sq, Skv, H, K, hd,
                                              dtype, causal):
    rng = np.random.default_rng(Sq * 7 + Skv)
    q = _normal(rng, (B, Sq, H, hd), dtype, dev)
    k = _normal(rng, (B, Skv, K, hd), dtype, dev)
    v = _normal(rng, (B, Skv, K, hd), dtype, dev)
    before = LAUNCHES[fa_kernel.NAME]
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    assert LAUNCHES[fa_kernel.NAME] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _close(out.cpu(), _attention_plain(q, k, v, causal), dtype)


def test_flash_attention_kernel_takes_strided_operands(dev):
    """q/k/v sliced out of one fused projection, as a model may pass them."""
    rng = np.random.default_rng(3)
    B, S, H, K, hd = 2, 40, 8, 2, 64
    qkv = _normal(rng, (B, S, H + 2 * K, hd), torch.float32, dev)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
    out = fa_ops.flash_attention(q, k, v, causal=True)
    _close(out.cpu(), _attention_plain(q, k, v, True), torch.float32)


@pytest.mark.parametrize("B,H,K,hd,Smax,pos", [
    (2, 8, 4, 64, 512, 300),     # the JAX package's kernel test shapes
    (1, 4, 4, 32, 256, 255),
    (3, 6, 2, 128, 1024, 17),
    (1, 32, 8, 128, 192, 100),   # the engine's shape
    (2, 28, 4, 128, 77, 0),      # G = 7, odd Smax, first position
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_matches_plain(dev, B, H, K, hd, Smax, pos,
                                               dtype):
    rng = np.random.default_rng(Smax + pos)
    q = _normal(rng, (B, 1, H, hd), dtype, dev)
    kc = _normal(rng, (B, Smax, K, hd), dtype, dev)
    vc = _normal(rng, (B, Smax, K, hd), dtype, dev)
    before = LAUNCHES[dec_kernel.NAME]
    out = dec_ops.decode_attention(q, kc, vc, pos)
    assert LAUNCHES[dec_kernel.NAME] == before + 1
    ref = dec_ops.decode_attention(q.cpu(), kc.cpu(),
                                   vc.cpu(), pos)
    _close(out.cpu(), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_per_row_lengths(dev, dtype):
    """Per-(batch, KV head) lengths over caches laid out (B, K, Smax, hd)
    in memory and passed as the transposed view the engine passes."""
    rng = np.random.default_rng(11)
    B, H, K, hd, Smax = 5, 16, 4, 128, 333
    q = _normal(rng, (B, 1, H, hd), dtype, dev)
    kc = _normal(rng, (B, K, Smax, hd), dtype, dev).transpose(1, 2)
    vc = _normal(rng, (B, K, Smax, hd), dtype, dev).transpose(1, 2)
    rows = torch.as_tensor(rng.integers(1, Smax + 1, B * K), device=dev,
                           dtype=torch.int32)
    out = dec_ops.decode_attention(q, kc, vc, lengths=rows)
    G = H // K
    rows = rows.cpu()
    ref = decode_attention_ref(
        q.cpu().reshape(B * K, G, hd),
        kc.cpu().permute(0, 2, 1, 3).reshape(B * K, Smax, hd),
        vc.cpu().permute(0, 2, 1, 3).reshape(B * K, Smax, hd), rows)
    _close(out.cpu().reshape(B * K, G, hd), ref, dtype)


def test_attention_kernels_refuse_misaligned_rows(dev):
    """The kernels load 16 bytes at a time: a view whose rows do not start
    16-byte aligned is refused, not read out of line."""
    base = torch.zeros(1, 9, 2, 16 + 1, device=dev)
    k = base[..., 1:]                 # rows 4 bytes past alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_kernel.flash_attention_kernel(torch.zeros(1, 9, 4, 16, device=dev),
                                         k, k, causal=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dec_kernel.decode_attention_kernel(
            torch.zeros(1, 4, 16, device=dev), k, k,
            torch.ones(2, dtype=torch.int32, device=dev))
