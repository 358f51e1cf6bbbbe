"""The kernels on the card against their plain versions: the fused walk
(with and without posterior tables), the per-phase walk, and the model
kernels (RMSNorm, prefill attention, decode attention, the grouped expert
matmul, the SSD chunk scan).

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
                valid=t(np.arange(A) < max(A - 3, 1)))


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


@pytest.mark.parametrize("A", [64, 200])      # one block per SM, or more
@pytest.mark.parametrize("posterior", [False, True], ids=["prior", "post"])
@pytest.mark.parametrize("W", [1, 32, 33, 100, 256, 257, 512, 1024])
def test_kernel_matches_plain_bitwise(dev, W, posterior, A):
    packed = pack_graphs(build_knowledge_base(n_trials=60, seed=3), T_IN,
                         T_OUT, device=dev)
    r = _rows(packed, A, W)
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


@pytest.fixture(scope="module")
def kb_packed(dev):
    return pack_graphs(build_knowledge_base(n_trials=60, seed=3), T_IN,
                       T_OUT, device=dev)


@pytest.mark.parametrize("posterior", [False, True], ids=["prior", "post"])
@pytest.mark.parametrize("overrides", [False, True], ids=["no_ov", "ov"])
@pytest.mark.parametrize("arrivals", [False, True], ids=["no_arr", "arr"])
@pytest.mark.parametrize("max_steps", [0, 1, 64])
@pytest.mark.parametrize("A", [1, 7, 4096])
def test_kernel_rows_and_steps_bitwise(dev, kb_packed, A, max_steps, arrivals,
                                       overrides, posterior):
    """The fused walk at one app, a few and 4,096, walks cut at 0, 1 and
    64 steps, with and without arrival rows, override rows and posterior
    tables: every output bitwise equal to the single-phase plain walk."""
    packed = kb_packed
    r = _rows(packed, A, A + max_steps)
    po = dict(zip(("po_cum", "po_scale"), _posterior(packed, r["graph_idx"],
                                                      A))) if posterior else {}
    ov = ((r["ov_samples"], r["ov_counts"]) if overrides else (None, None))

    def call(fn, **kw):
        return fn(packed.samples, packed.counts, packed.cum_trans,
                  r["graph_idx"], r["start"], r["executed"], r["streams"],
                  r["attained"], *ov, valid=r["valid"], n_walkers=256,
                  max_steps=max_steps, track_arrivals=arrivals,
                  with_total=True, **po, **kw)

    k = call(ops.pdgraph_walk_ranked)
    p = call(ops.pdgraph_walk_ranked_plain, compact_schedule=())
    torch.cuda.synchronize()
    for key in KEYS if arrivals else KEYS[:4]:
        assert torch.equal(k[key], p[key]), key


@pytest.mark.parametrize("W", [1, 33, 100, 256, 257, 512, 1024])
def test_kernel_shared_memory_size(dev, W):
    """The shared memory the source sizes a block with: the staged tables
    and samples (rows rounded to 16 bytes), the totals and first-arrival
    times, and a few words per warp."""
    U, S, So = 4, 547, 128
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    lib = kernel._lib()
    for A in (1, 4096):
        threads = kernel.walk_plan(W, U, A).threads
        fixed = r4(U * (U + 1) + 5 * U) + r4(U * S) + 34 * threads // 32 + 129
        for with_ov, with_arr in ((0, 0), (1, 0), (0, 1), (1, 1)):
            want = 4 * (fixed + W + (r4(U * So) if with_ov else 0)
                        + (U * W if with_arr else 0))
            assert lib.pdgraph_walk_fused_smem(W, U, S, So, threads, with_ov,
                                               with_arr) == want


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


def _synthetic_walk(rng, A, W, U, S, So, dev, *, live=0.7, earlier=False,
                    posterior=False):
    """Random walk tables of ``U`` units (G = 3 graphs) and the flat state of
    ``A`` apps of ``W`` lanes, app-major: a ``live`` share of the lanes
    live, each app on one graph; with ``earlier``, first-arrival times and
    totals that earlier phases left (some units reached, some not)."""
    G = 3
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,  # noqa: E731
                                                    device=dev)
    p = rng.random((G, U, U + 1)) + 0.05
    p[..., U:] += 0.2                              # absorption
    cum = np.cumsum(p / p.sum(-1, keepdims=True), -1)
    cum[..., -1] = 1.0
    app_cum = np.cumsum(rng.random((A * U, U + 1)) + 0.05, -1)
    N = A * W
    gi_app = rng.integers(0, G, A)
    ovc = np.where(rng.random((A, U)) < 0.3, rng.integers(1, So + 1, (A, U)),
                   0)
    st = dict(
        cur=t(rng.integers(0, U, N), torch.int32),
        total=t(rng.uniform(0.0, 40.0, N) if earlier else np.zeros(N)),
        done=t(rng.random(N) >= live, torch.bool),
        gi=t(np.repeat(gi_app, W), torch.int32),
        app=t(np.repeat(np.arange(A), W), torch.int32),
        stream=t(rng.integers(0, 2 ** 32, N), torch.int64),
        lane=t(np.tile(np.arange(W), A), torch.int32),
        ex=t(rng.uniform(0.0, 2.0, N)),
        arr=t(np.where(rng.random((U, N)) < 0.4, rng.uniform(0.0, 40.0,
                                                             (U, N)), 1e30)
              if earlier else np.full((U, N), 1e30)))
    tables = dict(
        samples=t(rng.uniform(0.05, 20.0, (G, U, S))),
        counts=t(rng.integers(1, S + 1, (G, U))),
        cum=t(cum),
        ovs=t(rng.uniform(0.05, 20.0, (A * U, So))),
        ovc=t(ovc.reshape(A * U)),
        po_cum=t(app_cum / app_cum[:, -1:]) if posterior else None,
        po_scale=t(rng.uniform(0.5, 2.0, A * U)) if posterior else None)
    return tables, st


def _phase_vs_plain(tables, st, *, W, A, step0, n_steps, arrivals=True):
    """One launch of the per-phase kernel against ``walk_phase_ref`` on the
    same state: cur, total, done and first arrivals bitwise."""
    G, U, S = tables["samples"].shape
    s32 = torch.where(st["stream"] >= 2 ** 31, st["stream"] - 2 ** 32,
                      st["stream"]).to(torch.int32)
    arr = st["arr"] if arrivals else None
    ex = st["ex"] if step0 == 0 else None
    before = LAUNCHES[kernel.PHASE_NAME]
    k = kernel.pdgraph_walk_kernel(
        tables["samples"], tables["counts"], tables["cum"], tables["ovs"],
        tables["ovc"], tables["po_cum"], tables["po_scale"], st["cur"],
        st["total"], st["done"], st["gi"], st["app"], s32, st["lane"], ex,
        arr, step0=step0, n_steps=n_steps, lanes_per_app=W, n_apps=A)
    assert LAUNCHES[kernel.PHASE_NAME] == before + 1
    p = walk_phase_ref(
        tables["samples"].reshape(G * U, S), tables["counts"].reshape(G * U),
        tables["cum"].reshape(G * U, U + 1), tables["ovs"], tables["ovc"],
        st["cur"].long(), st["total"], st["done"], st["gi"].long(),
        st["app"].long(), st["stream"], st["lane"].long(), ex, step0=step0,
        n_steps=n_steps, lanes_per_app=W,
        arrivals=None if arr is None else arr.t().clone(),
        fpo_cum=tables["po_cum"], fpo_scale=tables["po_scale"])
    torch.cuda.synchronize()
    assert torch.equal(k[0].long(), p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(k[2], p[2])
    if arrivals:
        assert torch.equal(k[3], p[3].t())


# (A, W, U, S, So, step0, n_steps, live, compact, earlier, posterior): the
# composed path's one-app launch (N = 256) and two apps (N = 512), each
# single-phase; 76,800 lanes; U at each UNITS_MAX boundary; a compacted
# state whose live lanes span many apps a block; a later phase whose
# arrivals and totals hold earlier phases' values
PHASE_CASES = {
    "N256": (1, 256, 4, 547, 128, 0, 64, 1.0, False, False, False),
    "N512": (2, 256, 4, 547, 128, 0, 64, 1.0, False, False, False),
    "N512_post": (2, 256, 4, 547, 128, 0, 64, 1.0, False, False, True),
    "throughput": (300, 256, 4, 100, 16, 0, 16, 0.9, False, False, False),
    "U4": (4, 64, 4, 33, 8, 0, 64, 0.8, False, False, False),
    "U5": (4, 64, 5, 33, 8, 0, 64, 0.8, False, False, False),
    "U8": (4, 64, 8, 33, 8, 0, 64, 0.8, False, False, False),
    "U9": (4, 64, 9, 33, 8, 0, 64, 0.8, False, False, True),
    "U16": (4, 64, 16, 33, 8, 0, 64, 0.8, False, False, False),
    "U17": (4, 64, 17, 33, 8, 0, 64, 0.8, False, False, False),
    "U32": (4, 64, 32, 33, 8, 0, 64, 0.8, False, False, True),
    "spread": (2048, 4, 4, 547, 128, 16, 48, 0.5, True, True, False),
    "earlier": (8, 256, 4, 547, 128, 16, 48, 0.5, False, True, False),
}


@pytest.mark.parametrize("arrivals", [True, False], ids=["arr", "no_arr"])
@pytest.mark.parametrize("case", sorted(PHASE_CASES))
def test_phase_kernel_launch_shapes_bitwise(dev, case, arrivals):
    """The per-phase kernel against ``walk_phase_ref``, bitwise, at each
    launch shape of ``PHASE_CASES``.  ``spread`` packs the live lanes of
    2,048 apps first, in app order, as compaction does, so a block's live
    lanes span many apps and graphs."""
    A, W, U, S, So, step0, n_steps, live, compact, earlier, post = \
        PHASE_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    tables, st = _synthetic_walk(rng, A, W, U, S, So, dev, live=live,
                                 earlier=earlier, posterior=post)
    if compact:
        order = torch.argsort(st["done"].to(torch.int32), stable=True)
        st = {k: (v[:, order] if k == "arr" else v[order])
              for k, v in st.items()}
    _phase_vs_plain(tables, st, W=W, A=A, step0=step0, n_steps=n_steps,
                    arrivals=arrivals)


# ---------------------------------------------------------------------------
# model kernels: RMSNorm (K3), prefill attention (K4), decode attention (K5),
# held to their plain versions at the JAX package's kernel tolerances
# (tests/test_kernels.py: 2e-5 in float32, 2e-2 in bfloat16)

from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_partials_ref, decode_attention_ref,
    decode_attention_split_ref)
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


@pytest.mark.parametrize("D", [64, 100, 128, 2048, 4095, 4096, 16384])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_every_plan(dev, D, offset, dtype):
    """Every launch plan: the 16-byte path where rows are aligned and hold
    whole vectors, the one-element path for an input one element off its
    buffer's start or a ragged D; a row count that fills no whole block."""
    rng = np.random.default_rng(D + offset)
    es = torch.empty((), dtype=dtype).element_size()
    plan = rms_kernel.launch_plan(D, es, offset == 0)
    rows = 3 * plan.rows_per_block + 1
    x = _normal(rng, (rows * D + offset,), dtype, dev)[offset:].view(rows, D)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    s = _normal(rng, (D,), torch.float32, dev)
    before = LAUNCHES[rms_kernel.NAME]
    out = rms_ops.rmsnorm(x, s, eps=1e-5)
    assert LAUNCHES[rms_kernel.NAME] == before + 1
    _close(out, rmsnorm_ref(x, s, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_misaligned_scale(dev, dtype):
    rng = np.random.default_rng(7)
    x = _normal(rng, (9, 4096), dtype, dev)
    s = _normal(rng, (4097,), torch.float32, dev)[1:]
    _close(rms_ops.rmsnorm(x, s, eps=1e-5), rmsnorm_ref(x, s, 1e-5), dtype)


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
    (1, 300, 300, 28, 4, 128),   # qwen2-7b's G = 7 over several row blocks
    (2, 77, 77, 48, 8, 128),     # internvl2-26b's G = 6
    (1, 1500, 1500, 20, 20, 64),  # Whisper's encoder frames, G = 1
    (1, 23, 23, 32, 8, 128),     # S not a multiple of a tile
    (2, 70, 300, 16, 4, 64),     # Sq != Skv
    (1, 300, 70, 16, 4, 32),
    (1, 2048, 2048, 32, 8, 128),  # Llama-3 at S = 2,048
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


@pytest.mark.parametrize("B,H,K,Smax,lengths", [
    (5, 16, 4, 333, None),               # random per-(batch, head) lengths
    (1, 32, 8, 8192, [8192]),            # one long row over 16 splits
    (4, 32, 8, 2048, [5, 512, 513, 2048]),  # inside, on, past a boundary
    (2, 32, 8, 192, [100, 192]),         # the engine's Smax: one split
    (3, 32, 8, 1500, [1500, 1, 1024]),
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_per_row_lengths(dev, B, H, K, Smax, lengths,
                                                 dtype):
    """Per-(batch, KV head) lengths over caches laid out (B, K, Smax, hd)
    in memory and passed as the transposed view the engine passes; Smax
    over one or several splits of the sequence."""
    rng = np.random.default_rng(11)
    hd = 128
    q = _normal(rng, (B, 1, H, hd), dtype, dev)
    kc = _normal(rng, (B, K, Smax, hd), dtype, dev).transpose(1, 2)
    vc = _normal(rng, (B, K, Smax, hd), dtype, dev).transpose(1, 2)
    rows = (rng.integers(1, Smax + 1, B * K) if lengths is None
            else np.repeat(lengths, K))
    rows = torch.as_tensor(rows, device=dev, dtype=torch.int32)
    before = LAUNCHES[dec_kernel.NAME]
    out = dec_ops.decode_attention(q, kc, vc, lengths=rows)
    assert LAUNCHES[dec_kernel.NAME] == before + 1
    G = H // K
    rows = rows.cpu()
    ref = decode_attention_ref(
        q.cpu().reshape(B * K, G, hd),
        kc.cpu().permute(0, 2, 1, 3).reshape(B * K, Smax, hd),
        vc.cpu().permute(0, 2, 1, 3).reshape(B * K, Smax, hd), rows)
    _close(out.cpu().reshape(B * K, G, hd), ref, dtype)


@pytest.mark.parametrize("split", [64, 128, 512])   # 16, 8, 2 splits
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_merge_is_fixed(dev, monkeypatch, split, dtype):
    """Back-to-back launches on one stream give identical outputs: the
    merge counters are left zero and the splits merge in a fixed order;
    the result is the plain split merge's."""
    monkeypatch.setattr(dec_kernel, "SPLIT", split)
    rng = np.random.default_rng(split)
    B, H, K, hd, Smax = 3, 28, 4, 128, 1024
    q = _normal(rng, (B, H, hd), dtype, dev)
    kc = _normal(rng, (B, Smax, K, hd), dtype, dev)
    vc = _normal(rng, (B, Smax, K, hd), dtype, dev)
    rows = torch.as_tensor(rng.integers(1, Smax + 1, B * K), device=dev,
                           dtype=torch.int32)
    outs = [dec_kernel.decode_attention_kernel(q, kc, vc, rows)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters, _ = dec_kernel._SCRATCH[(dev.index or 0, stream)]
    assert int(counters.abs().sum()) == 0
    G = H // K
    kf = kc.permute(0, 2, 1, 3).reshape(B * K, Smax, hd)
    vf = vc.permute(0, 2, 1, 3).reshape(B * K, Smax, hd)
    want = decode_attention_split_ref(q.reshape(B * K, G, hd), kf, vf, rows,
                                      n_splits=-(-Smax // split))
    _close(outs[0].reshape(B * K, G, hd), want, dtype)


@pytest.mark.parametrize("Smax", [256, 1024])     # one split, two splits
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_partial_mode(dev, Smax, dtype):
    """K5's partial mode against ``decode_attention_partials_ref``: rows of
    length 0 (o = 0, lse = -inf), 1, either side of a split boundary and
    full; its o carries the merged output's float32 bits (rounded to the
    output dtype, the normal launch's output); counted apart."""
    rng = np.random.default_rng(Smax)
    B, H, K, hd = 2, 32, 8, 128
    q = _normal(rng, (B, H, hd), dtype, dev)
    kc = _normal(rng, (B, K, Smax, hd), dtype, dev).transpose(1, 2)
    vc = _normal(rng, (B, K, Smax, hd), dtype, dev).transpose(1, 2)
    split = dec_kernel.SPLIT
    lens = [0, 1, min(split, Smax), min(split + 1, Smax), Smax]
    rows = torch.as_tensor([lens[i % len(lens)] for i in range(B * K)],
                           dtype=torch.int32, device=dev)
    before = (LAUNCHES[dec_kernel.NAME], LAUNCHES[dec_kernel.PARTIAL_NAME])
    o, lse = dec_kernel.decode_attention_kernel(q, kc, vc, rows,
                                                partial=True)
    out = dec_kernel.decode_attention_kernel(q, kc, vc, rows)
    torch.cuda.synchronize()
    assert (LAUNCHES[dec_kernel.NAME], LAUNCHES[dec_kernel.PARTIAL_NAME]) \
        == (before[0] + 1, before[1] + 1)
    assert o.dtype == lse.dtype == torch.float32
    G = H // K
    kf = kc.permute(0, 2, 1, 3).reshape(B * K, Smax, hd).cpu()
    vf = vc.permute(0, 2, 1, 3).reshape(B * K, Smax, hd).cpu()
    want_o, want_lse = decode_attention_partials_ref(
        q.reshape(B * K, G, hd).cpu(), kf, vf, rows.cpu())
    o, lse = o.reshape(B * K, G, hd).cpu(), lse.reshape(B * K, G).cpu()
    empty = rows.cpu() == 0
    assert bool((lse[empty] == -float("inf")).all())
    assert bool((o[empty] == 0).all())
    _close(o, want_o, dtype)
    torch.testing.assert_close(lse[~empty], want_lse[~empty], rtol=2e-5,
                               atol=2e-5)
    out = out.reshape(B * K, G, hd).cpu()
    assert torch.equal(o[~empty].to(dtype), out[~empty])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_partials_merge_to_the_whole(dev, dtype):
    """A cache's positions split in four slices, each through the partial
    mode (two slices holding no valid position), merged in slice order:
    the whole cache's attention at the kernel tolerance."""
    rng = np.random.default_rng(4)
    B, H, K, hd, Smax, n = 2, 32, 8, 128, 2048, 4
    q = _normal(rng, (B, 1, H, hd), dtype, dev)
    kc = _normal(rng, (B, K, Smax, hd), dtype, dev)
    vc = _normal(rng, (B, K, Smax, hd), dtype, dev)
    pos = 700
    Sl = Smax // n
    parts = []
    for s in range(n):
        ln = min(max(pos + 1 - s * Sl, 0), Sl)
        lengths = torch.full((B * K,), ln, dtype=torch.int32, device=dev)
        parts.append(dec_ops.decode_attention_partials(
            q, kc[:, :, s * Sl:(s + 1) * Sl].transpose(1, 2),
            vc[:, :, s * Sl:(s + 1) * Sl].transpose(1, 2), lengths))
    got = dec_ops.merge_partials(parts, dtype)
    want = dec_ops.decode_attention(q, kc.transpose(1, 2),
                                    vc.transpose(1, 2), pos)
    _close(got, want, dtype)


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


# ---------------------------------------------------------------------------
# the grouped expert matmul (K6), held to its plain version at the JAX
# package's tolerances for it (tests/test_kernels.py: 1e-4 in float32,
# 2e-2 in bfloat16)

from repro_torch.kernels.moe_gmm import kernel as gmm_kernel  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref  # noqa: E402


def _gmm_close(a, b, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("E,C,D,N", [
    (4, 64, 128, 256),           # the JAX package's kernel test shapes
    (2, 128, 256, 128),
    (8, 32, 64, 64),
    (64, 1, 2048, 1408),         # Qwen1.5-MoE decode: wi / wg, then wo
    (64, 1, 1408, 2048),
    (64, 8, 2048, 1408),         # its short prefill (C = 8)
    (64, 8, 1408, 2048),
    (16, 3, 64, 96),             # tiny models, ragged C and N tiles
    (16, 13, 96, 64),
    (5, 2, 8, 8),
    (3, 37, 520, 200),           # D past a stage, N past a tile
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_gmm_kernel_matches_plain(dev, E, C, D, N, dtype):
    rng = np.random.default_rng(E + C + D + N)
    x = _normal(rng, (E, C, D), dtype, dev)
    w = (_normal(rng, (E, D, N), torch.float32, dev) * 0.1).to(dtype)
    before = LAUNCHES[gmm_kernel.NAME]
    out = gmm_ops.moe_gmm(x, w)
    assert LAUNCHES[gmm_kernel.NAME] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (E, C, N)
    _gmm_close(out, moe_gmm_ref(x, w), dtype)


@pytest.mark.parametrize("C", [1, 3, 8, 13, 160, 300])
@pytest.mark.parametrize("E,D,N", [
    (64, 2048, 1408),            # Qwen1.5-MoE: wi / wg, then wo
    (64, 1408, 2048),
    (16, 64, 96),                # the JAX package's sweep widths
    (16, 96, 64),
])
def test_moe_gmm_tensor_core_panels(dev, E, C, D, N):
    """The bf16 tensor-core path at every panel width class the MoE layer
    gives it (C = 1 decode, 8 a short prefill, 160 a 2,048-token prompt,
    300 two panels), on a contiguous buffer, a ``buf[:, :C]`` view of an
    (E, C + 1, D) buffer and one token buffer repeated across the experts
    (expert stride 0)."""
    dtype = torch.bfloat16
    rng = np.random.default_rng(E + C + D + N)
    w = (_normal(rng, (E, D, N), torch.float32, dev) * D ** -0.5).to(dtype)
    buf = _normal(rng, (E, C + 1, D), dtype, dev)
    rep = buf[0, :C].unsqueeze(0).expand(E, C, D)
    assert rep.stride(0) == 0
    for x in (buf[:, :C].contiguous(), buf[:, :C], rep):
        _gmm_close(gmm_ops.moe_gmm(x, w), moe_gmm_ref(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_gmm_kernel_takes_strided_token_buffers(dev, dtype):
    """The MoE layer's operands: a buffer cut from (E, C + 1, D) and one
    token row repeated across the experts (expert stride 0)."""
    rng = np.random.default_rng(4)
    E, C, D, N = 16, 8, 256, 96
    w = (_normal(rng, (E, D, N), torch.float32, dev) * 0.1).to(dtype)
    buf = _normal(rng, (E, C + 1, D), dtype, dev)[:, :C]
    _gmm_close(gmm_ops.moe_gmm(buf, w), moe_gmm_ref(buf, w), dtype)
    rep = _normal(rng, (1, D), dtype, dev).unsqueeze(0).expand(E, 1, D)
    _gmm_close(gmm_ops.moe_gmm(rep, w), moe_gmm_ref(rep, w), dtype)


def test_moe_gmm_kernel_refuses_what_it_cannot_take(dev):
    x = torch.zeros(4, 2, 16, device=dev)
    w = torch.zeros(4, 16, 24, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gmm_kernel.moe_gmm_kernel(torch.zeros(4, 2, 17, device=dev)[..., 1:],
                                  w)
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm_kernel.moe_gmm_kernel(x, torch.zeros(4, 16, 20, device=dev))
    with pytest.raises(TypeError, match="bfloat16"):
        gmm_kernel.moe_gmm_kernel(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        gmm_kernel.moe_gmm_kernel(x, w.transpose(1, 2).contiguous()
                                  .transpose(1, 2)[:, :, :16])


# ---------------------------------------------------------------- SSD scan
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked,  # noqa: E402
                                              ssd_scan_ref)


def _ssd_inputs(rng, B, S, H, P, N, dtype, dev):
    """The reference test's distributions (tests/test_kernels.py)."""
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=dev)
    return (_normal(rng, (B, S, H, P), dtype, dev),
            t(rng.uniform(0.001, 0.1, size=(B, S, H))),
            t(-rng.uniform(0.5, 2.0, size=(H,))),
            _normal(rng, (B, S, N), dtype, dev),
            _normal(rng, (B, S, N), dtype, dev))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 128, 2, 32, 16, 32),     # the JAX package's kernel test shapes
    (2, 256, 4, 64, 32, 64),
    (1, 64, 8, 16, 8, 64),
    (1, 8, 64, 64, 128, 128),    # mamba2-1.3b's serve prompts
    (1, 24, 64, 64, 128, 128),
    (1, 300, 64, 64, 128, 128),  # two chunks and a ragged 44-position tail
    (2, 37, 8, 16, 16, 8),       # the tiny models: chunk 8, ragged
    (1, 5, 3, 4, 4, 128),        # fewer rows than a 4-row tile
    (1, 200, 2, 128, 128, 64),   # P = 128 (Jamba's head width)
    (1, 200, 2, 128, 128, 128),  # ... at its config's chunk (f32 takes 64)
    (1, 128, 4, 64, 128, 128),   # one chunk
    (1, 256, 4, 64, 128, 128),   # two chunks, handed over once
    (1, 2176, 2, 64, 128, 128),  # 17 chunks
    (1, 2100, 3, 96, 128, 128),  # 17, a ragged tail, 1.5 column blocks
    (2, 70, 5, 36, 20, 16),      # N and P off the 8-element copies
    (1, 3, 2, 8, 8, 128),        # S < 4
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_kernel_matches_plain(dev, B, S, H, P, N, chunk, dtype):
    """y against the chunked plain version at the reference's SSD
    tolerances (1e-4 float32, 5e-2 bfloat16), and against the sequential
    oracle; the float32 final state at 1e-4 in either dtype (both sides
    carry it in float32 from the same rounded inputs)."""
    rng = np.random.default_rng(B + S + H + P + N)
    args = _ssd_inputs(rng, B, S, H, P, N, dtype, dev)
    before = LAUNCHES[ssd_kernel.NAME]
    y, final = ssd_ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES[ssd_kernel.NAME] == before + 1
    assert y.dtype == dtype and tuple(y.shape) == (B, S, H, P)
    assert final.dtype == torch.float32 and tuple(final.shape) == (B, H, N, P)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    want_y, want_final = ssd_chunked(*args, chunk)
    for got, want, t in ((y, want_y, tol), (final, want_final, 1e-4),
                         (y, ssd_scan_ref(*args), tol)):
        torch.testing.assert_close(got.float(), want.float(), rtol=t, atol=t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_kernel_is_deterministic(dev, dtype):
    """Two launches on the same inputs give the same bits: the chunk
    hand-off and every sum run in a fixed order."""
    rng = np.random.default_rng(5)
    args = _ssd_inputs(rng, 1, 1000, 8, 64, 128, dtype, dev)
    y1, f1 = ssd_kernel.ssd_scan_kernel(*args, chunk=128)
    y2, f2 = ssd_kernel.ssd_scan_kernel(*args, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(f1, f2)


def test_ssd_scan_shared_memory_plan(dev):
    """The plans' shared-memory sizes are the built source's, and the new
    bfloat16 plan holds every chunk up to 128 at P = 128 (Jamba's head
    width: 64 state columns a block), where the float32 plan halves the
    chunk to 64."""
    lib = ssd_kernel._lib()
    for L in (1, 8, 24, 100, 128):
        for N in (4, 16, 20, 128):
            assert lib.ssd_scan_bf16_smem_bytes(L, N) == \
                ssd_kernel.bf16_smem_bytes(L, N)
            for P in (4, 64, 128):
                assert lib.ssd_scan_smem_bytes(L, N, P) == \
                    ssd_kernel.f32_smem_bytes(L, N, P)
    plan = ssd_kernel.scan_plan(torch.bfloat16, 1, 2048, 8, 128, 128, 128)
    assert plan.chunk == 128 and plan.col_blocks == 2
    assert plan.smem <= ssd_kernel.SMEM_MAX
    assert ssd_kernel.scan_plan(torch.float32, 1, 2048, 8, 128, 128,
                                128).chunk == 64


def test_ssd_scan_kernel_refuses_what_it_cannot_take(dev):
    rng = np.random.default_rng(1)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, 16, 2, 8, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        ssd_kernel.ssd_scan_kernel(x[..., :6].contiguous(), dt, A, Bm, Cm,
                                   chunk=8)
    with pytest.raises(TypeError, match="bfloat16"):
        ssd_kernel.ssd_scan_kernel(x, dt, A, Bm.to(torch.bfloat16), Cm,
                                   chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_kernel.ssd_scan_kernel(x.transpose(1, 2).contiguous()
                                   .transpose(1, 2), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="disagree"):
        ssd_kernel.ssd_scan_kernel(x, dt[:, :8].contiguous(), A, Bm, Cm,
                                   chunk=8)
    with pytest.raises(ValueError, match="chunk must be in"):
        ssd_kernel.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=129)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, 1, 16, 2, 128, 512, torch.float32,
                                   dev)
    with pytest.raises(ValueError, match="shared memory at chunk 1"):
        ssd_kernel.ssd_scan_kernel(x, dt, A, Bm, Cm, chunk=128)


# ---------------------------------------------------------------------------
# the encoder-decoder (whisper-large-v3) and VLM (internvl2-26b) shapes of
# K4 and K5, and the tiny models of both families on the card against the
# CPU

@pytest.mark.parametrize("B,Sq", [(1, 4), (4, 24), (4, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_cross_shapes(dev, B, Sq, dtype):
    """Whisper's cross-attention in prefill: a short prompt (Sq) over the
    encoder's 1,500 frames, not causal, H = K = 20, hd 64."""
    rng = np.random.default_rng(B * 31 + Sq)
    q = _normal(rng, (B, Sq, 20, 64), dtype, dev)
    k = _normal(rng, (B, 1500, 20, 64), dtype, dev)
    v = _normal(rng, (B, 1500, 20, 64), dtype, dev)
    before = LAUNCHES[fa_kernel.NAME]
    out = fa_ops.flash_attention(q, k, v, causal=False)
    assert LAUNCHES[fa_kernel.NAME] == before + 1
    _close(out.cpu(), _attention_plain(q, k, v, False), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_internvl_prefill(dev, dtype):
    """InternVL's prefill: 1,024 patches and a 24-token prompt, causal,
    H = 48, K = 8 (G = 6), hd 128."""
    rng = np.random.default_rng(1048)
    q = _normal(rng, (1, 1048, 48, 128), dtype, dev)
    k = _normal(rng, (1, 1048, 8, 128), dtype, dev)
    v = _normal(rng, (1, 1048, 8, 128), dtype, dev)
    out = fa_ops.flash_attention(q, k, v, causal=True)
    _close(out.cpu(), _attention_plain(q, k, v, True), dtype)


@pytest.mark.parametrize("B,H,K,Smax,full", [
    (1, 20, 20, 1500, True),     # Whisper's cross-attention decode, B.K = 20
    (4, 20, 20, 1500, True),     # four utterances, B.K = 80
    (4, 20, 20, 448, False),     # Whisper's decoder self-attention
    (2, 48, 8, 1064, False),     # InternVL's decode (G = 6)
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_encdec_vlm_shapes(dev, B, H, K, Smax, full, dtype):
    """K5 over caches laid out (B, K, Smax, hd) as the models keep them:
    every row the whole 1,500 frames (cross-attention), or random lengths
    (self-attention)."""
    rng = np.random.default_rng(Smax + B)
    hd = 64 if H == 20 else 128
    from repro_torch.models.layers import decode_step_attention
    q = _normal(rng, (B, 1, H, hd), dtype, dev)
    kc = _normal(rng, (B, K, Smax, hd), dtype, dev)
    vc = _normal(rng, (B, K, Smax, hd), dtype, dev)
    rows = (np.full(B * K, Smax) if full
            else rng.integers(1, Smax + 1, B * K))
    rows = torch.as_tensor(rows, device=dev, dtype=torch.int32)
    before = LAUNCHES[dec_kernel.NAME]
    out = decode_step_attention(q, kc, vc, rows)
    assert LAUNCHES[dec_kernel.NAME] == before + 1
    want = decode_step_attention(q.cpu(), kc.cpu(), vc.cpu(), rows.cpu())
    _close(out.cpu(), want, dtype)


@pytest.mark.parametrize("k0,k1", [(5, 10), (15, 20)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_over_a_rank_s_kv_heads(dev, k0, k1, dtype):
    """K5 over a strided view of the KV heads ``[k0, k1)`` of caches that
    hold every head (a rank's query heads of Whisper's cross-attention
    at a model axis of 4, ``layers.head_decode_attention``) against its
    plain version on the same view."""
    from repro_torch.models.layers import decode_step_attention
    rng = np.random.default_rng(k0)
    B, K, F, hd = 2, 20, 1500, 64
    q = _normal(rng, (B, 1, k1 - k0, hd), dtype, dev)
    kc = _normal(rng, (B, K, F, hd), dtype, dev)[:, k0:k1]
    vc = _normal(rng, (B, K, F, hd), dtype, dev)[:, k0:k1]
    rows = torch.full((B * (k1 - k0),), F, dtype=torch.int32, device=dev)
    before = LAUNCHES[dec_kernel.NAME]
    out = decode_step_attention(q, kc, vc, rows)
    assert LAUNCHES[dec_kernel.NAME] == before + 1
    want = decode_step_attention(q.cpu(), kc.cpu(), vc.cpu(), rows.cpu())
    _close(out.cpu(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["whisper-large-v3", "internvl2-26b"])
def test_tiny_encdec_and_vlm_models_card_vs_cpu(dev, name, dtype):
    """The tiny models from one set of weights on the card (K3 where the
    family has RMSNorm, K4, K5) and on the CPU (the plain versions):
    prefill logits and four decode steps within the model tolerances
    (1e-4 float32, 5e-2 bfloat16); the launch counts the code implies."""
    from repro_torch.kernels import reset_launches
    from repro_torch.models.model import build_model
    from repro_torch.testing import tiny_config
    cfg = tiny_config(name, dtype=dtype)
    cpu = build_model(cfg, device="cpu", max_seq=32).init(
        torch.Generator().manual_seed(0))
    card = build_model(cfg, device=dev, max_seq=32).load_params(cpu.params())
    rng = np.random.default_rng(2)
    B, S = 2, 5
    tokens = torch.as_tensor(rng.integers(1, 256, (B, S)))
    key, rows = (("frames", cfg.enc_frames) if cfg.family == "encdec"
                 else ("patch_embeds", cfg.vision_patches))
    side = torch.as_tensor(rng.normal(size=(B, rows, cfg.d_model)),
                           dtype=torch.float32)
    tol = 1e-4 if dtype == "float32" else 5e-2
    out = {}
    for model in (card, cpu):
        reset_launches()
        caches, logits = model.prefill(tokens, **{key: side})
        S0 = caches["k"].shape[3]
        big = model.new_caches(B, S0 + 4)
        for n, c in caches.items():
            if n in ("k", "v"):
                big[n][:, :, :, :S0] = c
            else:
                big[n].copy_(c)
        steps = [logits]
        for t in range(4):
            big, logits = model.decode(big, tokens[:, t:t + 1], S0 + t)
            steps.append(logits)
        out[model.device.type] = torch.cat([s.float().cpu() for s in steps],
                                           dim=1)
        if model is card:
            launches = dict(LAUNCHES)
    L, E = cfg.num_layers, cfg.enc_layers
    if cfg.family == "encdec":
        want = {"rmsnorm": 0, "flash_attention": E + 2 * L,
                "decode_attention": 4 * 2 * L}
    else:
        want = {"rmsnorm": 5 * (2 * L + 1), "flash_attention": L,
                "decode_attention": 4 * L}
    assert {k: launches.get(k, 0) for k in want} == want
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=tol, atol=tol)


# ------------------------------------------------------------------ training
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_plain)


def _autograd_cases(dev, dtype, rng):
    """(name, wrapper, plain, inputs, kernel) at one shape per kernel."""
    f32 = torch.float32
    x, scale = _normal(rng, (6, 128), dtype, dev), _normal(rng, (128,), f32,
                                                           dev)
    q = _normal(rng, (2, 40, 8, 64), dtype, dev)
    k, v = (_normal(rng, (2, 40, 2, 64), dtype, dev) for _ in range(2))
    xe, we = _normal(rng, (4, 24, 64), dtype, dev), _normal(rng, (4, 64, 96),
                                                            dtype, dev)
    ssd = _ssd_inputs(rng, 2, 40, 4, 16, 16, dtype, dev)
    return [
        ("rmsnorm", lambda a, b: rms_ops.rmsnorm(a, b, eps=1e-5),
         lambda a, b: rmsnorm_ref(a, b, 1e-5), (x, scale),
         lambda a, b: rms_kernel.rmsnorm_kernel(a, b, eps=1e-5)),
        ("flash_attention", lambda *a: fa_ops.flash_attention(*a),
         lambda *a: flash_attention_plain(*a, True), (q, k, v),
         lambda *a: fa_kernel.flash_attention_kernel(*a, causal=True)),
        ("moe_gmm", gmm_ops.moe_gmm, moe_gmm_ref, (xe, we),
         gmm_kernel.moe_gmm_kernel),
        ("ssd_scan", lambda *a: ssd_ops.ssd_scan(*a, chunk=16),
         lambda *a: ssd_chunked(*a, 16), ssd,
         lambda *a: ssd_kernel.ssd_scan_kernel(*a, chunk=16)),
    ]


@pytest.mark.parametrize("which", range(4),
                         ids=["rmsnorm", "flash", "moe_gmm", "ssd"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_wrapper_is_the_kernel_forward_and_plain_backward(
        dev, which, dtype):
    """Under autograd a wrapper's output is its kernel's, bit for bit (one
    launch), and its gradients are the plain version's autograd gradients
    on the same inputs, bit for bit (no launch)."""
    rng = np.random.default_rng(31)
    name, wrapper, plain, inputs, kernel = _autograd_cases(dev, dtype,
                                                           rng)[which]
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    before = LAUNCHES[name]
    out = wrapper(*leaves)
    assert LAUNCHES[name] == before + 1
    want = kernel(*inputs)
    outs, wants = ((out, want) if isinstance(out, tuple)
                   else ((out,), (want,)))
    for a, b in zip(outs, wants):
        assert a.requires_grad and torch.equal(a.detach(), b)
    cot = [_normal(rng, a.shape, a.dtype, dev) for a in outs]
    got = torch.autograd.grad(outs, leaves, cot)
    assert LAUNCHES[name] == before + 2     # the kernel call above only
    ref = [t.clone().requires_grad_(True) for t in inputs]
    pouts = plain(*ref)
    pouts = pouts if isinstance(pouts, tuple) else (pouts,)
    for g, w in zip(got, torch.autograd.grad(pouts, ref, cot)):
        assert torch.equal(g, w)


def _train_counts(cfg, passes):
    """The model kernels' launches of one ``train_loss`` forward, the
    layers' ``passes`` times (2 with remat: the backward recomputes them)
    and the final norm once."""
    from repro_torch.models.transformer import layer_kinds
    if cfg.family == "encdec":
        return {"rmsnorm": 0, "moe_gmm": 0, "ssd_scan": 0,
                "flash_attention": cfg.enc_layers
                + passes * 2 * cfg.num_layers}
    k3 = k4 = k6 = k7 = 0
    for mixer, ffn in layer_kinds(cfg):
        k3 += 1 + (ffn != "none") + (mixer == "mamba") \
            + 2 * (mixer == "attn" and cfg.qk_norm)
        k4 += mixer == "attn"
        k7 += mixer == "mamba"
        k6 += 3 * (ffn == "moe")
    return {"rmsnorm": passes * k3 + 1, "flash_attention": passes * k4,
            "moe_gmm": passes * k6, "ssd_scan": passes * k7}


@pytest.mark.parametrize("remat", [False, True])
def test_train_path_launches_no_plain_forward(dev, monkeypatch, remat):
    """The tiny Jamba (K3, K4, K6, K7 in one model): its training forward
    launches every kernel and calls no plain version; its backward calls
    the plain versions and launches only the recompute under remat."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import reset_launches
    from repro_torch.models.model import build_model
    from repro_torch.testing import tiny_config
    calls = {}
    for mod, fn in ((rms_ops, "rmsnorm_ref"), (fa_ops, "attention_ref"),
                    (gmm_ops, "moe_gmm_ref"), (ssd_ops, "ssd_chunked")):
        def counted(*a, _f=getattr(mod, fn), _n=fn, **kw):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, fn, counted)
    cfg = tiny_config("jamba-1.5-large-398b", dtype="float32", remat=remat)
    model = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0)).trainable()
    batch = batch_at(DataConfig(256, 16, 2), 0)
    reset_launches()
    loss = model.train_loss(batch)
    names = ("rmsnorm", "flash_attention", "moe_gmm", "ssd_scan")
    assert {n: LAUNCHES[n] for n in names} == _train_counts(cfg, 1)
    assert calls == {}
    torch.autograd.grad(loss, list(model.params().values()),
                        allow_unused=True)
    assert {n: LAUNCHES[n] for n in names} == _train_counts(
        cfg, 2 if remat else 1)
    assert set(calls) == {"rmsnorm_ref", "attention_ref", "moe_gmm_ref",
                          "ssd_chunked"}


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b",
                                  "whisper-large-v3", "internvl2-26b"])
def test_tiny_training_step_card_vs_cpu(dev, name):
    """One float32 training step from one set of weights on the card and
    on the CPU: loss within 1e-4 relative, each gradient within 1e-4 of
    its tensor's largest magnitude, the weights after ``adamw_update`` of
    the card's gradients on the card and on the CPU within 1e-4 (from
    each side's own gradients they may differ by up to lr: Adam's first
    step moves a weight by about lr * g / |g|)."""
    from repro_torch.config import TrainConfig
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models.model import build_model
    from repro_torch.testing import tiny_config
    from repro_torch.training.optimizer import adamw_update, init_opt_state
    cfg = tiny_config(name, dtype="float32", remat=True)
    max_seq = 32 if cfg.family == "encdec" else 0
    cpu = build_model(cfg, device="cpu", max_seq=max_seq).init(
        torch.Generator().manual_seed(0))
    card = build_model(cfg, device=dev, max_seq=max_seq).load_params(
        cpu.params())
    batch = batch_at(DataConfig(256, 16, 2), 0)
    rng = np.random.default_rng(3)
    key = {"encdec": ("frames", cfg.enc_frames),
           "vlm": ("patch_embeds", cfg.vision_patches)}.get(cfg.family)
    if key:
        batch[key[0]] = rng.normal(size=(2, key[1], cfg.d_model)).astype(
            np.float32)
    out = {}
    for model in (card, cpu):
        params = model.trainable().params()
        loss = model.train_loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        out[model.device.type] = (float(loss.detach()), {
            n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)})
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    for n in gp:
        scale = float(gp[n].abs().max())
        torch.testing.assert_close(gc[n].cpu(), gp[n], rtol=1e-4,
                                   atol=1e-4 * scale + 1e-30, msg=n)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0)
    for model, g in ((card, gc), (cpu, {n: t.cpu() for n, t in gc.items()})):
        params = model.params()
        adamw_update(g, init_opt_state(params), params, tcfg)
    for n, p in cpu.params().items():
        torch.testing.assert_close(card.params()[n].detach().cpu(),
                                   p.detach(), rtol=1e-4, atol=1e-4, msg=n)


def test_restart_is_bit_exact_on_the_card(tmp_path):
    """The reference's contract on ``cuda``: the post-restart losses equal
    the uninterrupted run's; the card's checkpoint restores onto the CPU
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.checkpoint.checkpointing import restore_checkpoint
    from repro_torch.config import TrainConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.model import build_model
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.testing import tiny_config
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_loop import (run_training,
                                                 run_training_with_restarts)
    cfg = tiny_config("llama3-8b", num_layers=2, d_model=32, d_ff=64,
                      dtype="float32")
    dcfg = DataConfig(vocab_size=256, seq_len=32, global_batch=4)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5,
                       checkpoint_every=10)
    a = run_training(cfg, tcfg, dcfg, total_steps=35, verbose=False,
                     ckpt_dir=str(tmp_path / "a"), device="cuda")
    b = run_training_with_restarts(cfg, tcfg, dcfg, total_steps=35,
                                   ckpt_dir=str(tmp_path / "b"),
                                   injector=FailureInjector(17),
                                   verbose=False, device="cuda")
    assert b.restarts == 1 and a.losses[-25:] == b.losses[-25:]
    targets = {}
    for d in ("cuda", "cpu"):
        p = build_model(cfg, device=d).params()
        targets[d], _ = restore_checkpoint(str(tmp_path / "b"),
                                           (p, init_opt_state(p)))
    on_card, on_cpu = targets["cuda"], targets["cpu"]
    for n, t in on_card[0].items():
        assert t.is_cuda and torch.equal(t.cpu(), on_cpu[0][n])
        assert torch.equal(on_card[1].m[n].cpu(), on_cpu[1].m[n])


# ---------------------------------------------------------------- the mesh

def _mesh_store(device, n_shards, cap=512, W=64):
    """A sharded arena of ``cap - 8`` apps (overrides on every ninth) and
    its prewarm table, the same on every device."""
    from repro_torch.core.arena import QueueState
    from repro_torch.core.hermeslet import warmup_time_for
    from repro_torch.core.prewarm import build_prewarm_table
    kb = build_knowledge_base(n_trials=60, seed=3)
    packed = pack_graphs(kb, T_IN, T_OUT, device=device)
    tab = build_prewarm_table(kb, packed, warmup_time_for)
    qs = QueueState(packed, capacity=cap, n_shards=n_shards)
    rng = np.random.default_rng(4)
    gi = rng.integers(0, len(packed.names), cap - 8)
    qs.admit_many([(f"a{i}", int(g), int(packed.entry[g]), i, None)
                   for i, g in enumerate(gi)])
    for i in range(0, cap - 8, 9):
        qs.set_override(f"a{i}", i % packed.n_units,
                        rng.uniform(0.1, 6.0, 1 + i % 7))
    return packed, tab, qs


def _mesh_ticks(device, n_shards, rik, lane):
    """Three mesh ticks: every slot, a uniform dirty set, and a skewed one
    (slots 0 mod 4, lane-balanced with ``lane``), each with progress on
    other slots; returns the store and each tick's K1 / K2 launches and
    walking shards."""
    from repro_torch.core.refresh_mesh import RefreshMesh, refresh_ranks_mesh
    from repro_torch.kernels import reset_launches
    packed, tab, qs = _mesh_store(device, n_shards)
    mesh = RefreshMesh(n_shards, device=device)
    rng = np.random.default_rng(9)
    out = []
    for tick in range(3):
        occ = qs.occupied()
        if tick:
            pick = (occ[occ % 4 == 0][:40] if tick == 2
                    else rng.choice(occ, 40, replace=False))
            for s in pick:
                qs.set_unit(qs.ids[s], int(rng.integers(0, packed.n_units)))
            for s in rng.choice(occ, 30, replace=False):
                qs.add_progress(qs.ids[s], 0.5)
        walked = qs.take_dirty()
        ranked = np.asarray(sorted(qs.take_rank_dirty() | set(walked)),
                            np.int64)
        reset_launches()
        t = refresh_ranks_mesh(
            packed, qs, 7, mesh=mesh, walked=walked, ranked=ranked,
            n_walkers=64, prewarm_table=tab, with_triage=True,
            rank_in_kernel=rik, lane_balance=lane if tick == 2 else None)
        shards = (min(n_shards, len(walked)) if t.balanced
                  else len(set((walked % n_shards).tolist())))
        out.append((dict(LAUNCHES), shards, t.balanced, t.spill))
        qs.bump_refresh(walked)
    return qs, out


@pytest.mark.parametrize("rik", [True, False], ids=["K1", "K2"])
@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_mesh_tick_on_the_card_equals_the_cpu(dev, n_shards, rik):
    """The mesh tick on ``cuda`` (K1 a shard, or K2's phases a shard)
    against the CPU's plain versions, bit for bit: ranks, triage scalars,
    trigger rows and every arena row; K1 launches once for each shard
    with walk rows, K2 at least once, and neither falls back."""
    lane = 0.0 if n_shards > 1 else None
    q_dev, ticks = _mesh_ticks(dev, n_shards, rik, lane)
    q_cpu, cpu_ticks = _mesh_ticks(torch.device("cpu"), n_shards, rik, lane)
    for name in ("rank", "sup", "opt", "mean", "trig", "reach", "a_att"):
        np.testing.assert_array_equal(getattr(q_dev, name),
                                      getattr(q_cpu, name), err_msg=name)
    for name in ("d_probs", "d_edges", "a_hist", "a_lo", "a_span",
                 "a_reach"):
        assert torch.equal(getattr(q_dev, name).cpu(),
                           getattr(q_cpu, name)), name
    for (launches, shards, balanced, spill), cpu in zip(ticks, cpu_ticks):
        assert spill == 0 and cpu[3] == 0
        assert balanced == cpu[2]
        if rik:
            assert launches[kernel.NAME] == shards
            assert launches[kernel.PHASE_NAME] == 0
        else:
            assert launches[kernel.NAME] == 0
            assert launches[kernel.PHASE_NAME] >= shards
    assert ticks[2][2] == (n_shards > 1)          # the skewed tick balanced


# ------------------------------------------------ EP, remat policies, tables

@pytest.mark.parametrize("shape", [(1, 1), (1, 4), (2, 2)],
                         ids=["1x1", "1x4", "2x2"])
def test_ep_moe_on_the_card_equals_the_cpu(dev, shape):
    """The expert-parallel MoE layer (float32, 12 experts padded to 16, a
    capacity factor that drops copies) on ``cuda`` against the CPU from
    the same weights: within 1e-4, the same copies kept, and three K6
    launches (one a product over every rank's expert buffers)."""
    from repro_torch.distributed import ep_moe
    from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as X
    from repro_torch.testing import tiny_config
    cfg = tiny_config("qwen2-moe-a2.7b", dtype="float32", moe_impl="ep",
                      num_experts=12, capacity_factor=0.75)
    cpu = X.MoE(cfg, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in cpu.parameters():
            t.normal_(generator=gen).mul_(0.125)
    card = X.MoE(cfg, torch.float32, dev)
    with torch.no_grad():
        for a, b in zip(card.parameters(), cpu.parameters()):
            a.copy_(b)
    x = torch.randn(4, 32, cfg.d_model, generator=gen)
    out, keeps = {}, {}
    pack = ep_moe._pack_by_key
    for side, p, xs in (("cuda", card, x.to(dev)), ("cpu", cpu, x)):
        seen = keeps[side] = []

        def recording(keys, n_bins, capacity, _seen=seen):
            res = pack(keys, n_bins, capacity)
            _seen.append(res[3].cpu())
            return res

        ep_moe._pack_by_key = recording
        try:
            reset_launches()
            with use_shard_ctx(ShardCtx(make_mesh(shape, ("data", "model"),
                                                  dev))):
                out[side] = X.moe_apply(p, xs, cfg)
            launches = LAUNCHES.get("moe_gmm", 0)
        finally:
            ep_moe._pack_by_key = pack
        if side == "cuda":
            assert launches == 3
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], rtol=0,
                               atol=1e-4)
    assert len(keeps["cuda"]) == len(keeps["cpu"]) == 2
    for a, b in zip(keeps["cuda"], keeps["cpu"]):
        assert torch.equal(a, b)
    assert not keeps["cpu"][0].all()               # copies were dropped


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_ep_training_under_remat_on_the_card_equals_the_cpu(dev, policy):
    """One float32 training step of the tiny MoE under EP (1, 4) with
    remat: the card's backward (and its recompute) runs in the autograd
    engine's thread, which must re-enter the forward's shard context;
    loss within 1e-4 relative, each gradient within 1e-4 of its tensor's
    largest magnitude."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.testing import tiny_config
    cfg = tiny_config("qwen2-moe-a2.7b", dtype="float32", moe_impl="ep",
                      num_experts=12, remat=True, remat_policy=policy)
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    card = build_model(cfg, device=dev).load_params(cpu.params())
    batch = batch_at(DataConfig(256, 16, 2), 0)
    out = {}
    for model in (card, cpu):
        params = model.trainable().params()
        mesh = make_mesh((1, 4), ("data", "model"), model.device)
        with use_shard_ctx(ShardCtx(mesh)):
            loss = model.train_loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        out[model.device.type] = (float(loss.detach()),
                                  dict(zip(params, grads)))
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    assert abs(lc - lp) <= 1e-4 * abs(lp)
    for n in gp:
        scale = float(gp[n].abs().max())
        torch.testing.assert_close(gc[n].cpu(), gp[n], rtol=1e-4,
                                   atol=1e-4 * scale + 1e-30, msg=n)


@pytest.mark.parametrize("policy", ["dots", "offloadable"])
def test_remat_policies_keep_the_full_gradients_on_the_card(dev, policy):
    """A tiny float32 Llama and MoE under each selective policy on the
    card: the loss and every gradient equal ``"full"``'s bit for bit, and
    the kernels launch as under ``"full"`` (the recompute runs them
    again)."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import reset_launches
    from repro_torch.models.model import build_model
    from repro_torch.testing import tiny_config
    batch = batch_at(DataConfig(256, 16, 2), 0)
    for name in ("llama3-8b", "qwen2-moe-a2.7b"):
        runs = []
        for pol in ("full", policy):
            cfg = tiny_config(name, dtype="float32", remat=True,
                              remat_policy=pol)
            model = build_model(cfg, device=dev).init(
                torch.Generator(device=dev).manual_seed(0)).trainable()
            params = model.params()
            reset_launches()
            loss = model.train_loss(batch)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            runs.append((float(loss.detach()), grads, dict(LAUNCHES)))
        (la, ga, ka), (lb, gb, kb) = runs
        assert la == lb and ka == kb, name
        for a, b in zip(ga, gb):
            assert (a is None and b is None) or torch.equal(a, b), name


def test_card_refresh_builds_no_walk_tables(dev, monkeypatch):
    """The ranked refresh on ``cuda`` launches K1, which reads no lookup
    tables: none are built."""
    from repro_torch.core import refresh_pipeline
    from repro_torch.core.refresh_config import RefreshConfig
    from repro_torch.core.scheduler import HermesScheduler
    built = []
    monkeypatch.setattr(refresh_pipeline, "quant_tables",
                        lambda *a: built.append(1))
    kb = build_knowledge_base(n_trials=30, seed=4)
    s = HermesScheduler(kb, refresh=RefreshConfig(), mc_walkers=64, seed=3,
                        device=dev)
    for i, name in enumerate(sorted(kb)):
        s.on_arrival(f"a{i}", name, now=0.1 * i)
    assert len(s.priorities(1.0)) == len(kb)
    assert built == []
