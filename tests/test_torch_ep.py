"""The port's expert-parallel MoE (``distributed/ep_moe.py``) against the
JAX package's ``shard_map`` body.

(a) ``_pack_by_key`` equals the reference's bit for bit, ties and overflow
included, row by row of a batch.
(b) ``moe_apply_ep`` at ``(data, model)`` meshes (1, 2), (2, 2) and (1, 4)
against the reference's on as many host devices (one subprocess: the main
process must see one JAX device), float32, within 1e-4, with
``capacity_factor=8.0`` (nothing dropped), padded experts included.
(c) At ``capacity_factor=0.5`` the port equals the reference on every
token but those whose copy sat at slot 0 of an overflowing destination
bin, which the reference's body treats as padding (ROADMAP §3); on every
token the port equals a loop oracle that drops only the overflowing
copies.
(d) Every fallback to the sort path, as the reference's.
(e) The tiny MoE's ``train_loss`` gradients under EP at (2, 2) against
``jax.grad`` of the reference's, within 1e-4 of each tensor's largest
magnitude.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import AbstractMesh

from repro.distributed import ep_moe as J_ep
from repro.distributed.sharding import ShardCtx as JShardCtx
from repro.distributed.sharding import use_shard_ctx as j_use
from repro.models import moe as JX
from repro.testing import tiny_config as j_tiny
from repro_torch.distributed import ep_moe
from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe as X
from repro_torch.models.layers import padded_experts
from repro_torch.models.model import build_model, params_from_jax
from repro_torch.testing import tiny_config

ROOT = Path(__file__).resolve().parent.parent
MESHES = ((1, 2), (2, 2), (1, 4))
# (num_experts, capacity_factor): 16 experts, 12 padded to 16 (rank 1 of
# (1, 2) and ranks 3 of (1, 4) hold padded experts), and overflow
CASES = ((16, 8.0), (12, 8.0), (16, 0.5))

_SUBPROCESS = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed.sharding import ShardCtx, use_shard_ctx
from repro.models import moe as X
from repro.models.model import build_model
from repro.testing import tiny_config
assert jax.device_count() == 4
out = {}

def mesh_of(shape):
    return Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))

for ne, cf in %(cases)r:
    cfg = tiny_config("qwen2-moe-a2.7b", capacity_factor=cf, num_experts=ne,
                      dtype="float32", moe_impl="ep")
    p = jax.tree_util.tree_map(lambda a: a[0], X.moe_params(
        jax.random.PRNGKey(ne), cfg, n=1, dtype=jnp.float32))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
    tag = f"{ne}/{cf}"
    out[tag + "/x"] = np.asarray(x)
    for k, v in p.items():
        out[f"{tag}/p/{k}"] = np.asarray(v)
    for shape in %(meshes)r:
        mesh = mesh_of(shape)
        with use_shard_ctx(ShardCtx(mesh)), mesh:
            y = jax.jit(lambda pp, xx: X.moe_apply(pp, xx, cfg))(p, x)
        out[f"{tag}/{shape}"] = np.asarray(y)

# the tiny MoE's loss and gradients under EP at (2, 2)
cfg = tiny_config("qwen2-moe-a2.7b", dtype="float32", moe_impl="ep",
                  num_experts=12)
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(3))
rng = np.random.default_rng(5)
batch = {"tokens": rng.integers(0, 256, (2, 16)).astype(np.int32),
         "labels": rng.integers(0, 256, (2, 16)).astype(np.int32),
         "loss_mask": (rng.random((2, 16)) < 0.8).astype(np.float32)}
mesh = mesh_of((2, 2))
with use_shard_ctx(ShardCtx(mesh)), mesh:
    loss, grads = jax.jit(jax.value_and_grad(model.train_loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
out["train/loss"] = np.asarray(loss)
for k, v in batch.items():
    out["train/batch/" + k] = v
for which, tree in (("params", params), ("grads", grads)):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(q, "key", q)) for q in path)
        out[f"train/{which}/{key}"] = np.asarray(leaf, np.float32)
np.savez(sys.argv[1], **out)
print("done")
""" % {"cases": CASES, "meshes": MESHES}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ep") / "ref.npz"
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_SUBPROCESS),
                          str(path)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def _layer(ref, ne, cf):
    cfg = tiny_config("qwen2-moe-a2.7b", capacity_factor=cf, num_experts=ne,
                      dtype="float32", moe_impl="ep")
    p = X.MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.as_tensor(ref[f"{ne}/{cf}/p/{name}"]))
    return cfg, p, torch.as_tensor(ref[f"{ne}/{cf}/x"])


def _ep(p, x, cfg, shape):
    with use_shard_ctx(ShardCtx(make_mesh(shape, ("data", "model")))):
        return X.moe_apply(p, x, cfg)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("n_bins,capacity", [(2, 2), (4, 3), (5, 8),
                                             (17, 2)])
def test_pack_by_key_is_the_reference_bit_for_bit(n_bins, capacity):
    rng = np.random.default_rng(n_bins)
    keys = rng.integers(0, n_bins, (3, 40))
    keys[0, :6] = [0, 0, 0, 1, 1, 0]          # the finding's keys
    keys[1] = 0                               # one bin, all overflow
    got = ep_moe._pack_by_key(torch.as_tensor(keys), n_bins, capacity)
    pack = jax.jit(J_ep._pack_by_key, static_argnums=(1, 2))
    for row in range(keys.shape[0]):
        want = pack(jnp.asarray(keys[row], jnp.int32), n_bins, capacity)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[row].numpy(), np.asarray(w))


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("ne", [16, 12])
def test_ep_matches_the_reference_shard_map(ref, ne, shape):
    cfg, p, x = _layer(ref, ne, 8.0)
    y = _ep(p, x, cfg, shape)
    np.testing.assert_allclose(y.numpy(), ref[f"{ne}/8.0/{shape}"], rtol=0,
                               atol=1e-4)
    # nothing dropped: the dense dispatch's result, every expert present
    np.testing.assert_allclose(y.numpy(), X.moe_apply_dense(p, x, cfg)
                               .numpy(), rtol=0, atol=1e-4)


def test_padded_experts_never_receive_a_token(monkeypatch):
    """12 experts padded to 16 on four ranks: rank 3's experts are all
    padding, and no buffer row of a padded expert is written."""
    cfg = tiny_config("qwen2-moe-a2.7b", num_experts=12, dtype="float32",
                      moe_impl="ep", capacity_factor=8.0)
    p = X.MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for t in p.parameters():
            t.normal_(generator=torch.Generator().manual_seed(0))
    seen = []
    experts = X._experts
    monkeypatch.setattr(X, "_experts",
                        lambda q, buf: seen.append(buf.clone())
                        or experts(q, buf))
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    _ep(p, x, cfg, (1, 4))
    (buf,) = seen
    assert buf.shape[0] == padded_experts(12) == 16
    used = buf.abs().sum(dim=(1, 2)) > 0
    assert used[:12].any() and not used[12:].any()


# ---------------------------------------------------------------- (c)

def _oracle(p, x, cfg, shape):
    """A loop over the (data, model) ranks that drops only the copies past
    each capacity, in float64 from the port's routing (the tests above
    hold the routing): each rank's copies fill their destination bins in
    token-then-choice order, each destination fills its experts' rows in
    (source rank, slot) order."""
    nd, n = shape
    E = padded_experts(cfg.num_experts)
    El, k = E // n, cfg.top_k
    B, S, D = x.shape
    Tc = B * S // (nd * n)
    C = max(8, int(np.ceil(Tc * k * cfg.capacity_factor / n / 8)) * 8)
    C2 = max(8, int(np.ceil(n * C * 1.3 / El / 8)) * 8)
    w, idx = X.route(p, x.reshape(-1, D), cfg)
    w, idx = w.double().numpy(), idx.numpy()
    xf = x.reshape(-1, D).double().numpy()
    wi, wg, wo = (getattr(p, a).double().numpy() for a in ("wi", "wg", "wo"))
    y = np.zeros_like(xf)
    for d in range(nd):
        recv = [[] for _ in range(n)]
        for r in range(n):
            fill = [0] * n
            for t in range(Tc):
                tok = (d * n + r) * Tc + t
                for j in range(k):
                    e = int(idx[tok, j])
                    if fill[e // El] < C:
                        recv[e // El].append((tok, e, w[tok, j]))
                    fill[e // El] += 1
        for copies in recv:
            fill2 = [0] * El
            for tok, e, weight in copies:
                if fill2[e % El] < C2:
                    h = xf[tok] @ wg[e]
                    out = (h / (1 + np.exp(-h)) * (xf[tok] @ wi[e])) @ wo[e]
                    y[tok] += weight * out
                fill2[e % El] += 1
    y = torch.as_tensor(y.reshape(B, S, D))
    return y + X.shared_expert(p, x).double()


def _slot0_of_overflowing_bins(p, x, cfg, shape):
    """Tokens whose copy sat at slot 0 of a destination bin that
    overflowed on its rank, and the number of such copies."""
    nd, n = shape
    El = padded_experts(cfg.num_experts) // n
    B, S, D = x.shape
    Tc, k = B * S // (nd * n), cfg.top_k
    C = max(8, int(np.ceil(Tc * k * cfg.capacity_factor / n / 8)) * 8)
    _, idx = X.route(p, x.reshape(-1, D), cfg)
    dest = (idx.numpy() // El).reshape(nd * n, Tc * k)
    hit = []
    for row in range(nd * n):
        for b in range(n):
            copies = np.nonzero(dest[row] == b)[0]
            if len(copies) > C:
                hit.append(row * Tc + int(copies[0]) // k)
    return sorted(set(hit)), len(hit)


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2", "1x4"])
def test_overflow_drops_only_the_overflowing_copies(ref, shape):
    cfg, p, x = _layer(ref, 16, 0.5)
    y = _ep(p, x, cfg, shape).reshape(-1, cfg.d_model).numpy()
    oracle = _oracle(p, x, cfg, shape).reshape(-1, cfg.d_model).numpy()
    want = ref[f"16/0.5/{shape}"].reshape(-1, cfg.d_model)
    np.testing.assert_allclose(y, oracle, rtol=0, atol=1e-4)
    hit, n_copies = _slot0_of_overflowing_bins(p, x, cfg, shape)
    assert hit                             # bins overflow at this factor
    rest = np.setdiff1d(np.arange(y.shape[0]), hit)
    np.testing.assert_allclose(y[rest], want[rest], rtol=0, atol=1e-4)
    # the reference loses the slot-0 copy of each of those tokens
    lost = np.abs(want[hit] - oracle[hit]).max(-1)
    assert (lost > 1e-3).all(), lost
    print(f"mesh {shape}: {n_copies} copies of {len(hit)} of {y.shape[0]} "
          "tokens lost in the reference")


# ---------------------------------------------------------------- (d)

@pytest.mark.parametrize("case", ["no-context", "no-model-axis", "E%n",
                                  "tokens%(n*nd)"])
def test_fallbacks_run_the_sort_path(case, monkeypatch):
    """Where the reference's EP falls back to its sort path, the port's
    runs its own, bit for bit, which equals the reference's sort path."""
    cfg = tiny_config("qwen2-moe-a2.7b", num_experts=16, dtype="float32",
                      moe_impl="ep")
    jcfg = j_tiny("qwen2-moe-a2.7b", num_experts=16, dtype="float32",
                  moe_impl="ep")
    p = X.MoE(cfg, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for t in p.parameters():
            t.normal_(generator=gen).mul_(0.125)
    S = 5 if case == "tokens%(n*nd)" else 16
    x = torch.randn(2, S, cfg.d_model, generator=gen)
    jp = {n: jnp.asarray(t.numpy()) for n, t in p.named_parameters()}
    jx = jnp.asarray(x.numpy())
    want = JX.moe_apply_sort(jp, jx, jcfg)
    mesh = {"no-context": None, "no-model-axis": ((4,), ("data",)),
            "E%n": ((1, 3), ("data", "model")),
            "tokens%(n*nd)": ((1, 4), ("data", "model"))}[case]
    monkeypatch.setattr(JX, "moe_apply_sort", lambda *a: "sort")
    if mesh is None:
        y = X.moe_apply(p, x, cfg)
        assert J_ep.moe_apply_ep(jp, jx, jcfg) == "sort"
    else:
        with use_shard_ctx(ShardCtx(make_mesh(*mesh))):
            y = X.moe_apply(p, x, cfg)
        with j_use(JShardCtx(AbstractMesh(*mesh))):
            assert J_ep.moe_apply_ep(jp, jx, jcfg) == "sort"
    torch.testing.assert_close(y, X.moe_apply_sort(p, x, cfg), rtol=0,
                               atol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_a_batch_the_data_axes_do_not_split_raises():
    cfg = tiny_config("qwen2-moe-a2.7b", num_experts=16, dtype="float32",
                      moe_impl="ep")
    p = X.MoE(cfg, torch.float32, "cpu")
    x = torch.zeros(1, 16, cfg.d_model)
    with use_shard_ctx(ShardCtx(make_mesh((2, 2), ("data", "model")))):
        with pytest.raises(ValueError, match="does not split"):
            X.moe_apply(p, x, cfg)


# ---------------------------------------------------------------- (e)

def test_train_loss_gradients_under_ep_match_jax(ref):
    cfg = tiny_config("qwen2-moe-a2.7b", dtype="float32", moe_impl="ep",
                      num_experts=12)
    tree = {}
    for key, v in ref.items():
        if key.startswith("train/params/"):
            node = tree
            *path, leaf = key[len("train/params/"):].split("/")
            for q in path:
                node = node.setdefault(q, {})
            node[leaf] = v
    pm = build_model(cfg, device="cpu").load_params(params_from_jax(tree))
    batch = {k: ref["train/batch/" + k] for k in ("tokens", "labels",
                                                  "loss_mask")}
    params = pm.trainable().params()
    with use_shard_ctx(ShardCtx(make_mesh((2, 2), ("data", "model")))):
        loss = pm.train_loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    want_loss = float(ref["train/loss"])
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    gtree = {}
    for key, v in ref.items():
        if key.startswith("train/grads/"):
            node = gtree
            *path, leaf = key[len("train/grads/"):].split("/")
            for q in path:
                node = node.setdefault(q, {})
            node[leaf] = v
    want = params_from_jax(gtree)
    assert set(want) == set(params)
    for (name, _), g in zip(params.items(), grads):
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recompute_keeps_the_shard_context(policy):
    """On the card the backward, and with it the recompute of a remat
    period, runs in the autograd engine's own thread, which does not see
    the caller's thread-local context.  Run the backward in another thread
    here: the recompute must take the EP dispatch again (a different
    dispatch saves other tensors, and checkpoint raises), with the
    gradients of a backward in the caller's thread."""
    import threading
    cfg = tiny_config("qwen2-moe-a2.7b", dtype="float32", moe_impl="ep",
                      num_experts=12, remat=True, remat_policy=policy)
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).trainable()
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 256, (2, 16)),
             "labels": rng.integers(0, 256, (2, 16)),
             "loss_mask": np.ones((2, 16), np.float32)}
    params = list(model.params().values())
    grads = []
    for threaded in (False, True):
        with use_shard_ctx(ShardCtx(make_mesh((1, 4), ("data", "model")))):
            loss = model.train_loss(batch)
        out, err = [], []

        def backward():
            try:
                out.append(torch.autograd.grad(loss, params))
            except Exception as e:  # noqa: BLE001  (re-raised below)
                err.append(e)

        if threaded:
            t = threading.Thread(target=backward)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
        else:
            backward()
        if err:
            raise err[0]
        grads.append(out[0])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
