"""The port's training path against the JAX package's on the CPU: the loss
and every gradient of ``Model.train_loss`` for the six model families, the
optimizer's pieces, int8 gradient compression, the synthetic data stream
and a ten-step trajectory of ``make_train_step`` in three arms, from the
same weights (JAX-drawn, carried across with ``params_from_jax``) and the
same batches (``batch_at``).  Then the port's own contracts, as the
reference's ``tests/test_training.py`` states them: the loss decreases, and
a restart after an injected failure is bit-exact.

Tolerances: the loss within 1e-5 relative; each gradient within 1e-4 of
its tensor's largest magnitude (the reference's float32 model tolerance);
the optimizer's pieces within 1e-6 relative, for a tensor of its largest
magnitude (float32 arithmetic in another order; an update can cancel);
compression and data bitwise; trajectory losses within 1e-4 relative at
every step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JaxTrainConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import batch_at as jax_batch_at
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.model import build_model as jax_build_model
from repro.testing import tiny_config as jax_tiny_config
from repro.training import compression as jax_comp
from repro.training import optimizer as jax_opt
from repro_torch.config import TrainConfig
from repro_torch.data.pipeline import DataConfig, batch_at, data_iter
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import (build_model, params_from_jax,
                                      reference_leaf, reference_ndim)
from repro_torch.models.transformer import layer_plan
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.testing import tiny_config
from repro_torch.training import compression as comp
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (run_training,
                                             run_training_with_restarts)

FAMILIES = ["llama3-8b", "qwen2-moe-a2.7b", "mamba2-1.3b",
            "jamba-1.5-large-398b", "whisper-large-v3", "internvl2-26b"]
S, B = 16, 2            # two loss chunks of 8, two SSD chunks of 8
MAX_SEQ = 24            # Whisper's learned positions (tiny)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _models(name, remat=False, **over):
    """The JAX model and weights and the port model holding them
    (``remat`` on the port only: it changes no value of the reference's,
    only its compile time)."""
    jm = jax_build_model(jax_tiny_config(name, dtype="float32", **over))
    max_seq = MAX_SEQ if jm.cfg.family == "encdec" else 0
    jp = jax.jit(jm.init, static_argnames="max_seq")(jax.random.PRNGKey(3),
                                                     max_seq=max_seq)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    pm = build_model(tiny_config(name, dtype="float32", remat=remat, **over),
                     device="cpu", max_seq=max_seq)
    return jm, jp, pm.load_params(params_from_jax(tree))


def _batch(cfg, step=0):
    """A ``batch_at`` batch with the family's side input (numpy)."""
    b = batch_at(DataConfig(vocab_size=256, seq_len=S, global_batch=B),
                 step)
    rng = np.random.default_rng(7 + step)
    if cfg.family == "encdec":
        b["frames"] = rng.normal(size=(B, cfg.enc_frames, cfg.d_model)
                                 ).astype(np.float32)
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.normal(
            size=(B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return b


def _grads(pm, batch):
    pm.trainable()
    params = pm.params()
    loss = pm.train_loss(batch)
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return float(loss.detach()), {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(params.items(), gs)}


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax(name):
    """The six families' loss and gradients, with remat (each period
    under ``torch.utils.checkpoint``) and the loss in two chunks."""
    jm, jp, pm = _models(name, remat=True, loss_chunk=8)
    batch = _batch(pm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(jm.train_loss))(jp, jb)
    loss, grads = _grads(pm, batch)
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    want = params_from_jax(jax.tree_util.tree_map(_np, jg))
    assert set(want) == set(grads)
    for n, g in grads.items():
        w = want[n].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=n)


def test_vlm_loss_covers_the_text_only():
    """The VLM's loss reads no position of the patches: labels and mask
    are the text's, and the patches' gradient reaches the projector only
    through attention."""
    _, _, pm = _models("internvl2-26b")
    batch = _batch(pm.cfg)
    assert batch["labels"].shape == (B, S)
    full = float(pm.train_loss(batch))
    half = dict(batch, loss_mask=batch["loss_mask"] * (np.arange(S) < 8))
    assert float(pm.train_loss(half)) != full


def test_remat_gives_the_same_loss_and_grads():
    _, _, a = _models("jamba-1.5-large-398b", remat=False)
    _, _, b = _models("jamba-1.5-large-398b", remat=True)
    batch = _batch(a.cfg)
    la, ga = _grads(a, batch)
    lb, gb = _grads(b, batch)
    assert la == lb
    for n in ga:
        torch.testing.assert_close(ga[n], gb[n], rtol=0, atol=0)


def test_other_remat_policies_raise():
    """Once item 21's policies were not ported and raised; now each runs,
    with the reference's loss, and an unknown policy name raises."""
    jm, jp, pm = _models("llama3-8b", remat=True)
    batch = _batch(pm.cfg)
    jl = jax.jit(jm.train_loss)(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    for policy in ("dots", "offloadable"):
        pm.cfg = pm.cfg.replace(remat_policy=policy)
        loss, _ = _grads(pm, batch)
        assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    pm.cfg = pm.cfg.replace(remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        pm.train_loss(batch)


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "mamba2-1.3b"])
@pytest.mark.parametrize("policy", ["dots", "offloadable"])
def test_remat_policies_keep_the_full_gradients(name, policy):
    """A policy changes what the backward keeps, not what it computes: the
    loss and every gradient equal ``"full"``'s bit for bit (MoE scatters
    and Mamba scans included)."""
    _, _, full = _models(name, remat=True)
    _, _, pm = _models(name, remat=True, remat_policy=policy)
    batch = _batch(full.cfg)
    la, ga = _grads(full, batch)
    lb, gb = _grads(pm, batch)
    assert la == lb
    for n in ga:
        torch.testing.assert_close(gb[n], ga[n], rtol=0, atol=0)


def test_trainable_leaves_prefill_as_it_was():
    _, _, pm = _models("llama3-8b")
    tok = torch.as_tensor(_batch(pm.cfg)["tokens"]).long()
    _, before = pm.prefill(tok)
    _, after = pm.trainable().prefill(tok)
    assert all(p.requires_grad for p in pm.parameters())
    assert not after.requires_grad
    torch.testing.assert_close(before, after, rtol=0, atol=0)


# ------------------------------------------------------------- optimizer
def _trees(seed=0):
    """The tiny Llama's weights as a JAX tree and port tensors, and random
    gradients of the same leaves (norm scales zero, so only the decay
    moves them)."""
    jm = jax_build_model(jax_tiny_config("llama3-8b", dtype="float32"))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(seed)
    jg = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.01).astype(np.float32), jp)
    for sub in [jg["layers"]["sub0"]["mixer_norm"],
                jg["layers"]["sub0"]["ffn_norm"], jg["final_norm"]]:
        sub["scale"] = np.zeros_like(sub["scale"])
    return jp, jg


def _close(port, want, rtol=1e-6):
    """Each tensor within ``rtol`` of its largest magnitude (an update
    ``p - lr * delta`` can cancel to far below ``p``)."""
    want = params_from_jax(jax.tree_util.tree_map(_np, want))
    for n, t in port.items():
        w = want[n].numpy()
        np.testing.assert_allclose(t.float().numpy(), w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()),
                                   err_msg=n)


@pytest.mark.parametrize("step", [0, 3, 99, 100, 5000, 20000])
def test_lr_schedule_matches_jax(step):
    kw = dict(learning_rate=3e-4, warmup_steps=100)
    want = float(jax_opt.lr_schedule(JaxTrainConfig(**kw),
                                     jnp.asarray(step, jnp.int32)))
    got = float(opt.lr_schedule(TrainConfig(**kw),
                                torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("max_norm", [1e-3, 1e3])     # clips, or not
def test_global_norm_and_clip_match_jax(max_norm):
    _, jg = _trees()
    g = params_from_jax(jg)
    assert float(opt.global_norm(g)) == pytest.approx(
        float(jax_opt.global_norm(jg)), rel=1e-6)
    clipped, gn = opt.clip_by_global_norm(g, max_norm)
    jclipped, jgn = jax_opt.clip_by_global_norm(jg, max_norm)
    assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
    _close(clipped, jclipped)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(state_dtype):
    jp, jg = _trees()
    tcfg = dict(learning_rate=1e-2, warmup_steps=2, weight_decay=0.5)
    jstate = jax_opt.init_opt_state(jp, state_dtype)
    params = params_from_jax(jp)
    state = opt.init_opt_state(params, state_dtype)
    assert state.m["embed"].dtype == getattr(torch, state_dtype)
    for k in range(2):              # the second step reads the moments
        grads = params_from_jax(jax.tree_util.tree_map(
            lambda a: a * (1 + k), jg))
        jp, jstate, jm = jax_opt.adamw_update(
            jax.tree_util.tree_map(lambda a: a * (1 + k), jg), jstate, jp,
            JaxTrainConfig(**tcfg))
        params, state, m = opt.adamw_update(grads, state, params,
                                            TrainConfig(**tcfg))
        assert int(state.step) == int(jstate.step) == k + 1
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        _close(params, jp)
        tol = 1e-6 if state_dtype == "float32" else 8e-3   # one bf16 ulp
        _close(state.m, jstate.m, tol)
        _close(state.v, jstate.v, tol)


def test_stacked_norm_scales_are_decayed():
    """The reference stacks a layer's norm scale over the periods, so it
    is a 2-D leaf and decayed; ``final_norm`` is 1-D and not.  A zero
    gradient leaves only the decay: scale * (1 - lr * wd)."""
    jp, jg = _trees()
    tcfg = dict(learning_rate=1e-2, warmup_steps=0, weight_decay=0.5)
    params = params_from_jax(jp)
    assert reference_ndim("layers.1.mixer_norm.scale",
                          params["layers.1.mixer_norm.scale"]) == 2
    assert reference_ndim("final_norm.scale", params["final_norm.scale"]) == 1
    params, _, m = opt.adamw_update(params_from_jax(jg),
                                    opt.init_opt_state(params), params,
                                    TrainConfig(**tcfg))
    jnew, _, _ = jax_opt.adamw_update(jg, jax_opt.init_opt_state(jp), jp,
                                      JaxTrainConfig(**tcfg))
    decayed = 1.0 - float(m["lr"]) * 0.5
    for n in ("layers.0.mixer_norm.scale", "layers.1.ffn_norm.scale"):
        np.testing.assert_allclose(params[n].numpy(), decayed, rtol=1e-6)
    np.testing.assert_array_equal(params["final_norm.scale"].numpy(), 1.0)
    _close(params, jnew)


# ----------------------------------------------------------- compression
def _grad_tree(name, seed):
    jm = jax_build_model(jax_tiny_config(name, dtype="float32"))
    max_seq = MAX_SEQ if jm.cfg.family == "encdec" else 0
    jp = jm.init_abstract(max_seq=max_seq)
    rng = np.random.default_rng(seed)
    return jm.cfg, jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape) * 10.0 ** rng.integers(
            -4, 1), jnp.float32), jp)


def _bitwise(port, want):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    assert set(port) == set(want)
    for n, t in port.items():
        np.testing.assert_array_equal(t.numpy(), want[n].numpy(), err_msg=n)


@pytest.mark.parametrize("name", ["llama3-8b", "jamba-1.5-large-398b",
                                  "whisper-large-v3"])
def test_compression_matches_jax_bitwise(name):
    """One scale per reference leaf (the jamba plan's period of 8 groups
    layers j and j + 8), round half to even, and the error-feedback
    residual carried over two steps: the reference's functions as called
    (eagerly; inside ``jit`` XLA multiplies by 1/127 where they divide by
    127, which can move the scale by an ulp)."""
    cfg, jg = _grad_tree(name, 0)
    period = len(layer_plan(cfg))
    g = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    _bitwise(comp.compress_decompress(g, period),
             jax_comp.compress_decompress(jg))
    jres = jax_comp.init_residual(jg)
    res = comp.init_residual(g)
    _bitwise(res, jres)
    for seed in (1, 2):
        _, jg = _grad_tree(name, seed)
        g = params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
        jout, jres = jax_comp.compress_with_feedback(jg, jres)
        out, res = comp.compress_with_feedback(g, res, period)
        _bitwise(out, jout)
        _bitwise(res, jres)


def test_reference_leaf_groups_the_periods():
    assert reference_leaf("layers.9.attn.wq", 8) == "layers.sub1.attn.wq"
    assert reference_leaf("layers.1.attn.wq", 8) == "layers.sub1.attn.wq"
    assert reference_leaf("encoder.3.mlp.wi", 1) == "encoder.sub0.mlp.wi"
    assert reference_leaf("final_norm.scale", 8) == "final_norm.scale"


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("step, rank, world", [(0, 0, 1), (7, 0, 2),
                                               (7, 1, 2), (123, 3, 4)])
def test_batch_at_matches_jax_bitwise(step, rank, world):
    kw = dict(vocab_size=256, seq_len=33, global_batch=8, seed=11)
    want = jax_batch_at(JaxDataConfig(**kw), step, rank=rank, world=world)
    got = batch_at(DataConfig(**kw), step, rank=rank, world=world)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    it = data_iter(DataConfig(**kw), step, rank=rank, world=world)
    np.testing.assert_array_equal(next(it)["tokens"], want["tokens"])


# ---------------------------------------------------------- trajectory
TRAJ_CFG = dict(num_layers=2, d_model=32, d_ff=64, dtype="float32")
TRAJ_DATA = dict(vocab_size=256, seq_len=32, global_batch=4)


@pytest.mark.parametrize("arm", [dict(), dict(microbatch=2),
                                 dict(grad_compression="int8")],
                         ids=["plain", "microbatch2", "int8"])
def test_ten_step_trajectory_matches_jax(arm):
    kw = dict(learning_rate=1e-3, warmup_steps=5, **arm)
    jm = jax_build_model(jax_tiny_config("llama3-8b", **TRAJ_CFG))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build_model(tiny_config("llama3-8b", **TRAJ_CFG), device="cpu")
    pm.load_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))
    params = pm.trainable().params()
    jstate = jax_opt.init_opt_state(jp)
    state = opt.init_opt_state(params)
    jstep = jax.jit(jax_make_train_step(jm, JaxTrainConfig(**kw)))
    step = make_train_step(pm, TrainConfig(**kw))
    for k in range(10):
        batch = batch_at(DataConfig(**TRAJ_DATA), k)
        jp, jstate, jmet = jstep(jp, jstate,
                                 {n: jnp.asarray(v) for n, v in batch.items()})
        params, state, met = step(params, state, batch)
        assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                                   rel=1e-4), k


def test_train_step_needs_trainable_weights():
    pm = build_model(tiny_config("llama3-8b", **TRAJ_CFG),
                     device="cpu").init(torch.Generator().manual_seed(0))
    step = make_train_step(pm, TrainConfig())
    with pytest.raises(ValueError, match="trainable"):
        step(pm.params(), opt.init_opt_state(pm.params()),
             batch_at(DataConfig(**TRAJ_DATA), 0))


# ------------------------------------------------- the port's contracts
CFG = tiny_config("llama3-8b", num_layers=2, d_model=32, d_ff=64)
DCFG = DataConfig(**TRAJ_DATA)
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=5, checkpoint_every=10)


def test_loss_decreases():
    rep = run_training(CFG, TCFG, DCFG, total_steps=40, verbose=False,
                       device="cpu")
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5])
    assert len(rep.step_s) == rep.steps_run == 40


def test_restart_bit_exact(tmp_path):
    rep_a = run_training(CFG, TCFG, DCFG, total_steps=35,
                         ckpt_dir=str(tmp_path / "a"), verbose=False,
                         device="cpu")
    inj = FailureInjector(fail_at_step=17)
    rep_b = run_training_with_restarts(CFG, TCFG, DCFG, total_steps=35,
                                       ckpt_dir=str(tmp_path / "b"),
                                       injector=inj, verbose=False,
                                       device="cpu")
    assert rep_b.restarts == 1
    # steps 0-16, then 10-34 after restoring the step-9 checkpoint
    assert rep_b.steps_run == 17 + 25
    assert rep_a.losses[-25:] == rep_b.losses[-25:]


def test_a_failure_waits_for_the_save_in_flight(tmp_path, monkeypatch):
    """A failure soon after an async save waits for it: the restart
    restores it instead of starting over."""
    import time
    from repro_torch.checkpoint import checkpointing as ck
    save = ck.save_checkpoint

    def slow(*a, **kw):
        time.sleep(0.5)
        return save(*a, **kw)

    monkeypatch.setattr(ck, "save_checkpoint", slow)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5,
                       checkpoint_every=2)
    rep = run_training_with_restarts(CFG, tcfg, DCFG, total_steps=4,
                                     ckpt_dir=str(tmp_path),
                                     injector=FailureInjector(3),
                                     verbose=False, device="cpu")
    assert rep.restarts == 1 and rep.steps_run == 3 + 2


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    assert train.main(["--device", "cpu", "--tiny", "--steps", "3",
                       "--seq", "16", "--batch", "2",
                       "--ckpt", str(tmp_path)]) == 0
    assert "[train] done: 3 steps" in capsys.readouterr().out
