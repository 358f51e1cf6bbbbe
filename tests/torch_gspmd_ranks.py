"""What each rank of the spawned world of ``test_torch_gspmd.py`` runs.

Every function here runs inside one rank of a ``launch.procs.spawn`` world
of 4 processes on the CPU (gloo) and imports only the port.  Each check
runs the same collectives on every rank; rank 0 returns the tensors
gathered whole (the others return what only they can see: their block
shapes), and the parent test holds them to the one-process port and to
the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointing import (restore_checkpoint,
                                                  save_checkpoint)
from repro_torch.config import TrainConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed.sharding import (P, ShardCtx, gather_block,
                                              gather_whole, local_block,
                                              shard_params)
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch.mesh import init_process_mesh, process_submesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.testing import tiny_config
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_loop import run_training

AXES = ("data", "model")
TRAIN_SHAPES = ((2, 2), (4, 1), (1, 4))
TRAIN_CASES = tuple((mb, comp) for mb in (1, 2) for comp in ("none", "int8"))
DECODE_STEPS = 4
DECODE_MAX_SEQ = 16
# the dense family's qk_norm and qkv_bias configurations, and their meshes
VARIANTS = ("qwen3-4b", "qwen2-7b")
VARIANT_SHAPES = ((2, 2), (1, 4))
VARIANT_SEED = 9
# the other families placed over (2, 2), drawn by the placed init
FAMILY_DECODES = ("mamba2-1.3b", "jamba-1.5-large-398b", "whisper-large-v3",
                  "internvl2-26b")
SIDE_SEED = 13


def family_side(cfg, rows: int) -> Dict[str, torch.Tensor]:
    """The stub frontend input of ``rows`` prompt rows (standard normal
    float32 from ``SIDE_SEED``): frames for the encoder-decoder, patch
    embeddings for the VLM, as keyword arguments of ``prefill``."""
    g = torch.Generator().manual_seed(SIDE_SEED)
    if cfg.family == "encdec":
        return {"frames": torch.randn((rows, cfg.enc_frames, cfg.d_model),
                                      generator=g)}
    if cfg.family == "vlm":
        return {"patch_embeds": torch.randn(
            (rows, cfg.vision_patches, cfg.d_model), generator=g)}
    return {}


def family_cache_len(cfg) -> int:
    """A family decode's cache positions (a VLM's hold its patches too)."""
    return DECODE_MAX_SEQ + (cfg.vision_patches if cfg.family == "vlm"
                             else 0)


def config():
    return tiny_config("llama3-8b", dtype="float32")


def train_config(n_mb: int, comp: str) -> TrainConfig:
    return TrainConfig(warmup_steps=1, microbatch=n_mb, grad_compression=comp)


def data_config() -> DataConfig:
    return DataConfig(vocab_size=256, seq_len=16, global_batch=8, seed=21)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _whole(place, tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every tensor of ``tree`` (this rank's blocks) gathered whole."""
    with torch.no_grad():
        return {n: _np(gather_block(t, place.specs[n], place.mesh))
                for n, t in tree.items()}


def _placed(mesh, full):
    cfg = config()
    return build_model(cfg, device="cpu", mesh=mesh).load_params(
        shard_params(full, mesh, cfg))


def train_case(pm, full, batch, n_mb, comp) -> Dict[str, Any]:
    """One train step of the placed model from ``full``'s weights: the
    loss, the gradients, the parameters and moments after it, gathered
    whole; and whether every tensor this rank holds has its block's
    shape."""
    model = _placed(pm, full).trainable()
    place = model.placement
    params = model.params()
    shapes = all(tuple(p.shape) == place.block_shape(n)
                 for n, p in params.items())
    step = make_train_step(model, train_config(n_mb, comp))
    reset_launches()
    g_loss, grads = step.gradients(params, batch)
    out = {"shapes_ok": shapes, "launches": dict(LAUNCHES),
           "bytes": sum(p.numel() * p.element_size()
                        for p in params.values()),
           "grads": _whole(place, grads), "grad_loss": float(g_loss)}
    state = init_opt_state(params)
    params, state, metrics = step(params, state, batch)
    out.update(loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]),
               params=_whole(place, params), m=_whole(place, state.m),
               v=_whole(place, state.v))
    return out


def variant_case(pm, name, batch) -> Dict[str, Any]:
    """A tiny ``name`` placed over ``pm`` with its weights drawn by
    ``init`` (each drawn whole, the block kept): its gradients and the
    parameters after one step, gathered whole."""
    cfg = tiny_config(name, dtype="float32")
    model = build_model(cfg, device="cpu", mesh=pm).init(
        torch.Generator().manual_seed(VARIANT_SEED)).trainable()
    place = model.placement
    step = make_train_step(model, train_config(1, "none"))
    params = model.params()
    loss, grads = step.gradients(params, batch)
    params, _, _ = step.apply(params, init_opt_state(params), loss, grads)
    return {"loss": float(loss), "grads": _whole(place, grads),
            "params": _whole(place, params)}


def decode_case(pm, full, prompt, steps=DECODE_STEPS,
                max_seq=DECODE_MAX_SEQ) -> Dict[str, Any]:
    """Prefill this rank's data shard of ``prompt`` into caches of
    ``max_seq`` positions (a batch the data axes do not split: all of it,
    replicated), then ``steps`` greedy decode steps: the logits of every
    step and the tokens."""
    model = _placed(pm, full)
    ctx = model.shard_ctx
    nd = int(np.prod([ctx.mesh.shape[a] for a in ctx.batch_axes]))
    if prompt.shape[0] % nd:
        nd, shard = 1, 0
    else:
        shard = ctx.data_shard
    b = prompt.shape[0] // nd
    mine = prompt[shard * b:(shard + 1) * b]
    S = mine.shape[1]
    caches, logits = model.prefill(mine, max_seq=max_seq)
    out, toks = [logits], []
    for t in range(steps):
        tok = out[-1][:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
        caches, logits = model.decode(caches, tok, S + t)
        out.append(logits)
    return {"data_shard": shard,
            "cache_positions": int(caches["k"].shape[3]),
            "logits": _np(torch.cat(out, dim=1)),
            "tokens": _np(torch.cat(toks, dim=1))}


def family_decode_case(pm, name, prompt) -> Dict[str, Any]:
    """A tiny ``name`` placed over ``pm``, its weights drawn by ``init``
    (each drawn whole, the block kept): this rank's data shard of
    ``prompt`` prefilled, then greedy steps; the logits and tokens."""
    cfg = tiny_config(name, dtype="float32")
    model = build_model(cfg, device="cpu", mesh=pm,
                        max_seq=DECODE_MAX_SEQ).init(
        torch.Generator().manual_seed(VARIANT_SEED))
    ctx = model.shard_ctx
    b = prompt.shape[0] // pm.shape["data"]
    rows = slice(ctx.data_shard * b, (ctx.data_shard + 1) * b)
    mine = prompt[rows]
    side = {k: v[rows] for k, v in family_side(cfg, prompt.shape[0]).items()}
    n = family_cache_len(cfg)
    caches, logits = model.prefill(mine, max_seq=n, **side)
    S = mine.shape[1] + n - DECODE_MAX_SEQ
    out, toks = [logits], []
    for t in range(DECODE_STEPS):
        tok = out[-1][:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
        caches, logits = model.decode(caches, tok, S + t)
        out.append(logits)
    return {"data_shard": ctx.data_shard,
            "logits": _np(torch.cat(out, dim=1)),
            "tokens": _np(torch.cat(toks, dim=1))}


def seq_attention_case(pm, ref_in) -> np.ndarray:
    """The reference test's decode-attention inputs with the cache's
    positions split over the model axis: this rank's slice of the caches
    (the port's (B, K, S, hd) layout)."""
    ctx = ShardCtx(pm)
    q = torch.tensor(ref_in["q"])
    n, r = pm.shape["model"], pm.index("model")
    Sl = ref_in["kc"].shape[1] // n
    sl = slice(r * Sl, (r + 1) * Sl)
    kc = torch.tensor(ref_in["kc"][:, sl]).transpose(1, 2)
    vc = torch.tensor(ref_in["vc"][:, sl]).transpose(1, 2)
    return _np(L.seq_decode_attention(q, kc, vc, int(ref_in["pos"]), ctx))


def checkpoint_case(tmp: str, arr: np.ndarray, ref_dir: str,
                    ref_tree: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The reference test's elastic restore: ``arr`` saved from (4, 1)
    under ``P("data", None)`` and restored onto (2, 2) under ``P(None,
    "model")``; then a checkpoint the JAX package wrote (``ref_dir``)
    restored onto (2, 2) with every leaf split."""
    full = torch.tensor(arr)
    m41 = init_process_mesh((4, 1), AXES, device="cpu")
    src = P("data", None)
    save_checkpoint(tmp, 0, {"w": local_block(full, src, m41)}, {"step": 0},
                    mesh=m41, shardings={"w": src})
    m22 = init_process_mesh((2, 2), AXES, device="cpu")
    dst = P(None, "model")
    want = local_block(full, dst, m22)
    got, extra = restore_checkpoint(tmp, {"w": torch.empty_like(want)},
                                    shardings={"w": dst}, mesh=m22)
    out = {"elastic_block": bool(torch.equal(got["w"], want)),
           "elastic_step": extra["step"],
           "elastic_whole": _np(gather_block(got["w"], dst, m22))}
    # gather_whole (a save's gather): the whole tensor on rank 0 only,
    # from blocks over one axis, both axes of a dim, or none
    whole = {}
    for spec in (P("data", "model"), P(("data", "model"), None),
                 P(None, ("model", "data")), P()):
        for t in (full, full.to(torch.bfloat16)):
            w = gather_whole(local_block(t, spec, m22), spec, m22)
            whole[f"{spec}/{t.dtype}"] = (torch.equal(w, t) if m22.rank == 0
                                          else w is None)
    out["gather_whole"] = whole
    specs = {"w": P("data", "model"), "b16": P("model", None)}
    target = {n: torch.empty(local_block(torch.tensor(a), specs[n],
                                         m22).shape,
                             dtype=torch.bfloat16 if n == "b16"
                             else torch.float32)
              for n, a in ref_tree.items()}
    got, _ = restore_checkpoint(ref_dir, target, shardings=specs, mesh=m22)
    out["reference_blocks"] = all(
        torch.equal(got[n].float(), local_block(torch.tensor(a), specs[n],
                                                m22))
        for n, a in ref_tree.items())
    return out


def restart_case(tmp: str) -> Dict[str, Any]:
    """``run_training`` at (2, 2) for 4 steps (checkpoints every 2), then
    restarted from its checkpoint at (1, 4) and at (4, 1) to step 6: the
    losses of every run."""
    cfg = config()
    tcfg = TrainConfig(warmup_steps=1, checkpoint_every=2)
    dcfg = data_config()
    out = {}
    m22 = init_process_mesh((2, 2), AXES, device="cpu")
    first = run_training(cfg, tcfg, dcfg, total_steps=4, ckpt_dir=tmp,
                         device="cpu", mesh=m22, verbose=False)
    out["first"] = first.losses
    for shape in ((1, 4), (4, 1)):
        # each restart begins from the (2, 2) run's last checkpoint
        mesh = init_process_mesh(shape, AXES, device="cpu")
        d = f"{tmp}_{shape[0]}x{shape[1]}"
        if mesh.rank == 0:
            import shutil
            shutil.copytree(tmp, d)
        dist.barrier()
        rep = run_training(cfg, tcfg, dcfg, total_steps=6, ckpt_dir=d,
                           device="cpu", mesh=mesh, verbose=False)
        out[f"{shape}"] = {"losses": rep.losses, "restarts": rep.restarts}
    return out


def run_world(inp: Dict[str, Any]) -> Dict[str, Any]:
    """Everything one rank runs; rank 0 returns the gathered results."""
    torch.manual_seed(0)
    full = {n: torch.tensor(a) for n, a in inp["params"].items()}
    batch = {k: torch.tensor(v) for k, v in inp["batch"].items()}
    res: Dict[str, Any] = {"train": {}, "decode": {}}
    for shape in TRAIN_SHAPES:
        pm = init_process_mesh(shape, AXES, device="cpu")
        for n_mb, comp in TRAIN_CASES:
            res["train"][f"{shape}/{n_mb}/{comp}"] = train_case(
                pm, full, batch, n_mb, comp)
        if shape == (1, 4):
            res["seq_attention"] = seq_attention_case(pm, inp["seq_ref"])
        if shape == (2, 2):
            res["decode"]["(2, 2)"] = decode_case(pm, full,
                                                  torch.tensor(inp["prompt"]))
            res["families"] = {
                name: family_decode_case(pm, name,
                                         torch.tensor(inp["prompt"]))
                for name in FAMILY_DECODES}
        if shape in VARIANT_SHAPES:
            for name in VARIANTS:
                res.setdefault("variants", {})[f"{name}/{shape}"] = \
                    variant_case(pm, name, batch)
    # two (1, 2) meshes side by side: ranks {0, 1} and {2, 3}
    pair = process_submesh((1, 2), AXES, [[0, 1], [2, 3]],
                           torch.device("cpu"))
    res["decode"]["(1, 2)"] = decode_case(pair, full,
                                          torch.tensor(inp["prompt"]))
    # the reference's batch-1 cell with a pod axis: the positions split
    # over the flattened (pod, model) axes
    pods = init_process_mesh((2, 1, 2), ("pod",) + AXES, device="cpu")
    res["decode"]["(2, 1, 2) pod"] = decode_case(
        ShardCtx(pods, seq_axes=("pod", "model")), full,
        torch.tensor(inp["prompt"][:1]))
    res["checkpoint"] = checkpoint_case(inp["tmp"] + "/elastic", inp["arr"],
                                        inp["ref_ckpt"], inp["ref_tree"])
    res["restart"] = restart_case(inp["tmp"] + "/restart")
    res["rank"] = dist.get_rank()
    return res
