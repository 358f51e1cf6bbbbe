"""What each rank of the spawned world of ``test_torch_gspmd_families.py``
runs.

Every function here runs inside one rank of a ``launch.procs.spawn`` world
of 4 processes on the CPU (gloo) and imports only the port.  Each check
runs the same collectives on every rank; rank 0 returns the tensors
gathered whole, every rank what only it can see (its block shapes and
bytes, its data shard's decode), and the parent test holds them to the
one-process port and to the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import TrainConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed.sharding import (ShardCtx, gather_block,
                                              shard_params)
from repro_torch.launch.mesh import init_process_mesh, process_submesh
from repro_torch.launch.steps import cache_shardings, make_train_step
from repro_torch.models import moe as X
from repro_torch.models.model import build_model
from repro_torch.testing import tiny_config
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_loop import run_training

AXES = ("data", "model")
# the tiny models of the families, f32, by case name (the architecture,
# then "@" and what the case changes); the first MoE model at
# capacity_factor 1.25, where copies overflow their experts' capacity
FAMILIES = {"qwen2-moe-a2.7b": {"capacity_factor": 1.25},
            "phi3.5-moe-42b-a6.6b": {},
            "mamba2-1.3b": {},
            "jamba-1.5-large-398b": {},
            "whisper-large-v3": {},
            "internvl2-26b": {},
            "whisper-large-v3@fsdp": {}}
# each case's ShardCtx param_sharding: the encoder-decoder and VLM at
# their configs' own (Whisper's "dp" replicates its learned positions;
# once more under "fsdp", which splits them over the data axes), the
# others at "fsdp"
SHARDING = {"whisper-large-v3": "dp"}
MOE = ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b")
TRAIN_SHAPES = ((2, 2), (4, 1), (1, 4))
DECODE_STEPS = 3
DECODE_MAX_SEQ = 16
# the reference's divisibility fallback at a model axis of 4: 6 heads
# (their wq columns split in the middle of a head), a shared-expert width
# of 90, and 2 Mamba heads (d_inner 128 split, the heads whole)
FALLBACKS = {"llama3-8b@6-heads": {"num_heads": 6, "num_kv_heads": 2},
             "qwen2-moe-a2.7b@d_ff_expert-90": {"d_ff_expert": 90},
             "mamba2-1.3b@2-heads": {"ssm_head_dim": 64}}
FALLBACK_MESH = (1, 4)
# the fallback decodes' cache lengths: one the seq axis of 4 divides, and
# one it does not (whole caches, the decode kernel's normal mode)
FALLBACK_MAX_SEQS = (DECODE_MAX_SEQ, 18)
RESTART_STEPS = (2, 3)      # steps of the (2, 2) run, then of the restart
# the EP dispatch on a placed expert share: the first MoE model's weights
EP_NAME = "qwen2-moe-a2.7b"


def arch(name: str) -> str:
    return name.split("@")[0]


def config(name: str):
    over = FAMILIES[name] if name in FAMILIES else FALLBACKS[name]
    return tiny_config(arch(name), dtype="float32", **over)


def shard_ctx(name: str, mesh) -> ShardCtx:
    return ShardCtx(mesh, param_sharding=SHARDING.get(name, "fsdp"))


def cache_len(cfg, max_seq: int = DECODE_MAX_SEQ) -> int:
    """A decode's cache positions: a VLM's caches hold the patches too."""
    return max_seq + (cfg.vision_patches if cfg.family == "vlm" else 0)


def side(cfg, rows: int, seed: int) -> Dict[str, torch.Tensor]:
    """The family's stub frontend input for ``rows`` rows (standard normal
    float32 from ``seed``), as keyword arguments of ``prefill``."""
    g = torch.Generator().manual_seed(seed)
    if cfg.family == "encdec":
        return {"frames": torch.randn((rows, cfg.enc_frames, cfg.d_model),
                                      generator=g)}
    if cfg.family == "vlm":
        return {"patch_embeds": torch.randn(
            (rows, cfg.vision_patches, cfg.d_model), generator=g)}
    return {}


def ep_config():
    return config(EP_NAME).replace(moe_impl="ep")


def train_config(comp: str = "none") -> TrainConfig:
    return TrainConfig(warmup_steps=1, grad_compression=comp)


def data_config() -> DataConfig:
    return DataConfig(vocab_size=256, seq_len=16, global_batch=8, seed=23)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _whole(place, tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every tensor of ``tree`` (this rank's blocks) gathered whole."""
    with torch.no_grad():
        return {n: _np(gather_block(t, place.specs[n], place.mesh))
                for n, t in tree.items()}


class RouteRecorder:
    """Records the sort dispatch's packing of every call while active:
    each call's expert ids (T, k) and whether each copy (in token order)
    was kept."""

    def __init__(self):
        self.calls: List[Dict[str, np.ndarray]] = []
        self._orig = X.pack_copies

    def __enter__(self):
        def recording(idx, E, C):
            order, e_sorted, pos, keep = self._orig(idx, E, C)
            kept = torch.empty_like(keep)
            kept[order] = keep
            self.calls.append({"idx": _np(idx), "keep": _np(kept)})
            return order, e_sorted, pos, keep
        X.pack_copies = recording
        return self

    def __exit__(self, *exc):
        X.pack_copies = self._orig


def placed(name: str, mesh, full: Dict[str, torch.Tensor]):
    cfg = config(name)
    ctx = shard_ctx(name, mesh)
    return build_model(cfg, device="cpu", mesh=ctx,
                       max_seq=DECODE_MAX_SEQ).load_params(
        shard_params(full, ctx, cfg))


def data_shard(mesh, batch: Dict[str, torch.Tensor]):
    """This rank's rows of ``batch`` over the data axis of ``mesh``."""
    nd, i = mesh.shape["data"], mesh.index("data")
    b = next(iter(batch.values())).shape[0] // nd
    return {k: v[i * b:(i + 1) * b] for k, v in batch.items()}


def train_case(name: str, pm, full, batch) -> Dict[str, Any]:
    """One train step of the placed model from ``full``'s weights: the
    loss, the gradients, the global norm and the parameters after it
    (also after an int8-compressed update of the same gradients),
    gathered whole; the specs and shapes of this rank's blocks; for an
    MoE model, the sort dispatch's packing in a forward pass of this
    rank's rows."""
    model = placed(name, pm, full).trainable()
    place = model.placement
    params = model.params()
    out = {"shapes_ok": all(tuple(p.shape) == place.block_shape(n)
                            for n, p in params.items()),
           "bytes": sum(p.numel() * p.element_size()
                        for p in params.values()),
           "specs": {n: tuple(s) for n, s in place.specs.items()}}
    if name in MOE:
        with RouteRecorder() as rec, torch.no_grad():
            model.train_loss(data_shard(pm, batch))
        out["routes"] = rec.calls
    step = make_train_step(model, train_config())
    loss, grads = step.gradients(params, batch)
    out.update(grad_loss=float(loss), grads=_whole(place, grads))
    # the int8-compressed update of the same gradients, on a copy
    copy = {n: p.detach().clone() for n, p in params.items()}
    copy, _, _ = make_train_step(model, train_config("int8")).apply(
        copy, init_opt_state(copy), loss, grads)
    out["params_int8"] = _whole(place, copy)
    params, _, metrics = step.apply(params, init_opt_state(params), loss,
                                    grads)
    out.update(loss=float(metrics["loss"]), params=_whole(place, params),
               grad_norm=float(metrics["grad_norm"]))
    return out


def decode_case(name: str, pm, full, prompt, side_in,
                max_seq: int = DECODE_MAX_SEQ) -> Dict[str, Any]:
    """Prefill this rank's data shard of ``prompt`` (with its rows of the
    stub frontend input ``side_in``) into caches of ``cache_len``
    positions, then ``DECODE_STEPS`` greedy steps: the logits of every
    step, the tokens, the caches gathered whole, and each cache's block
    beside its spec under ``cache_shardings``."""
    model = placed(name, pm, full)
    ctx = model.shard_ctx
    nd = int(np.prod([ctx.mesh.shape[a] for a in ctx.batch_axes]))
    b = prompt.shape[0] // nd
    rows = slice(ctx.data_shard * b, (ctx.data_shard + 1) * b)
    mine = {k: v[rows] for k, v in side_in.items()}
    n = cache_len(model.cfg, max_seq)
    caches, logits = model.prefill(prompt[rows], max_seq=n, **mine)
    S = n - max_seq + prompt.shape[1]
    out, toks = [logits], []
    for t in range(DECODE_STEPS):
        tok = out[-1][:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
        caches, logits = model.decode(caches, tok, S + t)
        out.append(logits)
    full_spec = model.cache_spec(prompt.shape[0], n)
    specs = cache_shardings(ctx, full_spec, seq_axes=ctx.seq_axes)
    shapes = {k: (tuple(c.shape), tuple(specs[k])) for k, c in caches.items()}
    return {"data_shard": ctx.data_shard, "cache_shapes": shapes,
            "seq_split": caches.seq_split,
            "caches": {k: _np(gather_block(c, specs[k], ctx.mesh))
                       for k, c in caches.items()},
            "logits": _np(torch.cat(out, dim=1)),
            "tokens": _np(torch.cat(toks, dim=1))}


def ep_case(pm, full, batch, prompt) -> Dict[str, Any]:
    """The EP model placed over ``pm`` (``expert_share=False``): its
    data shard's prefill logits, and one train step's loss and gradients,
    gathered whole."""
    cfg = ep_config()
    ctx = ShardCtx(pm)
    model = build_model(cfg, device="cpu", mesh=pm,
                        expert_share=False).load_params(
        shard_params(full, pm, cfg, expert_share=False)).trainable()
    place = model.placement
    b = prompt.shape[0] // pm.shape["data"]
    mine = prompt[ctx.data_shard * b:(ctx.data_shard + 1) * b]
    _, logits = model.prefill(mine, max_seq=DECODE_MAX_SEQ)
    loss, grads = make_train_step(model, train_config()).gradients(
        model.params(), batch)
    return {"placed": place is not None, "data_shard": ctx.data_shard,
            "experts": int(model.layers[0].moe.wi.shape[0]),
            "logits": _np(logits), "loss": float(loss),
            "grads": _whole(place, grads)}


def restart_case(name: str, tmp: str, m22, m14) -> Dict[str, Any]:
    """``run_training`` at (2, 2), its state checkpointed, then restarted
    from that checkpoint at (1, 4): the losses of both runs."""
    cfg = config(name)
    tcfg = TrainConfig(warmup_steps=1, checkpoint_every=RESTART_STEPS[0])
    first = run_training(cfg, tcfg, data_config(),
                         total_steps=RESTART_STEPS[0], ckpt_dir=tmp,
                         device="cpu", mesh=shard_ctx(name, m22),
                         verbose=False)
    dist.barrier()
    rep = run_training(cfg, tcfg, data_config(),
                       total_steps=RESTART_STEPS[1], ckpt_dir=tmp,
                       device="cpu", mesh=shard_ctx(name, m14),
                       verbose=False)
    return {"first": first.losses, "losses": rep.losses,
            "restarts": rep.restarts}


def run_world(inp: Dict[str, Any]) -> Dict[str, Any]:
    """Everything one rank runs, family by family."""
    torch.manual_seed(0)
    meshes = {shape: init_process_mesh(shape, AXES, device="cpu")
              for shape in TRAIN_SHAPES}
    # two (1, 2) meshes side by side: ranks {0, 1} and {2, 3}
    pair = process_submesh((1, 2), AXES, [[0, 1], [2, 3]],
                           torch.device("cpu"))
    batch = {k: torch.tensor(v) for k, v in inp["batch"].items()}
    prompt = torch.tensor(inp["prompt"])
    res: Dict[str, Any] = {"rank": dist.get_rank()}
    for name in FAMILIES:
        full = {n: torch.tensor(a) for n, a in inp["params"][name].items()}
        cfg = config(name)
        b = {**batch, **side(cfg, batch["tokens"].shape[0], 11)}
        sd = side(cfg, prompt.shape[0], 12)
        r = res[name] = {"train": {}, "decode": {}}
        for shape, pm in meshes.items():
            r["train"][f"{shape}"] = train_case(name, pm, full, b)
        r["decode"]["(2, 2)"] = decode_case(name, meshes[(2, 2)], full,
                                            prompt, sd)
        r["decode"]["(1, 2)"] = decode_case(name, pair, full, prompt, sd)
        r["restart"] = restart_case(name, f"{inp['tmp']}/{name}",
                                    meshes[(2, 2)], meshes[(1, 4)])
    for name in FALLBACKS:
        full = {n: torch.tensor(a) for n, a in inp["params"][name].items()}
        pm = meshes[FALLBACK_MESH]
        res[name] = {"train": {f"{FALLBACK_MESH}": train_case(name, pm, full,
                                                              batch)},
                     "decode": {n: decode_case(name, pm, full, prompt, {}, n)
                                for n in FALLBACK_MAX_SEQS}}
    res["ep"] = ep_case(meshes[(2, 2)],
                        {n: torch.tensor(a)
                         for n, a in inp["params"][EP_NAME].items()},
                        batch, prompt)
    return res
