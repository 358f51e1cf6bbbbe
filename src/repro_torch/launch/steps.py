"""Step-function factories shared by the dry run, the trainer and the
server, and the sharding specs of their inputs and outputs.

The port of the JAX package's ``launch/steps.py`` over the port's model
API.  A train step takes a parameter set (``Model.params()`` of a
``Model.trainable()`` model: the model's own tensors), an ``AdamState``
and a batch dict (arrays or tensors), and updates the parameters and the
moments in place (``training.optimizer.adamw_update``).  The sharding
trees are specs (``distributed.sharding.P``) over a ``ShardCtx``'s mesh,
by name as the inputs: the dry run's per-device accounting reads them
(``launch/dryrun.py``); on one device nothing is placed by them.

A model placed over a process mesh (``build_model(cfg, mesh=)``) takes
the same call with this rank's blocks as ``params`` and ``opt_state``
and the global batch: the step splits it into microbatches first, then
keeps this rank's data-shard rows of each (``batch_shardings``), so each
microbatch pairs the rows the one-process step pairs.  Each rank's
gradients are then its blocks' share of the global gradient (the FSDP
gathers sum the data shards' in their backward), the replicated
parameters' summed over the data axes here; the metrics are global.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config import ShapeConfig, TrainConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (P, ShardCtx, _axis_size,
                                              block_index, block_shape,
                                              cache_shardings,
                                              named_shardings)
from repro_torch.models import transformer as T
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import Model
from repro_torch.training.compression import compress_decompress
from repro_torch.training.optimizer import AdamState, adamw_update

Params = Dict[str, torch.Tensor]


def make_train_step(model: Model, tcfg: TrainConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and gradients of the batch (accumulated over
    ``max(tcfg.microbatch or cfg.microbatch, 1)`` slices of its rows in
    float32, then divided by their count), int8-compressed when
    ``tcfg.grad_compression == "int8"``, then one AdamW update.  Metrics:
    ``loss``, ``grad_norm``, ``lr`` (0-d tensors).  Its halves are
    ``train_step.gradients(params, batch) -> (loss, grads)`` (before
    compression; a placed model's blocks of the global gradient) and
    ``train_step.apply(params, opt_state, loss, grads)``, the rest."""
    cfg = model.cfg
    n_mb = max(tcfg.microbatch or cfg.microbatch, 1)
    period = len(T.layer_plan(cfg))
    place = model.placement
    ctx = model.shard_ctx
    if place is None:
        model._in_context()     # raises for an unplaced model there

    def grad_fn(params: Params, batch: Dict[str, Any]):
        names = list(params)
        loss = model.train_loss(batch, params)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        # a weight the loss does not read (the cross-attention's bq) has
        # a zero gradient, as in the reference
        return loss.detach(), {n: torch.zeros_like(params[n]) if g is None
                               else g for n, g in zip(names, grads)}

    def gradients(params: Params, batch: Dict[str, Any]):
        not_trainable = [n for n, p in params.items() if not p.requires_grad]
        if not_trainable:
            raise ValueError(f"parameters {not_trainable[:3]} take no "
                             "gradient: call Model.trainable() first")
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        if n_mb > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % n_mb:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{n_mb} microbatches")
            per = rows // n_mb
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            for i in range(n_mb):
                mb = _data_shard({k: v[i * per:(i + 1) * per]
                                  for k, v in batch.items()})
                mb_loss, g = grad_fn(params, mb)
                for n, a in grads.items():
                    a += g[n].float()
                loss = loss + mb_loss
                del g
            loss = loss / n_mb
            for a in grads.values():
                a.div_(n_mb)
        else:
            loss, grads = grad_fn(params, _data_shard(batch))
        if place is not None:
            axes = ctx.batch_axes
            loss = C.all_reduce_over(loss, ctx.mesh, axes)
            grads = {n: C.all_reduce_over(g, ctx.mesh, [
                a for a in axes if a in place.replicated_axes(n)])
                for n, g in grads.items()}
        return loss, grads

    def apply(params: Params, opt_state: AdamState, loss: torch.Tensor,
              grads: Params):
        if tcfg.grad_compression == "int8":
            grads = compress_decompress(grads, period, place)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  tcfg, place)
        metrics["loss"] = loss
        return params, opt_state, metrics

    def train_step(params: Params, opt_state: AdamState,
                   batch: Dict[str, Any]):
        return apply(params, opt_state, *gradients(params, batch))

    def _data_shard(batch):
        """A placed model's rows of a (micro)batch: its data shard."""
        if place is None:
            return batch
        out = {}
        for k, spec in batch_shardings(ctx, batch).items():
            i, n = block_index(spec[0], ctx.mesh)
            rows = batch[k].shape[0]
            if n == 1 and _axis_size(ctx, ctx.logical("batch")) > 1:
                raise ValueError(f"{k}: {rows} rows do not split over the "
                                 f"data axes {ctx.batch_axes}")
            out[k] = batch[k][i * rows // n:(i + 1) * rows // n]
        return out

    train_step.gradients = gradients
    train_step.apply = apply
    return train_step


def make_prefill_step(model: Model):
    """``prefill_step(params, batch) -> (caches, last-position logits)``;
    ``batch`` holds ``tokens`` and the family's ``frames`` or
    ``patch_embeds``."""
    def prefill_step(params: Optional[Params], batch: Dict[str, Any]):
        side = {k: torch.as_tensor(v) for k, v in batch.items()
                if k in ("frames", "patch_embeds")}
        return model.prefill(torch.as_tensor(batch["tokens"]).long(),
                             params, **side)
    return prefill_step


def make_serve_step(model: Model):
    """One decode step: greedy next token (B, 1) int32 and the caches
    (updated in place)."""
    def serve_step(params: Optional[Params], caches, token, pos):
        caches, logits = model.decode(caches, torch.as_tensor(token).long(),
                                      int(pos), params)
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(
            torch.int32)[:, None]
        return caches, next_token
    return serve_step


# ----------------------------------------------------------------- shardings
def batch_shardings(ctx: ShardCtx, batch_spec: Dict[str, Any]
                    ) -> Dict[str, P]:
    """Batch dim -> (pod, data); everything else replicated."""
    b = ctx.logical("batch")
    out = {}
    for name, leaf in batch_spec.items():
        spec = [b] + [None] * (leaf.dim() - 1)
        if leaf.shape[0] % _axis_size(ctx, b) != 0:
            spec[0] = None
        out[name] = P(*spec)
    return out


def opt_state_shardings(ctx: ShardCtx, params_spec: Dict[str, Any],
                        period: int) -> AdamState:
    ps = named_shardings(ctx, params_spec, period)
    return AdamState(step=P(), m=ps, v=ps)


def abstract_opt_state(params_spec: Dict[str, Any], state_dtype: str
                       ) -> AdamState:
    """The optimizer state of ``params_spec`` on the ``meta`` device."""
    dt = torch_dtype(state_dtype)
    meta = torch.device("meta")
    z = lambda p: torch.empty(p.shape, dtype=dt, device=meta)  # noqa: E731
    return AdamState(step=torch.empty((), dtype=torch.int32, device=meta),
                     m={n: z(p) for n, p in params_spec.items()},
                     v={n: z(p) for n, p in params_spec.items()})


def cell_max_seq(cfg, shape: ShapeConfig) -> int:
    """The learned position table's rows of a cell's model (a model
    without RoPE: the cell's length and 8 more), 0 for the others."""
    return shape.seq_len + 8 if cfg.rope_theta <= 0 else 0


def decode_seq_axes(shape: ShapeConfig, axis_names):
    """The axes a decode cell's cache positions split over: ``("pod",
    "model")`` for the batch-1 cell of a mesh with a pod axis (the batch
    cannot use it), ``None`` (the model axis) otherwise."""
    if shape.kind == "decode" and shape.global_batch == 1 \
            and "pod" in axis_names:
        return tuple(a for a in ("pod", "model") if a in axis_names)
    return None


def _rows(batch: Dict[str, torch.Tensor], specs: Dict[str, P], mesh
          ) -> Dict[str, torch.Tensor]:
    """This rank's block of each ``meta`` input under its spec."""
    return {k: torch.empty(block_shape(v.shape, specs[k], mesh),
                           dtype=v.dtype, device=v.device)
            for k, v in batch.items()}


def cell_functions(model: Model, shape: ShapeConfig, ctx: ShardCtx,
                   tcfg: Optional[TrainConfig] = None):
    """``(fn, abstract args, in specs, out specs)`` for one cell: the step
    function of the cell's kind, its arguments on the ``meta`` device and
    their specs over ``ctx``'s mesh (``None``: replicated or unconstrained,
    as the reference).  For a model placed over a process mesh (the dry
    run's trace, ``launch.mesh.stand_in_mesh``) the arguments are this
    rank's: its parameter and optimizer blocks, its rows of a prefill
    batch, its blocks of the decode caches (``new_caches``) and a decode
    position of the last cache position (``S - 1``: every position
    attended, as the reference's step attends every one, masked), and
    the global train batch, which the train step cuts itself."""
    cfg = model.cfg
    period = len(T.layer_plan(cfg))
    params_abs = model.init_abstract(max_seq=cell_max_seq(cfg, shape))
    params_sh = named_shardings(ctx, params_abs, period)
    specs = model.input_specs(shape)
    placed = model.placement is not None
    params = model.params() if placed else params_abs

    if shape.kind == "train":
        tcfg = tcfg or TrainConfig()
        fn = make_train_step(model, tcfg)
        opt_abs = abstract_opt_state(params, cfg.opt_state_dtype)
        opt_sh = opt_state_shardings(ctx, params_abs, period)
        b_sh = batch_shardings(ctx, specs["batch"])
        args = (params, opt_abs, specs["batch"])
        return fn, args, (params_sh, opt_sh, b_sh), (params_sh, opt_sh, None)

    if shape.kind == "prefill":
        fn = make_prefill_step(model)
        b_sh = batch_shardings(ctx, specs["batch"])
        batch = _rows(specs["batch"], b_sh, ctx.mesh) if placed \
            else specs["batch"]
        return fn, (params, batch), (params_sh, b_sh), None

    # decode
    fn = make_serve_step(model)
    c_sh = cache_shardings(
        ctx, specs["caches"],
        seq_axes=decode_seq_axes(shape, ctx.mesh.axis_names))
    t_sh = batch_shardings(ctx, {"t": specs["token"]})["t"]
    if placed:
        token = _rows({"t": specs["token"]}, {"t": t_sh}, ctx.mesh)["t"]
        args = (params, model.new_caches(token.shape[0], shape.seq_len),
                token, shape.seq_len - 1)
    else:
        args = (params_abs, specs["caches"], specs["token"], specs["pos"])
    return fn, args, (params_sh, c_sh, t_sh, P()), (c_sh, t_sh)
