"""Step-function factories shared by the train and serve drivers.

The port of the JAX package's ``launch/steps.py`` step factories over the
port's model API (its sharding trees have no one-device meaning; ROADMAP
item 12b).  A train step takes a parameter set (``Model.params()`` of a
``Model.trainable()`` model: the model's own tensors), an ``AdamState``
and a batch dict (arrays or tensors), and updates the parameters and the
moments in place (``training.optimizer.adamw_update``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.models import transformer as T
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
    ``loss``, ``grad_norm``, ``lr`` (0-d tensors)."""
    cfg = model.cfg
    n_mb = max(tcfg.microbatch or cfg.microbatch, 1)
    period = len(T.layer_plan(cfg))

    def grad_fn(params: Params, batch: Dict[str, Any]):
        names = list(params)
        loss = model.train_loss(batch, params)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        # a weight the loss does not read (the cross-attention's bq) has
        # a zero gradient, as in the reference
        return loss.detach(), {n: torch.zeros_like(params[n]) if g is None
                               else g for n, g in zip(names, grads)}

    def train_step(params: Params, opt_state: AdamState,
                   batch: Dict[str, Any]):
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
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                mb_loss, g = grad_fn(params, mb)
                for n, a in grads.items():
                    a += g[n].float()
                loss = loss + mb_loss
                del g
            loss = loss / n_mb
            for a in grads.values():
                a.div_(n_mb)
        else:
            loss, grads = grad_fn(params, batch)
        if tcfg.grad_compression == "int8":
            grads = compress_decompress(grads, period)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  tcfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

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
