"""AdamW with the cosine schedule, global-norm clipping and the moment
dtype of the configuration (float32 by default; bfloat16 for the 398B
config, a memory trade the JAX package documents).

The port of the JAX package's ``training/optimizer.py`` over parameter
sets (dicts of tensors by the port's names).  The update math is float32
and casts back to each weight's dtype, as there.  Two differences:

* ``adamw_update`` writes the new weights and moments into the tensors it
  is given (the reference returns new arrays): a full-width model holds
  its moments once, not twice.  It returns those same tensors.
* Weight decay follows the reference's leaves, not the port's tensors:
  the reference decays every leaf of two or more dims, and its layer
  parameters are stacked over the periods, so every per-layer norm scale,
  bias and Mamba vector is decayed there and here; only ``final_norm``
  and ``enc_final_norm`` are not (``models.model.reference_ndim``).

Over a process mesh (``place``, a ``sharding.Placement``) the tensors are
this rank's blocks: the update is elementwise on them, and the global norm
sums every block once over the whole mesh (``global_norm``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import reference_ndim

Tensors = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the parameters' device
    m: Tensors           # like the parameters
    v: Tensors


def init_opt_state(params: Tensors, state_dtype: str = "float32"
                   ) -> AdamState:
    dt = torch_dtype(state_dtype)
    dev = next(iter(params.values())).device
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: torch.zeros(p.shape, dtype=dt, device=p.device)
           for n, p in params.items()},
        v={n: torch.zeros(p.shape, dtype=dt, device=p.device)
           for n, p in params.items()})


def lr_schedule(tcfg: TrainConfig, step: torch.Tensor,
                total_steps: int = 10_000) -> torch.Tensor:
    """Linear warm-up, then a cosine from 1 to 0.1 of the learning rate;
    float32 on ``step``'s device."""
    step = step.float()
    warm = torch.clamp((step + 1) / max(tcfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(total_steps - tcfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Tensors, place=None) -> torch.Tensor:
    """The square root of every tensor's sum of squares; ``place``: of
    the blocks over the mesh, each block counted by one rank (the first
    along the axes that replicate it) and the sums added over every
    axis."""
    if place is None:
        return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                              for t in tree.values()))
    from repro_torch.distributed.collectives import all_reduce_over
    dev = next(iter(tree.values())).device
    sq = sum((torch.sum(torch.square(t.float())) for n, t in tree.items()
              if place.counted_here(n)),
             torch.zeros((), dtype=torch.float32, device=dev))
    return torch.sqrt(all_reduce_over(sq, place.mesh))


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(grads: Tensors, state: AdamState, params: Tensors,
                 tcfg: TrainConfig, place=None
                 ) -> Tuple[Tensors, AdamState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: returns (params, state, metrics) with the
    new weights written into ``params`` and the new moments into
    ``state.m`` / ``state.v``; ``state.step`` is replaced.  Metrics:
    ``grad_norm`` (before clipping, over the whole mesh with ``place``)
    and ``lr``."""
    gn = global_norm(grads, place)
    # clip_by_global_norm's scale, applied leaf by leaf (no second copy of
    # the gradients)
    clip = (torch.clamp(tcfg.grad_clip / (gn + 1e-9), max=1.0)
            if tcfg.grad_clip > 0 else None)
    step = state.step + 1
    lr = lr_schedule(tcfg, state.step)
    b1, b2 = tcfg.beta1, tcfg.beta2
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        g = grads[name]
        gf = (g if clip is None else g * clip.to(g.dtype)).float()
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + gf * gf * (1 - b2)
        delta = (mf / c1) / (torch.sqrt(vf / c2) + tcfg.eps)
        if reference_ndim(name, p) >= 2:    # decoupled decay, matrices only
            delta = delta + tcfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    return params, AdamState(step, state.m, state.v), {"grad_norm": gn,
                                                       "lr": lr}
