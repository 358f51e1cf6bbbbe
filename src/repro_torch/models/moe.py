"""Mixture-of-Experts layer: top-k routing, the shared expert, and the
dispatch paths of the JAX package's ``models/moe.py``.

* ``moe_apply_sort``: sort/capacity dispatch.  Token copies are sorted by
  expert, packed into an ``(E, C, D)`` buffer (copies past an expert's
  capacity ``C`` dropped) and run through the grouped expert matmul.
* ``moe_apply_dense``: every expert on every token, combined with the
  one-hot routing weights.  The model takes it for a decode step of at most
  16 tokens, as the reference does.

The three expert products of both paths go through ``kernels.moe_gmm``
(the kernel on the card, its plain version on the CPU); the JAX package
computes them with ``jnp.einsum``.  Routing: the float32 softmax over the
real experts, its top k (ties to the lower index, as ``jax.lax.top_k``),
renormalised over the k.  Experts are padded to a multiple of 16; no token
is routed to a padded expert.

``moe_impl="ep"`` runs the expert-parallel dispatch
(``distributed/ep_moe.py``) under a ``ShardCtx`` whose mesh has a
``model`` axis, every mesh position on one device and its three expert
products through the same kernel; without one, or where the mesh does not
divide the experts or the tokens, it runs the sort path, as the reference
does.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.models.layers import new_param, padded_experts


class MoE(nn.Module):
    """Weights of one MoE layer: the router (float32, ``(D, num_experts)``),
    the expert stacks ``wi``/``wg`` ``(E, D, Fe)`` and ``wo`` ``(E, Fe, D)``
    over the padded experts, and the shared expert's ``(in, out)`` weights
    with its float32 gate."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D = cfg.d_model
        Fe = cfg.d_ff_expert or cfg.d_ff
        E = padded_experts(cfg.num_experts)
        s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fe)
        self.router = new_param((D, cfg.num_experts), torch.float32, device)
        self.wi = new_param((E, D, Fe), dtype, device)
        self.wg = new_param((E, D, Fe), dtype, device)
        self.wo = new_param((E, Fe, D), dtype, device)
        # std of each weight drawn at init (the JAX package's scales)
        self.init_std = {"router": s_in, "wi": s_in, "wg": s_in,
                         "wo": s_out}
        if cfg.num_shared_experts:
            Fs = cfg.num_shared_experts * Fe
            self.shared_wi = new_param((D, Fs), dtype, device)
            self.shared_wg = new_param((D, Fs), dtype, device)
            self.shared_wo = new_param((Fs, D), dtype, device)
            self.shared_gate = new_param((D,), torch.float32, device)
            self.init_std.update(shared_wi=s_in, shared_wg=s_in,
                                 shared_wo=1.0 / math.sqrt(Fs),
                                 shared_gate=s_in)


def route(p: MoE, xf: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xf: (T, D) -> (weights (T, k) float32, expert ids (T, k) int64), the
    renormalised top k of the float32 softmax.  A stable descending sort
    puts equal probabilities in index order, as ``jax.lax.top_k`` does."""
    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    return top_p / top_p.sum(dim=-1, keepdim=True), top_i


def shared_expert(p: MoE, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p.shared_wg) * (x @ p.shared_wi)
    out = h @ p.shared_wo
    gate = torch.sigmoid(x.float() @ p.shared_gate)[..., None]
    return (out.float() * gate).to(x.dtype)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    E = padded_experts(cfg.num_experts)
    c = int(math.ceil(tokens * cfg.top_k * cfg.capacity_factor / E))
    return max(8, ((c + 7) // 8) * 8)


def _experts(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on (E, C, D) buffers: three grouped matmuls."""
    h = moe_gmm(buf, p.wi)
    g = moe_gmm(buf, p.wg)
    return moe_gmm(F.silu(g) * h, p.wo)


def moe_apply_sort(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sort/capacity dispatch.  x: (B, S, D)."""
    B, S, D = x.shape
    T, k = B * S, cfg.top_k
    E = padded_experts(cfg.num_experts)
    C = capacity(cfg, T)
    xf = x.reshape(T, D)
    w, idx = route(p, xf, cfg)                              # (T, k)
    flat_e = idx.reshape(-1)                                # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    t_sorted = order // k                                   # token of each
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=x.device) - starts[e_sorted]
    keep = pos < C                                          # capacity drops
    # dispatch: a dropped copy goes to a spare row C, which no product
    # reads (no boolean indexing, so no device-to-host sync)
    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    buf[e_sorted, torch.where(keep, pos, C)] = xf[t_sorted]
    out_e = _experts(p, buf[:, :C])                         # (E, C, D)
    # combine: the reference scatter-adds the sorted contributions into a
    # model-dtype y, so each token's k terms are added in ascending expert
    # id with a rounding after each add; here the same adds, in that
    # order, as k deterministic steps
    gathered = out_e[e_sorted, torch.where(keep, pos, 0)]   # (T*k, D)
    w_sorted = w.reshape(-1)[order] * keep
    contrib = torch.empty_like(gathered)
    contrib[order] = gathered * w_sorted[:, None].to(x.dtype)
    by_id = torch.argsort(idx, dim=-1)                      # (T, k)
    contrib = torch.gather(contrib.reshape(T, k, D), 1,
                           by_id[..., None].expand(T, k, D))
    y = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    y = y.reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + shared_expert(p, x)
    return y


def moe_apply_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every expert on every token (the tokens repeated across the experts
    as a stride-0 view), combined in float32 with the one-hot routing
    weights."""
    B, S, D = x.shape
    T = B * S
    E = padded_experts(cfg.num_experts)
    xf = x.reshape(T, D)
    w, idx = route(p, xf, cfg)
    comb = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    comb.scatter_add_(1, idx, w)                            # (T, E)
    out_e = _experts(p, xf.unsqueeze(0).expand(E, T, D))    # (E, T, D)
    y = torch.einsum("etd,te->td", out_e.float(), comb).to(x.dtype)
    y = y.reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + shared_expert(p, x)
    return y


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.moe_impl == "dense":
        return moe_apply_dense(p, x, cfg)
    if cfg.moe_impl == "ep":
        from repro_torch.distributed.ep_moe import moe_apply_ep
        return moe_apply_ep(p, x, cfg)
    return moe_apply_sort(p, x, cfg)
