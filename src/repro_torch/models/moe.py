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

Over a process mesh the layer is placed (``build_model(cfg, mesh=)``:
``placed`` names its ``sharding.Placement``), as the reference's GSPMD
places it: the experts ``("expert", "fsdp", None)``, so a rank holds
``E / n`` of them (``n`` the model axis) with their FSDP dim gathered over
the data axes before use; the router and the shared gate gathered over
the data axes and replicated over ``model``; the shared expert column-
(``shared_w(i|g)``) and row-parallel (``shared_wo``) over ``model``.
Where the model axis does not divide the padded experts, or the shared
width, that part is computed whole on every rank (``layers.fallback``).  The
sort dispatch keeps the reference's global meaning: the tokens of every
data shard are gathered, routed and sorted as one batch (one capacity
``C`` from the global token count), a rank fills and runs only its
experts' rows of the ``(E, C, D)`` buffer, and each copy's contribution,
owned by one model rank, is summed over ``model`` (the others add exact
zeros) for this data shard's tokens, whose k terms are then added in
ascending expert id as one process adds them.  The dense dispatch takes
this rank's experts' columns of the routing weights and sums the float32
partials over ``model`` before its one rounding.  The EP dispatch runs
the process body on the rank's experts.  Every collective is the
identity on an unplaced layer, which keeps the one-process bits.

The expert share (``MoE(experts=rows)``, an unplaced layer holding the
rows of the padded expert dim its process owns, the rest replicated)
serves the EP dispatch only; the sort and dense dispatches raise on it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import P, block_index, gather_block
from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.models import layers as L
from repro_torch.models.layers import new_param, padded_experts


class MoE(nn.Module):
    """Weights of one MoE layer: the router (float32, ``(D, num_experts)``),
    the expert stacks ``wi``/``wg`` ``(E, D, Fe)`` and ``wo`` ``(E, Fe, D)``
    over the padded experts, and the shared expert's ``(in, out)`` weights
    with its float32 gate.  ``experts`` (a slice of the padded experts):
    hold only those rows of ``wi``/``wg``/``wo``, a process rank's share;
    ``Model.init`` then draws each full tensor and keeps the rows."""

    def __init__(self, cfg: ModelConfig, dtype, device,
                 experts: Optional[slice] = None):
        super().__init__()
        D = cfg.d_model
        Fe = cfg.d_ff_expert or cfg.d_ff
        E = padded_experts(cfg.num_experts)
        s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fe)
        self.experts = experts
        El = E if experts is None else len(range(E)[experts])
        self.router = new_param((D, cfg.num_experts), torch.float32, device)
        self.wi = new_param((El, D, Fe), dtype, device)
        self.wg = new_param((El, D, Fe), dtype, device)
        self.wo = new_param((El, Fe, D), dtype, device)
        # std of each weight drawn at init (the JAX package's scales)
        self.init_std = {"router": s_in, "wi": s_in, "wg": s_in,
                         "wo": s_out}
        # a share's weights are drawn at their full shape, then cut
        self.init_full = {} if experts is None else {
            "wi": (E, D, Fe), "wg": (E, D, Fe), "wo": (E, Fe, D)}
        if cfg.num_shared_experts:
            Fs = cfg.num_shared_experts * Fe
            self.shared_wi = new_param((D, Fs), dtype, device)
            self.shared_wg = new_param((D, Fs), dtype, device)
            self.shared_wo = new_param((Fs, D), dtype, device)
            self.shared_gate = new_param((D,), torch.float32, device)
            self.init_std.update(shared_wi=s_in, shared_wg=s_in,
                                 shared_wo=1.0 / math.sqrt(Fs),
                                 shared_gate=s_in)


def _share(p: MoE) -> Tuple[int, int]:
    """(first padded expert, count) of the experts ``p`` holds."""
    El = p.wi.shape[0]
    if p.experts is not None:
        return p.experts.start, El
    placed = getattr(p, "placed", None)
    if placed is None:
        return 0, El
    place, prefix = placed
    i, _ = block_index(place.specs[f"{prefix}.wi"][0], place.mesh)
    return i * El, El


def _data(p: MoE):
    """(context, data axes) of a placed layer; (None, ()) otherwise."""
    placed = getattr(p, "placed", None)
    if placed is None:
        return None, ()
    return placed[0].ctx, placed[0].ctx.batch_axes


def dispatch_tokens(p: MoE, x: torch.Tensor) -> int:
    """The tokens the dispatch sees: ``x``'s (B * S), times the data
    shards of a placed layer (the reference's GSPMD sees the global
    batch), which decide the dense dispatch of a small decode step."""
    ctx, axes = _data(p)
    n = 1
    for a in axes:
        n *= ctx.mesh.shape[a]
    return x.shape[0] * x.shape[1] * n


def route(p: MoE, xf: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xf: (T, D) -> (weights (T, k) float32, expert ids (T, k) int64), the
    renormalised top k of the float32 softmax.  A stable descending sort
    puts equal probabilities in index order, as ``jax.lax.top_k`` does.
    Placed: the router gathered over the data axes; a rank combines only
    its experts' copies, so its gradient is summed over ``model``."""
    router = L.copy_to(L.weight(p, "router"), L.tp_group(p, "wi"))
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    return top_p / top_p.sum(dim=-1, keepdim=True), top_i


def shared_expert(p: MoE, x: torch.Tensor) -> torch.Tensor:
    """The shared expert; placed: column-parallel ``shared_w(i|g)`` and
    row-parallel ``shared_wo`` over ``model``.  The gate reads the
    replicated input and scales the summed output, so every model rank
    holds the gate's whole gradient."""
    xr = L.copy_to(x, L.tp_group(p, "shared_wi"))
    h = F.silu(L.col(p, xr, "shared_wg")) * L.col(p, xr, "shared_wi")
    out = L.row(p, h, "shared_wo")
    gate = torch.sigmoid(x.float() @ L.weight(p, "shared_gate"))[..., None]
    return (out.float() * gate).to(x.dtype)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    E = padded_experts(cfg.num_experts)
    c = int(math.ceil(tokens * cfg.top_k * cfg.capacity_factor / E))
    return max(8, ((c + 7) // 8) * 8)


def _experts(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on (E, C, D) buffers: three grouped matmuls
    (placed: the rank's experts, their FSDP dim gathered)."""
    h = moe_gmm(buf, L.weight(p, "wi"))
    g = moe_gmm(buf, L.weight(p, "wg"))
    return moe_gmm(F.silu(g) * h, L.weight(p, "wo"))


def _every_expert(p: MoE, how: str) -> None:
    if p.experts is not None:
        raise NotImplementedError(
            f"the {how} dispatch needs every expert; this rank holds "
            f"experts {p.experts.start}..{p.experts.stop - 1} only (the EP "
            f"dispatch over its process mesh)")


def pack_copies(idx: torch.Tensor, E: int, C: int):
    """The sort dispatch's packing of the token copies ``idx`` (T, k):
    ``(order, e_sorted, pos, keep)``, the copies sorted stably by expert,
    each one's slot in its expert and whether it is within the capacity
    ``C``, as the reference computes them."""
    flat_e = idx.reshape(-1)                                # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    # the copies an expert got, at the static length E (``bincount``'s
    # length would be read from the data: every id is below E)
    counts = torch.zeros(E, dtype=torch.int64, device=idx.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=idx.device) - starts[e_sorted]
    return order, e_sorted, pos, pos < C


def moe_apply_sort(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sort/capacity dispatch.  x: (B, S, D); placed: this rank's data
    shard (the module docstring)."""
    _every_expert(p, "sort")
    B, S, D = x.shape
    k = cfg.top_k
    E = padded_experts(cfg.num_experts)
    group = L.tp_group(p, "wi")
    ctx, axes = _data(p)
    xf = L.copy_to(x, group).reshape(B * S, D)
    if axes:        # every data shard's tokens, in order
        xf = gather_block(xf, P(axes), ctx.mesh)
    T, Tl = xf.shape[0], B * S
    t0 = Tl * (ctx.data_shard if axes else 0)
    C = capacity(cfg, T)
    w, idx = route(p, xf, cfg)                              # (T, k)
    order, e_sorted, pos, keep = pack_copies(idx, E, C)
    t_sorted = order // k                                   # token of each
    e0, El = _share(p)
    mine = keep & (e_sorted >= e0) & (e_sorted < e0 + El)
    le = torch.where(mine, e_sorted - e0, 0)
    # dispatch: a copy dropped (or another rank's) goes to a spare row C,
    # which no product reads (no boolean indexing, so no device-to-host
    # sync)
    buf = torch.zeros((El, C + 1, D), dtype=x.dtype, device=x.device)
    buf[le, torch.where(mine, pos, C)] = xf[t_sorted]
    out_e = _experts(p, buf[:, :C])                         # (El, C, D)
    # combine: the reference scatter-adds the sorted contributions into a
    # model-dtype y, so each token's k terms are added in ascending expert
    # id with a rounding after each add; here the same adds, in that
    # order, as k deterministic steps (placed: each copy's term summed
    # over the model ranks, one of which owns it, for this data shard)
    gathered = out_e[le, torch.where(mine, pos, 0)]         # (T*k, D)
    w_sorted = w.reshape(-1)[order] * mine
    contrib = torch.empty_like(gathered)
    contrib[order] = gathered * w_sorted[:, None].to(x.dtype)
    contrib = L.reduce_from(contrib[t0 * k:(t0 + Tl) * k], group)
    by_id = torch.argsort(idx[t0:t0 + Tl], dim=-1)          # (Tl, k)
    contrib = torch.gather(contrib.reshape(Tl, k, D), 1,
                           by_id[..., None].expand(Tl, k, D))
    y = torch.zeros((Tl, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    y = y.reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + shared_expert(p, x)
    return y


def moe_apply_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every expert on every token (the tokens repeated across the experts
    as a stride-0 view), combined in float32 with the one-hot routing
    weights (placed: this rank's experts, the partials summed over
    ``model``, then one rounding)."""
    _every_expert(p, "dense")
    B, S, D = x.shape
    T = B * S
    E = padded_experts(cfg.num_experts)
    group = L.tp_group(p, "wi")
    xf = L.copy_to(x, group).reshape(T, D)
    w, idx = route(p, xf, cfg)
    e0, El = _share(p)
    comb = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    comb.scatter_add_(1, idx, w)                            # (T, E)
    out_e = _experts(p, xf.unsqueeze(0).expand(El, T, D))   # (El, T, D)
    y = torch.einsum("etd,te->td", out_e.float(), comb[:, e0:e0 + El])
    y = L.reduce_from(y, group).to(x.dtype).reshape(B, S, D)
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
