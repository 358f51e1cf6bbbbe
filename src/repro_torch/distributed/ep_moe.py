"""Expert-parallel MoE: the reference's ``shard_map`` + ``all_to_all`` body
run for every mesh position on one device.

The port of the JAX package's ``distributed/ep_moe.py``.  Under a
``ShardCtx`` whose mesh has a ``model`` axis of ``n`` positions and data
axes of ``nd``, the reference splits each data shard's tokens over the
``n`` model ranks and, per rank:

  1. routes its ``Tc`` tokens (float32 softmax, top k with ties to the
     lower index, renormalised over the k);
  2. packs the token copies into per-destination buffers of capacity
     ``C = max(8, ceil(Tc * k * cf / n / 8) * 8)`` and exchanges them with
     one ``all_to_all`` over ``model``;
  3. packs what it received per local expert (capacity
     ``C2 = max(8, ceil(n * C * 1.3 / E_local / 8) * 8)``) and runs its
     ``E_local = E / n`` experts;
  4. returns the expert outputs with the reverse ``all_to_all`` and
     combines them at the origin in float32 with the gate weights;
  5. ``all_gather``s the tokens over ``model``.

Here every (data shard, model rank) pair is a row of one batch: each
``all_to_all`` is the transpose of the ``(source rank, destination
rank)`` blocks and the ``all_gather`` a concatenation.  The three expert
products run through the grouped expert matmul (``kernels.moe_gmm``, the
kernel on the card) once each: the ranks' expert buffers side by side are
``(n * E_local = E, nd * C2, D)``, expert ``r * E_local + e`` being rank
``r``'s local expert ``e`` with data shard ``d``'s rows at ``d * C2``.
The shared expert is added at the end, as in the reference.

Over a process mesh (``launch.mesh.init_process_mesh``: one process a
position) each process runs the same body for its own position only:
its ``Tc`` tokens of its data shard, its ``E_local`` experts (the
model's share, ``sharding.shard_params``) in one ``(E_local, C2, D)``
buffer, and the ``all_to_all``s and the ``all_gather`` as collectives
between the processes (``distributed/collectives.py``).  Every step is
per position, so its output equals the one-process body's rows of that
data shard bit for bit.

A copy that overflows its destination's capacity is dropped, and only it
(the reference's documented contract).  The reference's own body writes
``-1`` for a dropped copy into slot 0 of its destination's expert-id
buffer (``jnp.where(keep, pos, 0)``, then a ``set``), so the copy kept at
slot 0 of an overflowing bin is treated as padding on the receiving rank
there as well (ROADMAP §3).  The port writes nothing for a dropped copy.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import current_ctx
from repro_torch.models import moe as X
from repro_torch.models.layers import padded_experts


def _axis_prod(mesh, axes) -> int:
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


def _pack_by_key(keys: torch.Tensor, n_bins: int, capacity: int):
    """Sort-free capacity packing along the last dim of ``keys`` (int64 in
    ``[0, n_bins)``): ``(order, sorted_keys, pos, keep)`` such that placing
    item ``order[i]`` at ``(sorted_keys[i], pos[i])`` packs each bin
    densely in item order; an item at or past ``capacity`` overflows
    (``keep`` False) and has ``pos`` 0, as the reference's.  The sort is
    stable, as ``jnp.argsort``, so ties keep their order."""
    sorted_keys, order = torch.sort(keys, dim=-1, stable=True)
    counts = torch.zeros(keys.shape[:-1] + (n_bins,), dtype=torch.int64,
                         device=keys.device)
    counts.scatter_add_(-1, keys, torch.ones_like(keys))
    starts = torch.cumsum(counts, -1) - counts
    pos = torch.arange(keys.shape[-1], device=keys.device) \
        - torch.gather(starts, -1, sorted_keys)
    keep = pos < capacity
    return order, sorted_keys, torch.where(keep, pos, 0), keep


def moe_apply_ep(p: X.MoE, x: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """x: (B, S, D), the batch split over the data axes.  Without a
    context or a model axis, with ``E % n`` or ``(B * S) % (n * nd)``, it
    runs ``moe_apply_sort``, as the reference does.  Over a process mesh
    ``x`` is this rank's data shard and the result is too."""
    ctx = current_ctx()
    if ctx is None or ctx.model_axis is None:
        return X.moe_apply_sort(p, x, cfg)
    mesh = ctx.mesh
    n = mesh.shape[ctx.model_axis]
    nd = max(_axis_prod(mesh, ctx.batch_axes), 1)
    E = padded_experts(cfg.num_experts)
    B, S, D = x.shape
    if ctx.process:
        nd = 1                      # x is this rank's data shard already
    if E % n or (B * S) % (n * nd):
        return X.moe_apply_sort(p, x, cfg)      # tiny/ragged cases
    if B % nd:
        raise ValueError(f"a batch of {B} rows does not split over the "
                         f"{nd} positions of the data axes "
                         f"{ctx.batch_axes}")
    E_local = E // n
    if ctx.process:
        if p.wi.shape[0] != E_local:
            raise ValueError(f"this rank holds {p.wi.shape[0]} experts, "
                             f"the mesh gives it {E_local} (build the "
                             f"model with mesh=, or shard_params)")
        return _rank_body(p, x, cfg, ctx, n, E_local)
    R = nd * n                      # (data shard, model rank) rows
    rows = torch.arange(R, device=x.device)[:, None]

    def exchange(t):
        # all_to_all: (data, source, destination) -> (data, destination,
        # source), each (R, n, C, ...) block a transpose
        return t.view((nd, n, n) + t.shape[2:]).transpose(1, 2).reshape(
            (R, -1) + t.shape[3:])

    yc = _body(p, x.reshape(R, -1, D), cfg, n, E_local, exchange,
               rank_of=rows % n, data_of=rows // n, nd_buf=nd)
    # all_gather over model: the ranks' rows in order, data shards too
    y = yc.to(x.dtype).reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + X.shared_expert(p, x)
    return y


def _rank_body(p: X.MoE, x: torch.Tensor, cfg: ModelConfig, ctx, n: int,
               E_local: int) -> torch.Tensor:
    """The reference's ``body`` for this process's position: its ``Tc``
    tokens of the data shard, both ``all_to_all``s and the ``all_gather``
    over the model axis between the processes, its own ``E_local``
    experts in one buffer."""
    from repro_torch.distributed.collectives import all_gather, all_to_all
    B, S, D = x.shape
    mesh, ax = ctx.mesh, ctx.model_axis
    Tc = B * S // n
    r = ctx.model_rank
    xc = x.reshape(B * S, D)[r * Tc:(r + 1) * Tc].unsqueeze(0)

    def exchange(t):
        return all_to_all(t.reshape((-1,) + t.shape[3:]), mesh, ax
                          ).unsqueeze(0)

    zero = torch.zeros((1, 1), dtype=torch.int64, device=x.device)
    yc = _body(p, xc, cfg, n, E_local, exchange, rank_of=zero,
               data_of=zero, nd_buf=1)
    y = all_gather(yc[0].to(x.dtype), mesh, ax).reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + X.shared_expert(p, x)
    return y


def _body(p: X.MoE, xc: torch.Tensor, cfg: ModelConfig, n: int,
          E_local: int, exchange, *, rank_of: torch.Tensor,
          data_of: torch.Tensor, nd_buf: int) -> torch.Tensor:
    """The body for the rows of ``xc`` (R, Tc, D), each a (data shard,
    model rank) position's tokens: routing, the two packs, the expert
    products and the float32 combine.  ``exchange`` is the
    ``all_to_all`` of an (R, n, C, ...) per-destination tensor into the
    (R, n * C, ...) tensor each row receives.  Row ``i``'s expert buffer
    rows for its local expert ``e`` start at ``((rank_of[i] * E_local +
    e) * nd_buf + data_of[i]) * C2`` of one ``(E_buf, nd_buf * C2, D)``
    buffer whose experts are ``p``'s.  Returns (R, Tc, D) float32."""
    R, Tc, D = xc.shape
    k = cfg.top_k
    dev = xc.device
    rows = torch.arange(R, device=dev)[:, None]
    E_buf = p.wi.shape[0]

    # routing, one call a row (every position routes its own tokens)
    routed = [X.route(p, xc[i], cfg) for i in range(R)]
    flat_w = torch.stack([w for w, _ in routed]).reshape(R, Tc * k)
    flat_e = torch.stack([i for _, i in routed]).reshape(R, Tc * k)
    dest = flat_e // E_local                                # target rank
    C = max(8, int(math.ceil(Tc * k * cfg.capacity_factor / n / 8)) * 8)
    order, dest_s, pos, keep = _pack_by_key(dest, n, C)
    t_s = order // k                                        # token of each

    # dispatch into (R, n, C) send slots; an overflowing copy goes to one
    # spare row past them, which nothing reads
    spare = R * n * C
    slot = torch.where(keep, (rows * n + dest_s) * C + pos, spare)
    send = xc.new_zeros((spare + 1, D))
    send[slot.reshape(-1)] = xc[rows, t_s].reshape(-1, D)
    send_eid = torch.full((spare + 1,), -1, dtype=torch.int64, device=dev)
    send_eid[slot.reshape(-1)] = (torch.gather(flat_e, 1, order)
                                  % E_local).reshape(-1)
    rtok = exchange(send[:-1].view(R, n, C, D))             # (R, n*C, D)
    reid = exchange(send_eid[:-1].view(R, n, C))            # (R, n*C)

    # local per-expert packing (padding expert E_local for empty slots)
    eid = torch.where(reid >= 0, reid, E_local)
    C2 = max(8, int(math.ceil(n * C * 1.3 / E_local / 8)) * 8)
    o2, e2, pos2, keep2 = _pack_by_key(eid, E_local + 1, C2)
    valid2 = keep2 & (e2 < E_local)
    spare2 = E_buf * nd_buf * C2
    brow = torch.where(valid2, ((rank_of * E_local + e2) * nd_buf
                                + data_of) * C2 + pos2, spare2)
    buf = xc.new_zeros((spare2 + 1, D))
    buf[brow.reshape(-1)] = rtok[rows, o2].reshape(-1, D)
    out_e = X._experts(p, buf[:-1].view(E_buf, nd_buf * C2, D))  # 3 x K6

    # back to the received slots, then the reverse all_to_all
    vals = torch.where(valid2[..., None],
                       out_e.reshape(spare2, D)[torch.where(valid2, brow, 0)],
                       0)
    inv2 = torch.argsort(o2, dim=-1)                        # o2 permutes
    back = torch.gather(vals, 1, inv2[..., None].expand(-1, -1, D))
    back = exchange(back.view(R, n, C, D))

    # combine at the origin in float32: each token's terms in the sorted
    # order, from 0, as the reference's scatter-add adds them
    got = back[rows, dest_s * C + pos]
    contrib = got * (torch.gather(flat_w, 1, order) * keep)[..., None].to(
        xc.dtype)
    inv = torch.argsort(order, dim=-1)
    by_tok = torch.gather(contrib, 1, inv[..., None].expand(-1, -1, D))
    seq = torch.sort(dest.view(R, Tc, k), dim=-1, stable=True).indices
    by_tok = torch.gather(by_tok.view(R, Tc, k, D), 2,
                          seq[..., None].expand(-1, -1, -1, D))
    yc = torch.zeros((R, Tc, D), dtype=torch.float32, device=dev)
    for j in range(k):
        yc = yc + by_tok[:, :, j].float()
    return yc
