"""The collectives of the reference's ``shard_map`` bodies, between
processes over ``torch.distributed``.

``all_to_all(x, mesh, axis)`` and ``all_gather(x, mesh, axis)`` follow
``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)`` and
``jax.lax.all_gather(x, axis, axis=0, tiled=True)`` over the ranks of one
axis of a ``launch.mesh.ProcessMesh`` (``all_to_all_in`` and
``all_gather_in`` take the process group itself):

* ``all_to_all``: dim 0 of ``x`` is ``n`` equal blocks; block ``j`` goes
  to the axis's rank ``j``, and the result is the blocks received, in
  the order of the ranks that sent them;
* ``all_gather``: every rank's ``x`` stacked along dim 0 in rank order.

The tensors stay on their device: one ``all_to_all_single`` or one
single-tensor gather, whose errors reach the caller.  NCCL, and gloo on
the CPU and on CUDA tensors, take every dtype the port exchanges
(bfloat16, float32, int32, int64).

The sharded model's collectives carry gradients (``torch.autograd``):

* ``gather_dim(x, group, dim)``: every rank's ``x`` along ``dim`` in rank
  order; its backward sums every rank's gradient of the whole and keeps
  this rank's block (a reduce-scatter), so an FSDP weight gathered over
  the data axes gets the data-parallel sum of its gradient there;
* ``gather_alike(x, group, dim)``: the same gather, whose result every
  rank of the group then uses alike (a layer computed replicated over the
  model axis from its weights' blocks), so its backward keeps this rank's
  block of the gradient, unsummed;
* ``copy_to(x, group)``: the identity, whose backward sums the gradient
  over the group (the tensor-parallel region's input: each rank's
  gradient of it covers its own heads or columns only);
* ``reduce_from(x, group)``: the sum over the group, whose backward is the
  identity (a row-parallel product's partial sums, or a vocabulary-
  parallel lookup, after which every rank computes the same function).

``all_to_all`` and ``all_gather`` carry gradients too (the EP dispatch
of a trained model): the tiled ``all_to_all`` is its own adjoint, and the
``all_gather``'s result is used alike on every rank after it (as a
``reduce_from``'s is), so its backward keeps this rank's block of the
gradient, unsummed.

``all_reduce(x, group, op)`` (sum or max, no gradient) serves counts,
norms and metrics; ``all_reduce_over(x, mesh, axes, op)`` reduces over
several axes of a ``ProcessMesh``, one after the other (over every axis:
the whole mesh).  Every sum runs in float32 (a bfloat16 tensor is
widened first and rounded once after), so the sum over ranks rounds as
the one-process product's float32 accumulation does.  The reduce-scatter
is chosen by backend, never by trying: NCCL takes
``reduce_scatter_single`` on the card; gloo takes it on host tensors (a
CUDA tensor is copied to the host and its block back), since gloo's
reduce-scatter does not take CUDA tensors.

Each collective reports its type and wire bytes to the dry run's active
cost counter (``cost_hooks.collective``), by the reference's rules: an
all-reduce 2x its operand, an all-gather its output, a reduce-scatter
and an all-to-all their operand.  With no counter active nothing
changes.
"""
from __future__ import annotations

import torch

from repro_torch import cost_hooks


def _dist():
    import torch.distributed as dist
    return dist


def all_gather_in(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` along dim 0, in the group's rank order."""
    dist = _dist()
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    # ``all_gather_single`` is the newer name of ``all_gather_into_tensor``
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x, group=group)
    cost_hooks.collective("all-gather", cost_hooks.nbytes(out))
    return out


def all_to_all_in(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of ``x`` in the group's size of equal blocks, block ``j`` to
    rank ``j``; the blocks received, in sender order."""
    dist = _dist()
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split into "
                         f"{n} blocks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    cost_hooks.collective("all-to-all", cost_hooks.nbytes(x))
    return out


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``, in float32 and back to ``x``'s dtype) or the
    largest value (``"max"``) of ``x`` over the group's ranks, elementwise;
    a new tensor, no gradient."""
    dist = _dist()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    if op not in ops:
        raise ValueError(f"all_reduce: op {op!r} is not 'sum' or 'max'")
    y = x.detach()
    y = (y.float() if op == "sum" and y.dtype != torch.float32
         else y.clone(memory_format=torch.contiguous_format)).contiguous()
    dist.all_reduce(y, op=ops[op], group=group)
    cost_hooks.collective("all-reduce", 2 * cost_hooks.nbytes(y))
    return y.to(x.dtype)


def all_reduce_over(x: torch.Tensor, mesh, axes=None,
                    op: str = "sum") -> torch.Tensor:
    """``all_reduce`` over each of ``axes`` of the process ``mesh`` in
    turn (default every axis)."""
    for a in mesh.axis_names if axes is None else axes:
        x = all_reduce(x, mesh.group(a), op)
    return x


def _reduce_scatter(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over the group of every rank's ``g`` (float32), this rank's
    block of ``dim``."""
    dist = _dist()
    n = dist.get_world_size(group)
    gf = g.float().movedim(dim, 0).contiguous()
    if gf.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(g.shape)} does not split "
                         f"into {n} blocks")
    if dist.get_backend(group) == "gloo":
        gf = gf.cpu()
    out = gf.new_empty((gf.shape[0] // n,) + tuple(gf.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, gf, group=group)
    cost_hooks.collective("reduce-scatter", cost_hooks.nbytes(gf))
    return out.to(g.device).movedim(0, dim).to(g.dtype).contiguous()


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_in(x.movedim(dim, 0), group).movedim(0, dim) \
            .contiguous()

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``dim`` in the group's rank order; the
    backward sums the gradient over the group and keeps this rank's
    block (the module docstring)."""
    return _GatherDim.apply(x, group, dim % x.dim())


class _GatherAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather_in(x.movedim(dim, 0), group).movedim(0, dim) \
            .contiguous()

    @staticmethod
    def backward(ctx, g):
        r = _dist().get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), \
            None, None


def gather_alike(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``dim`` in the group's rank order, used
    alike on every rank after it; the backward keeps this rank's block of
    the gradient, unsummed (the module docstring)."""
    return _GatherAlike.apply(x, group, dim % x.dim())


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over the group."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group; its gradient passes as it is."""
    return _ReduceFrom.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_in(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_in(g, ctx.group), None


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=0, tiled=True)`` over ``mesh``'s
    ``axis`` (a ``ProcessMesh``); its backward keeps this rank's block."""
    return gather_alike(x, mesh.group(axis), 0)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)`` over ``mesh``'s
    ``axis`` (a ``ProcessMesh``); its backward is the same exchange."""
    return _AllToAll.apply(x, mesh.group(axis))
