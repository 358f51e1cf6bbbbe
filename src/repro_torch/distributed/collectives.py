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
(bfloat16, float32, int64).
"""
from __future__ import annotations

import torch


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
    return out


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=0, tiled=True)`` over ``mesh``'s
    ``axis`` (a ``ProcessMesh``)."""
    return all_gather_in(x, mesh.group(axis))


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)`` over ``mesh``'s
    ``axis`` (a ``ProcessMesh``)."""
    return all_to_all_in(x, mesh.group(axis))
