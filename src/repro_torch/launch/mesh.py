"""Device meshes: the reference's production and host meshes.

The port of the JAX package's ``launch/mesh.py``.  A ``Mesh`` has the
reference's ``axis_names``, ``shape`` (axis -> size) and ``devices`` (an
array of the mesh's shape).  Its positions are logical: one card may stand
at every position, and code over a mesh (``distributed/ep_moe.py``) runs
each position's share on that card in turn, where the reference's
``shard_map`` runs them on as many devices.  Single pod = 16 x 16 = 256
positions; multi-pod = 2 pods x 256 with a leading "pod" axis (data
parallelism across pods).

``init_process_mesh`` builds the other kind, a ``ProcessMesh``: one
process a position under ``torch.distributed`` (one process a card, as
``torchrun --nproc-per-node N`` starts them), each running the same
program, as each JAX controller does.  Code over it runs this rank's
share only and exchanges data through ``distributed/collectives.py``.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class Mesh:
    """``devices``: an array of ``torch.device`` (one per position; the
    same device may stand at many), ``axis_names`` one per array dim."""

    process = False     # positions are logical, all in this process

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)})"


def _grid(shape, devices) -> np.ndarray:
    """``devices`` cycled over the positions of ``shape``, row-major."""
    grid = np.empty(int(np.prod(shape)), dtype=object)
    for i in range(grid.size):
        grid[i] = devices[i % len(devices)]
    return grid.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The logical ``(16, 16)`` or ``(2, 16, 16)`` mesh on the ``meta``
    device: the dry run's per-device accounting reads its shape, and no
    data ever lives on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(_grid(shape, [torch.device("meta")]), axes)


def make_host_mesh(model_parallel: int = 1, device: DeviceLike = None
                   ) -> Mesh:
    """``(dp, model_parallel)`` over the cards present (``cuda`` unless the
    caller asks for the CPU, which counts as one), ``dp = max(1, count //
    model_parallel)`` as in the reference; fewer cards than positions
    stand at several positions each."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    dp = max(1, len(cards) // model_parallel)
    return Mesh(_grid((dp, model_parallel), cards), ("data", "model"))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device: Optional[torch.device] = None) -> Mesh:
    """A logical mesh of ``shape`` with one ``device`` (default the CPU)
    at every position."""
    return Mesh(_grid(tuple(shape), [torch.device(device or "cpu")]),
                axis_names)


class ProcessMesh(Mesh):
    """A mesh whose positions are the ranks of the default process group,
    row-major: ``devices`` holds the rank at each position.  This process
    is ``rank`` at ``coords`` (one index an axis) and runs on ``device``;
    ``group(axis)`` is its subgroup along ``axis`` (the ranks that differ
    from it in that coordinate only, in axis order, so a rank's index in
    the group is its coordinate)."""

    process = True

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int, device: torch.device, backend: str,
                 groups: Dict[str, object]):
        super().__init__(np.arange(int(np.prod(shape)), dtype=object)
                         .reshape(tuple(shape)), axis_names)
        self.rank = rank
        self.device = device
        self.backend = backend
        self.coords: Tuple[int, ...] = tuple(
            int(c) for c in np.unravel_index(rank, tuple(shape)))
        self._groups = groups

    def group(self, axis: str):
        return self._groups[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self.axis_names.index(axis)]


# how long a collective waits for the other ranks before it fails (a rank
# that died or took another path must not hang the rest for good)
_TIMEOUT = timedelta(minutes=10)


def _env_int(name: str, default: Optional[int] = None) -> int:
    v = os.environ.get(name)
    if v is None:
        if default is None:
            raise ValueError(f"{name} is not set: launch with torchrun (or "
                             f"pass rank, world_size and a store)")
        return default
    return int(v)


def init_process_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
                      backend: Optional[str] = None,
                      device: DeviceLike = None, store=None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None) -> ProcessMesh:
    """Join (or reuse) the default process group and lay its ranks over
    ``shape`` row-major.  Reads torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR``/``PORT``
    unless ``store``, ``rank`` and ``world_size`` are given.  The world
    size must equal the mesh's size (``ValueError``).

    A rank's device is ``cuda:LOCAL_RANK`` (modulo the cards present)
    unless the caller asks for the CPU.  The backend is NCCL on the card
    and gloo on the CPU; ranks that share a card (more local ranks than
    cards) need ``backend="gloo"`` from the caller, since NCCL refuses two
    ranks on one card: without it this raises ``ValueError``.  Every rank
    then makes one subgroup for each slice of each axis, all in the same
    order (``dist.new_group`` is collective over the default group)."""
    import torch.distributed as dist
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape))
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} for axes {tuple(axis_names)}")
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        rank = _env_int("RANK") if rank is None else rank
        world_size = (_env_int("WORLD_SIZE") if world_size is None
                      else world_size)
    if world_size != size:
        raise ValueError(f"a world of {world_size} processes cannot hold a "
                         f"mesh of {size} positions {shape}")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if dev.index is None:           # this rank's card
            dev = torch.device("cuda", local_rank % cards)
            shared = local_world > cards
        else:                           # every local rank on this card
            shared = local_world > 1
    else:
        shared = False
    if backend is None:
        if shared:
            raise ValueError(
                f"{local_world} ranks share {dev}: NCCL refuses two ranks "
                f"on one card; pass backend='gloo' to run them over gloo")
        backend = "nccl" if dev.type == "cuda" else "gloo"
    elif backend == "nccl" and (shared or dev.type != "cuda"):
        raise ValueError(f"backend='nccl' needs one card a rank; {dev} is "
                         f"{'shared' if shared else 'not a card'}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs "
                             f"{dist.get_backend()}, not {backend}")
    else:
        kw = dict(backend=backend, timeout=_TIMEOUT)
        if backend == "nccl":
            kw["device_id"] = dev
        if store is not None:
            kw.update(store=store, rank=rank, world_size=world_size)
        dist.init_process_group(**kw)
    ranks = np.arange(size).reshape(shape)
    groups = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            members = [int(r) for r in line]
            g = dist.new_group(members)
            if rank in members:
                groups[name] = g
    return ProcessMesh(shape, axis_names, rank, dev, backend, groups)
