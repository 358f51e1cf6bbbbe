"""Device meshes: the reference's production and host meshes.

The port of the JAX package's ``launch/mesh.py``.  A ``Mesh`` has the
reference's ``axis_names``, ``shape`` (axis -> size) and ``devices`` (an
array of the mesh's shape).  Its positions are logical: one card may stand
at every position, and code over a mesh (``distributed/ep_moe.py``) runs
each position's share on that card in turn, where the reference's
``shard_map`` runs them on as many devices.  Single pod = 16 x 16 = 256
positions; multi-pod = 2 pods x 256 with a leading "pod" axis (data
parallelism across pods).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class Mesh:
    """``devices``: an array of ``torch.device`` (one per position; the
    same device may stand at many), ``axis_names`` one per array dim."""

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
