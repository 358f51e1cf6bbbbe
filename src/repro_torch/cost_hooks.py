"""Where the kernels and the collectives report their costs to a counter.

The kernels' ``meta`` stand-ins (``kernels/*/ops.py``) call ``charge`` with
their FLOPs and bytes, and ``distributed/collectives.py`` calls
``collective`` with each collective's wire bytes.  Both add to every
counter on ``ACTIVE``: the dry run's ``launch.costs.CostCounter`` puts
itself there for the ``with`` block it counts.  With no counter active
they do nothing, so the card's and the CPU's paths are as they were.
"""
from __future__ import annotations

from typing import List

import torch

# the reference's collective types (``collective_bytes``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the counters in force, innermost last (``launch.costs.CostCounter``)
ACTIVE: List = []


def charge(name: str, flops: float, n_bytes: float) -> None:
    """A hand-written kernel's ``meta`` stand-in: its FLOPs and bytes, by
    its formula, to every active counter."""
    for c in ACTIVE:
        c.flops += flops
        c.bytes += n_bytes
        k = c.kernels.setdefault(name, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += flops
        k[2] += n_bytes


def collective(kind: str, wire_bytes: int) -> None:
    """One collective of type ``kind`` (one of ``COLLECTIVES``) moving
    ``wire_bytes`` a rank, to every active counter."""
    for c in ACTIVE:
        c.coll[kind] += int(wire_bytes)
        c.n_coll += 1


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()
