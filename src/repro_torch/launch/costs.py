"""What a traced step runs: its FLOPs, bytes, collectives and memory.

The dry run's counterpart of the reference's compiled cost analysis
(``launch/dryrun.py``).  A ``CostCounter`` is a ``TorchDispatchMode``: every
aten operation of the step passes through it, on ``meta`` tensors (one
rank of the production mesh, ``launch.mesh.stand_in_mesh``), and it adds

* **FLOPs**: a product by ``torch.utils.flop_counter``'s formulas (also
  kept apart as ``product_flops``, what ``FlopCounterMode`` counts); an
  elementwise operation (tagged ``pointwise``) one an output element and a
  reduction one an input element, as XLA's cost analysis counts them;
  the hand-written kernels K3-K7 by their own formulas (each kernel
  package's ``ops.cost``), which their ``meta`` stand-ins report through
  ``cost_hooks.charge``;
* **bytes**: every operation's tensor operands read and its tensor outputs
  written, views and metadata operations (``empty``, strides) excluded,
  each operation counted alone: what eager PyTorch executes, unfused;
* **collectives**: wire bytes by the reference's type names, as
  ``distributed/collectives.py`` reports each one through
  ``cost_hooks.collective``
  (all-reduce 2x its operand, all-gather its output, reduce-scatter and
  all-to-all their operand), with ``total_wire_bytes`` and
  ``num_collectives``;
* **memory**: the peak bytes of the live storages the step made
  (``temp_bytes``; its arguments' storages are not counted).  A storage is
  counted once however many tensors view it, and freed when its last
  tensor dies.

A step must not read a tensor's value on the host: on ``meta`` there is
none, and the operation raises (here, where it asks for a Python value;
an output whose size the data decides fails in its ``meta`` kernel).
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.cost_hooks import ACTIVE, COLLECTIVES, nbytes

# operations that allocate or re-describe memory and move no data
_METADATA = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "as_strided", "_reshape_alias", "_unsafe_view", "detach", "alias",
    "lift_fresh", "set_", "resize_", "is_same_size", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset"})
# collective operations: their wire bytes come through ``collective``
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class CostCounter(TorchDispatchMode):
    """The counts of the operations run inside ``with CostCounter(args)``
    (the module docstring).  ``args``: the step's arguments, whose
    storages are not temporaries."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0.0
        self.product_flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.n_coll = 0
        self.kernels: Dict[str, list] = {}
        self._args = {self._key(t) for t in _tensors(args)}
        self._live: Dict[int, tuple] = {}       # storage -> (ref, bytes)
        self._live_bytes = 0
        self.temp_bytes = 0

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def __enter__(self):
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    def collectives(self) -> Dict[str, int]:
        """Wire bytes by type, the reference's layout."""
        return dict(self.coll, total_wire_bytes=sum(self.coll.values()),
                    num_collectives=self.n_coll)

    # ------------------------------------------------------------ memory
    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args:
                continue
            held = self._live.get(key)
            if held is not None and not held[0].expired():
                continue
            if held is not None:            # a freed storage's address
                self._live_bytes -= held[1]
            n = st.nbytes()
            self._live[key] = (StorageWeakRef(st), n)
            self._live_bytes += n
            if self._live_bytes > self.temp_bytes:
                self._sweep()
                self.temp_bytes = max(self.temp_bytes, self._live_bytes)

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._live_bytes -= self._live.pop(k)[1]

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch.Tag.data_dependent_output in func.tags:
            raise RuntimeError(f"{func}: the traced step reads a tensor's "
                               "value on the host")
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return out
        name = func.overloadpacket.__name__
        outs = list(_tensors(out))
        self._track(outs)
        if func.is_view or name in _METADATA:
            return out
        ins = list(_tensors((args, kwargs)))
        self.bytes += sum(nbytes(t) for t in ins) + \
            sum(nbytes(t) for t in outs)
        packet = func.overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.product_flops += f
            self.flops += f
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags:
            self.flops += sum(t.numel() for t in ins)
        return out
