"""Int8 gradient compression, as the JAX package applies it before its
cross-pod all-reduce: symmetric per-leaf quantisation (round half to even,
as ``jnp.round``) and the error-feedback variant that carries the
quantisation residual.

The port of the JAX package's ``training/compression.py`` over gradient
sets by the port's names.  The reference scales each of its leaves as a
whole, and a layer's weight there is one leaf stacked over the periods,
so here the tensors of one reference leaf (``models.model.reference_leaf``)
share one scale: the same bits.  Leaves of fewer than two dims in the
reference (``final_norm``, ``enc_final_norm``) pass through.  ``period``:
the layers of one period of the model's plan (``len(layer_plan(cfg))``).
Over a process mesh (``place``, a ``sharding.Placement``) the gradients
are this rank's blocks, and each leaf's scale takes its largest magnitude
over every block of the leaf (one max over the mesh for all leaves), so
the bits are the one-process step's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.models.model import reference_leaf, reference_ndim

Tensors = Dict[str, torch.Tensor]


def _leaves(grads: Tensors, period: int) -> List[List[str]]:
    """The port's names grouped by the reference's leaf."""
    groups: Dict[str, List[str]] = {}
    for name in grads:
        groups.setdefault(reference_leaf(name, period), []).append(name)
    return list(groups.values())


def _amax(gs: List[torch.Tensor]) -> torch.Tensor:
    """The largest magnitude of a leaf's tensors, float32."""
    return torch.stack([g.abs().max().float() for g in gs]).max()


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _amaxes(leaves: List[List[torch.Tensor]], place
            ) -> List[torch.Tensor]:
    """Each leaf's largest magnitude (over the whole mesh with ``place``:
    a max over every axis, which replicas do not change)."""
    amax = [_amax(gfs) for gfs in leaves]
    if place is None or not amax:
        return amax
    from repro_torch.distributed.collectives import all_reduce_over
    return list(all_reduce_over(torch.stack(amax), place.mesh, op="max"))


def _q(gf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)


def _dq(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_decompress(grads: Tensors, period: int = 1,
                        place=None) -> Tensors:
    """Quantise then dequantise every gradient leaf of two or more dims
    (smaller leaves pass)."""
    out = dict(grads)
    groups = [names for names in _leaves(grads, period)
              if reference_ndim(names[0], grads[names[0]]) >= 2]
    amaxes = _amaxes([[grads[n] for n in names] for names in groups], place)
    for names, amax in zip(groups, amaxes):
        s = _scale(amax)
        for n in names:
            out[n] = _dq(_q(grads[n].float(), s), s, grads[n].dtype)
    return out


def compress_with_feedback(grads: Tensors, residual: Tensors,
                           period: int = 1) -> Tuple[Tensors, Tensors]:
    """Error-feedback variant: returns (decompressed grads, new residual)."""
    out, res = dict(grads), {}
    for names in _leaves(grads, period):
        if reference_ndim(names[0], grads[names[0]]) < 2:
            for n in names:
                res[n] = torch.zeros_like(grads[n], dtype=torch.float32)
            continue
        gfs = [grads[n].float() + residual[n] for n in names]
        s = _scale(_amax(gfs))
        for n, gf in zip(names, gfs):
            dq = _dq(_q(gf, s), s, torch.float32)
            out[n] = dq.to(grads[n].dtype)
            res[n] = gf - dq
    return out, {n: res[n] for n in grads}


def init_residual(grads_spec: Tensors) -> Tensors:
    """Zero residuals: float32 of each leaf's shape, a scalar for a leaf
    that passes through."""
    return {n: (torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                if reference_ndim(n, g) >= 2
                else torch.zeros((), dtype=torch.float32, device=g.device))
            for n, g in grads_spec.items()}
