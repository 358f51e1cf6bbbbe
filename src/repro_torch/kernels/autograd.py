"""What the model kernels' autograd wrappers share.

A kernel wrapper under autograd is a ``torch.autograd.Function`` whose
forward launches the hand-written kernel and saves only its inputs, and
whose backward is the vector-Jacobian product of the kernel's plain
version (``ref.py``), recomputed from those inputs.  The JAX package
differentiates its XLA versions and has no backward kernel to port; a
hand-written backward kernel is later performance work.  The wrappers take
the Function only when a gradient is wanted, so inference launches the
kernel exactly as before.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd records and some operand requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def plain_vjp(name: str, plain: Callable, inputs: Sequence[torch.Tensor],
              needs: Sequence[bool],
              cotangents: Sequence[Optional[torch.Tensor]]
              ) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradients of ``plain(*inputs)`` (one output or a tuple) against
    the inputs ``needs`` marks, given the outputs' ``cotangents`` (None for
    an output that received none); None for the other inputs.  Runs under
    ``record_function("plain_vjp.<name>")``, so a profile of a training
    step can tell the plain backward's device time."""
    with torch.profiler.record_function(f"plain_vjp.{name}"), \
            torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        outs = plain(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
        wrt = [x for x, n in zip(xs, needs) if n]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [c for _, c in pairs],
            allow_unused=True) if pairs and wrt else ())
    return tuple(next(grads) if n else None for n in needs)
