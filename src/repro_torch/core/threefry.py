"""Threefry-2x32 keys and uniforms, bitwise as ``jax.random`` draws them.

The reference's host-sample walker (``repro.core.pdgraph._walk_core``) keys
every (application, refresh) walk by ``fold_in(fold_in(PRNGKey(seed),
key_id), refresh)``, splits that key into one key per step and draws two
rows of float32 uniforms per step with ``jax.random.uniform``.  This module
is the port's own copy of those four functions for JAX's
``jax_threefry_partitionable`` layout (on by default in JAX 0.9): a split
or a bit draw hashes the flat index ``i`` of each output as the counter
pair ``(i >> 32, i & 0xffffffff)``, and ``fold_in(key, d)`` hashes ``(0,
d)``.

A key is an ``int64`` tensor whose last axis holds the two 32-bit words.
Every word lives in ``int64`` masked to 32 bits, because PyTorch on the
CPU has no ``>>`` or ``+`` for ``uint32``; the functions are plain tensor
code and run on any device, batched over the leading axes of the key.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000        # 1.0f: the exponent of [1, 2)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) of counters ``(x0, x1)``
    under key ``(k0, k1)``; all operands broadcast, words in ``int64``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor):
    return key[..., 0], key[..., 1]


def fold_in(key: torch.Tensor,
            data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in``: key ``(..., 2)`` and data (an int, or a
    tensor broadcasting against the key's leading axes) -> ``(..., 2)``."""
    k0, k1 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def _counters(n: int, device) -> tuple:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key ``(..., 2)`` -> ``(..., num, 2)``."""
    k0, k1 = _words(key)
    hi, lo = _counters(num, key.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (``int64`` in ``[0, 2**32)``): key
    ``(..., 2)`` -> ``(..., *shape)``, element ``i`` of the flattened
    shape hashing counter ``i``."""
    shape = tuple(shape)
    k0, k1 = _words(key)
    hi, lo = _counters(math.prod(shape), key.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], hi, lo)
    return (y0 ^ y1).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on ``[0, 1)``: the top
    23 random bits as the mantissa of a float in ``[1, 2)``, minus 1.0,
    floored at 0.0."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)


def walk_uniforms(keys: torch.Tensor, max_steps: int,
                  n_walkers: int) -> torch.Tensor:
    """The whole uniform stream of a batch of walks in one call: keys
    ``(A, 2)`` -> ``(A, max_steps, 2, n_walkers)`` float32, step ``t``
    drawing ``uniform(split(key, max_steps)[t], (2, n_walkers))`` as the
    reference's walk does."""
    return uniform(split(keys, max_steps), (2, n_walkers))
