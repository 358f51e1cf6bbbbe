"""Mamba2 block (state-space duality, arXiv:2405.21060).

The port of the JAX package's ``models/mamba.py``.  A prefill or a
training pass runs the chunked SSD scan through ``kernels.ssd_scan`` (the
kernel on the card, its plain chunked version on the CPU; the JAX model
computes the same function with ``ssd_chunked`` in XLA) and the gated
RMSNorm through ``kernels.rmsnorm``.  A decode step is one state update
in plain tensor ops, as in the JAX package.

Weights of one layer, ``(in, out)`` as there:
  in_proj_{z,x}: (D, d_inner)       gate / value streams
  in_proj_{b,c}: (D, N)             input / output SSM projections (G = 1)
  in_proj_dt:    (D, H)             per-head timestep
  conv_{x,b,c}:  (k, dim)           depthwise causal conv weights
  dt_bias, a_log, d: (H,)           timestep bias, decay, skip (float32)
  norm_scale:    (d_inner,)         gated RMSNorm (float32)
  out_proj:      (d_inner, D)

The decode caches of one layer are ``ssm`` (B, H, N, P) float32 and
``conv_{x,b,c}`` (B, k - 1, dim): the last k - 1 activated inputs of each
convolution, before the convolution.  ``mamba_decode`` updates them in
place.

Over a process mesh (a model built with ``mesh=``: ``placed`` names the
layer's ``sharding.Placement``) the block is tensor-parallel over the
model axis of ``n`` ranks, each holding ``H / n`` heads: ``in_proj_{z,x}``
and ``in_proj_dt`` column-parallel, ``dt_bias``, ``a_log``, ``d``,
``conv_x`` and ``norm_scale`` split by heads or channels, ``out_proj``
row-parallel, every FSDP dim gathered over the data axes.
``in_proj_{b,c}`` are replicated over ``model``, but ``conv_{b,c}`` split
the state columns (the reference's specs): a rank projects and convolves
its ``N / n`` columns (the conv is depthwise, so exactly) and gathers b
and c over ``model`` for the scan, which every head reads whole.  The
scan runs on the rank's heads.  The gated RMSNorm normalises over all of
``d_inner``: each row's float32 sum of squares is summed over ``model``
(plain PyTorch; the RMSNorm kernel where the model axis is 1).  The
caches hold the rank's heads of ``ssm``, its channels of ``conv_x`` and
its state columns of ``conv_{b,c}``.  Where the model axis does not
divide the heads or the state width, the block is computed whole on
every rank from its weights gathered whole (``layers.fallback``); its
caches keep the blocks ``cache_shardings`` gives them (``conv_x`` may
still split ``d_inner``), gathered whole for the step and written back.
On an unplaced block every collective is the identity, which keeps the
one-process bits.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import layers as L
from repro_torch.models.layers import new_param, rms_norm

Cache = Dict[str, torch.Tensor]


def _dt_bias(shape, generator: torch.Generator, device) -> torch.Tensor:
    """softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1], as the
    reference initialises ``dt_bias``."""
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
    return torch.log(torch.expm1(torch.exp(u)))


def _zeros(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        k = cfg.ssm_conv
        f32 = torch.float32
        self.in_proj_z = new_param((D, din), dtype, device)
        self.in_proj_x = new_param((D, din), dtype, device)
        self.in_proj_b = new_param((D, N), dtype, device)
        self.in_proj_c = new_param((D, N), dtype, device)
        self.in_proj_dt = new_param((D, H), dtype, device)
        self.conv_x = new_param((k, din), dtype, device)
        self.conv_b = new_param((k, N), dtype, device)
        self.conv_c = new_param((k, N), dtype, device)
        self.dt_bias = new_param((H,), f32, device)
        self.a_log = new_param((H,), f32, device, 0.0)
        self.d = new_param((H,), f32, device, 1.0)
        self.norm_scale = new_param((din,), f32, device, 1.0)
        self.out_proj = new_param((din, D), dtype, device)
        # std of each weight drawn at init, and the leaves drawn otherwise
        # (the JAX package's ``mamba_params``); ``d`` and ``norm_scale``
        # are ones
        s, sk = 1.0 / math.sqrt(D), 1.0 / math.sqrt(k)
        self.init_std = {"in_proj_z": s, "in_proj_x": s, "in_proj_b": s,
                         "in_proj_c": s, "in_proj_dt": s, "conv_x": sk,
                         "conv_b": sk, "conv_c": sk,
                         "out_proj": 1.0 / math.sqrt(din)}
        self.init_fn = {"dt_bias": _dt_bias, "a_log": _zeros}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) for every x (``F.softplus``
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as the reference's k shifted adds (not
    ``F.conv1d``, which cuDNN may run in TF32 and sums in another order).
    x: (B, S, C), w: (k, C)."""
    k = w.shape[0]
    out = x * w[k - 1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i, :]
        out = out + shifted * w[k - 1 - i]
    return out


def _conv_step(state: torch.Tensor, xt: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """One decode step.  state: (B, k - 1, C) past inputs, shifted in place
    to hold ``xt`` last; xt: (B, C).  Returns the conv output (B, C): a
    float32 sum over the window, in xt's dtype."""
    window = torch.cat([state, xt[:, None, :]], dim=1)           # (B, k, C)
    out = (window.float() * w.float()).sum(dim=1).to(xt.dtype)
    state.copy_(window[:, 1:, :])
    return out


def ssd_step(state: torch.Tensor, xt: torch.Tensor, dt: torch.Tensor,
             A: torch.Tensor, Bt: torch.Tensor, Ct: torch.Tensor
             ) -> torch.Tensor:
    """One decode token, the state updated in place.  state: (B, H, N, P)
    float32; xt: (B, H, P); dt: (B, H); Bt / Ct: (B, N).  Returns y
    (B, H, P) in xt's dtype."""
    dA = torch.exp(dt * A[None, :])                               # (B, H)
    upd = torch.einsum("bn,bhp->bhnp", Bt.float(),
                       (xt * dt[..., None]).float())
    state.copy_(state * dA[:, :, None, None] + upd)
    y = torch.einsum("bn,bhnp->bhp", Ct.float(), state)
    return y.to(xt.dtype)


def _window(a: torch.Tensor, k: int) -> torch.Tensor:
    """The last k - 1 rows of a (B, S, C), zero rows first where S < k - 1
    (the causal conv's zero padding)."""
    if a.shape[1] < k - 1:
        a = F.pad(a, (0, 0, k - 1 - a.shape[1], 0))
    return a[:, a.shape[1] - (k - 1):, :]


def _tp(p: Mamba):
    """(model axis size n, this rank's coordinate, its group) of a placed
    block; (1, 0, None) unplaced or computed whole."""
    if L.tp_group(p, "in_proj_x") is None:
        return 1, 0, None
    return L.model_group(p.placed[0].ctx)


# the dim of each of a layer's caches the model axis may split, and the
# config's whole size of it
_CACHE_SPLIT = {"ssm": (1, "ssm_heads"), "conv_x": (2, "d_inner"),
                "conv_b": (2, "ssm_state"), "conv_c": (2, "ssm_state")}


def _whole_caches(p: Mamba, cache: Optional[Cache], cfg: ModelConfig):
    """A block computed whole reads and writes whole caches: each of its
    caches that ``cache_shardings`` splits over ``model`` gathered whole,
    and a function that writes them back into the blocks after the step
    (``cache`` itself and a no-op otherwise)."""
    if cache is None or getattr(p, "placed", None) is None \
            or not L.whole(p, "in_proj_x"):
        return cache, lambda: None
    _, r, group = L.model_group(p.placed[0].ctx)
    full = {}
    for name, t in cache.items():
        dim, size = _CACHE_SPLIT[name]
        full[name] = (t if t.shape[dim] == getattr(cfg, size)
                      else C.gather_dim(t, group, dim))

    def put_back():
        for name, t in cache.items():
            if full[name] is not t:
                dim = _CACHE_SPLIT[name][0]
                t.copy_(full[name].narrow(dim, r * t.shape[dim],
                                          t.shape[dim]))
    return full, put_back


def _state_proj(p: Mamba, u: torch.Tensor, attr: str) -> torch.Tensor:
    """silu(u @ in_proj_b|c) on this rank's state columns (placed: of the
    weight replicated over ``model``, whose gradient is summed there)."""
    n, r, group = _tp(p)
    w = L.copy_to(L.weight(p, attr), group)
    Nl = w.shape[1] // n
    return F.silu(L.linear(u, w[:, r * Nl:(r + 1) * Nl],
                           getattr(p, "placed", None) is not None))


def _all_columns(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's state columns (last dim) of b or c, in rank order."""
    return t if group is None else C.gather_dim(t, group, -1)


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               cfg: ModelConfig, n: int, group) -> torch.Tensor:
    """rms_norm(y * silu(z)) over all of ``d_inner``; split over a model
    axis of ``n > 1``, each row's float32 sum of squares summed over it
    (forward and backward) before the local scaling."""
    g = y * F.silu(z)
    if n == 1:
        return rms_norm(g, scale, cfg.norm_eps)
    gf = g.float()
    ss = C.copy_to(C.reduce_from(torch.sum(gf * gf, dim=-1, keepdim=True),
                                 group), group)
    var = ss / cfg.d_inner
    return (gf * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(g.dtype)


def mamba_apply(p: Mamba, u: torch.Tensor, cfg: ModelConfig,
                cache: Optional[Cache] = None) -> torch.Tensor:
    """Full sequence (train or prefill).  u: (B, S, D) -> (B, S, D); a
    prefill writes the decode caches (``ssm``, ``conv_{x,b,c}``) into
    ``cache`` in place (training passes none).  Placed: this rank's heads
    (the module docstring)."""
    Bsz, S, _ = u.shape
    n, _, group = _tp(p)
    H, P = cfg.ssm_heads // n, cfg.ssm_head_dim
    cache, put_back = _whole_caches(p, cache, cfg)
    u = L.copy_to(u, group)
    z = L.col(p, u, "in_proj_z")
    xa = F.silu(L.col(p, u, "in_proj_x"))
    ba = _state_proj(p, u, "in_proj_b")
    ca = _state_proj(p, u, "in_proj_c")
    dt = L.col(p, u, "in_proj_dt").float()
    x = _causal_conv(xa, L.weight(p, "conv_x")).reshape(Bsz, S, H, P)
    b = _all_columns(_causal_conv(ba, L.weight(p, "conv_b")), group)
    c = _all_columns(_causal_conv(ca, L.weight(p, "conv_c")), group)
    dt = softplus(dt + L.weight(p, "dt_bias")[None, None, :])
    A = -torch.exp(L.weight(p, "a_log"))
    y, final = ssd_scan(x, dt, A, b, c, chunk=cfg.ssm_chunk)
    y = y + x * L.weight(p, "d")[None, None, :, None].to(x.dtype)
    y = y.reshape(Bsz, S, H * P)
    y = gated_norm(y, z, L.weight(p, "norm_scale"), cfg, n, group)
    if cache is not None:
        k = cfg.ssm_conv
        cache["ssm"].copy_(final)
        cache["conv_x"].copy_(_window(xa, k))
        cache["conv_b"].copy_(_window(ba, k))
        cache["conv_c"].copy_(_window(ca, k))
        put_back()
    return L.row(p, y, "out_proj")


def mamba_decode(p: Mamba, cache: Cache, u: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """One token.  u: (B, 1, D) -> (B, 1, D); ``cache`` updated in
    place (placed: this rank's heads, channels and state columns)."""
    Bsz = u.shape[0]
    n, _, group = _tp(p)
    H, P = cfg.ssm_heads // n, cfg.ssm_head_dim
    cache, put_back = _whole_caches(p, cache, cfg)
    ut = L.copy_to(u[:, 0, :], group)
    z = L.col(p, ut, "in_proj_z")
    x = F.silu(L.col(p, ut, "in_proj_x"))
    b = _state_proj(p, ut, "in_proj_b")
    c = _state_proj(p, ut, "in_proj_c")
    dt = L.col(p, ut, "in_proj_dt").float()
    x = _conv_step(cache["conv_x"], x, L.weight(p, "conv_x"))
    b = _all_columns(_conv_step(cache["conv_b"], b, L.weight(p, "conv_b")),
                     group)
    c = _all_columns(_conv_step(cache["conv_c"], c, L.weight(p, "conv_c")),
                     group)
    dt = softplus(dt + L.weight(p, "dt_bias")[None, :])
    A = -torch.exp(L.weight(p, "a_log"))
    xh = x.reshape(Bsz, H, P)
    y = ssd_step(cache["ssm"], xh, dt, A, b, c)
    y = y + xh * L.weight(p, "d")[None, :, None].to(xh.dtype)
    y = y.reshape(Bsz, H * P)
    y = gated_norm(y, z, L.weight(p, "norm_scale"), cfg, n, group)
    put_back()
    return L.row(p, y, "out_proj")[:, None, :]
