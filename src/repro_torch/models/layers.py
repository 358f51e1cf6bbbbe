"""Core layers of the dense decoder: norms, RoPE, attention (prefill and
decode), the SwiGLU MLP and their parameters.

The port of the JAX package's ``models/layers.py``.  The three functions
that package also wrote as Pallas kernels run through the port's kernels:
RMSNorm (``kernels.rmsnorm``), causal prefill attention
(``kernels.flash_attention``) and single-token decode attention
(``kernels.decode_attention``); each takes its plain PyTorch version for
CPU tensors.  Plain matrix products stay ``torch.matmul`` on weights kept
in the JAX package's ``(in, out)`` orientation.  Dtype policy as there:
storage and products in the model dtype, norms, RoPE angles and softmax in
float32.  The port runs on one device, so there is no ``shard()``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm


def padded_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def new_param(shape, dtype, device,
              fill: Optional[float] = None) -> nn.Parameter:
    """An inference weight, uninitialised unless ``fill`` is given."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return rmsnorm(x, scale, eps=eps)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


class Norm(nn.Module):
    """RMSNorm scale (float32), with a bias for LayerNorm."""

    def __init__(self, dim: int, device, with_bias: bool = False):
        super().__init__()
        self.scale = new_param((dim,), torch.float32, device, 1.0)
        self.bias = new_param((dim,), torch.float32, device, 0.0) \
            if with_bias else None


def apply_norm(x: torch.Tensor, p: Norm, cfg: ModelConfig) -> torch.Tensor:
    if p.bias is not None:
        return layer_norm(x, p.scale, p.bias, cfg.norm_eps)
    return rms_norm(x, p.scale, cfg.norm_eps)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (hd/2,)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """cos / sin of the angles at ``positions`` (S,), float32, shaped
    (S, 1, hd/2) to broadcast over heads; ``None`` when RoPE is off.  One
    pair serves every layer of a forward pass."""
    if theta <= 0:
        return None
    angles = positions.float()[:, None] * rope_freqs(head_dim, theta,
                                                     positions.device)
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """x: (B, S, H, hd); the split-halves rotation in float32."""
    if rope is None:
        return x
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
class Attention(nn.Module):
    """Projections of one attention layer, ``(in, out)`` weights."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D, hd = cfg.d_model, cfg.resolved_head_dim()
        H, K = cfg.num_heads, cfg.num_kv_heads
        self.wq = new_param((D, H * hd), dtype, device)
        self.wk = new_param((D, K * hd), dtype, device)
        self.wv = new_param((D, K * hd), dtype, device)
        self.wo = new_param((H * hd, D), dtype, device)
        if cfg.qkv_bias:
            self.bq = new_param((H * hd,), dtype, device, 0.0)
            self.bk = new_param((K * hd,), dtype, device, 0.0)
            self.bv = new_param((K * hd,), dtype, device, 0.0)
        if cfg.qk_norm:
            self.q_norm = new_param((hd,), torch.float32, device, 1.0)
            self.k_norm = new_param((hd,), torch.float32, device, 1.0)
        # std of each weight drawn at init (the JAX package's scales)
        s = 1.0 / math.sqrt(D)
        self.init_std = {"wq": s, "wk": s, "wv": s,
                         "wo": 1.0 / math.sqrt(H * hd)}


def qkv_project(p: Attention, x: torch.Tensor, cfg: ModelConfig, rope
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,K,hd); qk_norm and RoPE
    applied."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    H, K = cfg.num_heads, cfg.num_kv_heads
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return apply_rope(q, rope), apply_rope(k, rope), v


def prefill_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Causal attention of a prompt over itself (query offset 0): q
    (B, S, H, hd), k/v (B, S, K, hd)."""
    return flash_attention(q, k, v, causal=True)


def decode_step_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """One token's attention over its caches: q (B, 1, H, hd), caches laid
    out (B, K, Smax, hd), ``lengths`` (B*K,) int32 the valid positions of
    each (batch, KV head) row (the one just written included)."""
    return decode_attention(q, k_cache.transpose(1, 2),
                            v_cache.transpose(1, 2), lengths=lengths)


def attn_out(p: Attention, attn: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = attn.shape
    return attn.reshape(B, S, H * hd) @ p.wo


# ---------------------------------------------------------------- MLP
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, d_ff: int, dtype, device):
        super().__init__()
        D = cfg.d_model
        self.wi = new_param((D, d_ff), dtype, device)
        self.wo = new_param((d_ff, D), dtype, device)
        self.wg = new_param((D, d_ff), dtype, device) if cfg.act == "silu" \
            else None
        self.init_std = {"wi": 1.0 / math.sqrt(D),
                         "wo": 1.0 / math.sqrt(d_ff)}
        if self.wg is not None:
            self.init_std["wg"] = 1.0 / math.sqrt(D)


def mlp_apply(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = x @ p.wi
    if cfg.act == "silu":
        h = F.silu(x @ p.wg) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p.wo
