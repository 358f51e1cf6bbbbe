"""Core layers of the decoders and the encoder: norms, RoPE, attention
(prefill, non-causal and cross, decode), the SwiGLU and GELU MLPs and their
parameters.

The port of the JAX package's ``models/layers.py``.  The three functions
that package also wrote as Pallas kernels run through the port's kernels:
RMSNorm (``kernels.rmsnorm``), prefill attention, causal or not
(``kernels.flash_attention``) and single-token decode attention
(``kernels.decode_attention``, also over the encoder-decoder's static
cross-attention caches); each takes its plain PyTorch version for CPU
tensors.  LayerNorm has no kernel in the JAX package and stays plain.
Plain matrix products stay ``torch.matmul`` on weights kept in the JAX
package's ``(in, out)`` orientation.  Dtype policy as there:
storage and products in the model dtype, norms, RoPE angles and softmax in
float32.  On one device the reference's ``shard()`` constraints place
nothing (``distributed/sharding.py``), so the layers do not call it.

Over a process mesh (a model built with ``mesh=``: each module's
``placed`` names its ``sharding.Placement``) the projections are
tensor-parallel over the model axis, Megatron's way (``col``, ``row``,
``copy_to`` and ``reduce_from`` serve the MoE and Mamba layers too):
``wq``, ``wk``, ``wv``, ``mlp.wi`` and ``mlp.wg`` column-parallel behind
``collectives.copy_to`` (their gradient of the replicated input is
partial per rank), ``wo`` and ``mlp.wo`` row-parallel followed by
``collectives.reduce_from``; each weight's FSDP dim gathered over the data
axes first (``Placement.gathered``).  A rank holds query heads ``[r H/n,
(r+1) H/n)`` and KV heads ``[r K/n, ...)``, so each GQA group stays on its
rank; where ``n`` is a multiple of ``K`` the rank keeps the one KV head its
query heads read (gathered whole over the model axis if ``_fit`` split its
columns, replicated otherwise).  The sequence-sharded decode
(``seq_decode_attention``) attends every head over this rank's slice of
the cache through the decode kernel's partial mode and merges the slices'
partials in rank order; caches holding every position
(``head_decode_attention``) take its normal mode on the rank's heads.

Where the model axis does not divide a split a layer takes
(``fallback``), the layer is computed whole on every rank, as the
reference's GSPMD replicates such a dim: its weights are gathered from
their blocks over every axis (``Placement.whole``; the blocks may split a
head), and its ``copy_to``, ``reduce_from`` and head gathers are the
identity (``whole``, ``tp_group``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import P, block_index, gather_block
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_partials, merge_partials)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm


def padded_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def padded_experts(e: int, multiple: int = 16) -> int:
    return ((e + multiple - 1) // multiple) * multiple


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def new_param(shape, dtype, device,
              fill: Optional[float] = None) -> nn.Parameter:
    """A weight, uninitialised unless ``fill`` is given; it takes no
    gradient until ``Model.trainable()``."""
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


# ------------------------------------------------ float32 products
class _F32Product(torch.autograd.Function):
    """The float32 product of bfloat16 operands on the card, with its
    gradients as bfloat16 products of the cotangent rounded to bfloat16
    (float32 accumulation in the products)."""

    @staticmethod
    def forward(ctx, x2, head):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, head = ctx.saved_tensors
        g = g.to(x2.dtype)
        gx = g @ head.t() if ctx.needs_input_grad[0] else None
        gh = x2.t() @ g if ctx.needs_input_grad[1] else None
        return gx, gh


def f32_product(x2: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(T, D) @ (D, V) in float32 from model-dtype operands: a float32
    product of the model-dtype values, as the JAX package's
    ``preferred_element_type=float32`` gives."""
    if x2.device.type == "cpu" or x2.dtype == torch.float32:
        return x2.float() @ head.float()
    return _F32Product.apply(x2, head)


# ------------------------------------------------ tensor parallelism
def model_group(ctx):
    """(axis size n, this rank's coordinate r, its group or ``None``) of
    the model axis of a process context."""
    if ctx.model_axis is None:
        return 1, 0, None
    return (ctx.mesh.shape[ctx.model_axis], ctx.model_rank,
            ctx.mesh.group(ctx.model_axis))


def copy_to(x, group):
    return x if group is None else C.copy_to(x, group)


def reduce_from(x, group):
    return x if group is None else C.reduce_from(x, group)


def kv_heads(cfg: ModelConfig, n: int, r: int) -> Tuple[int, int]:
    """The KV heads ``[k0, k1)`` rank ``r`` of ``n`` on the model axis
    reads: its own ``K/n`` where ``n`` divides ``K``, else (``n`` a
    multiple of ``K``) the one its ``H/n`` query heads share."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    if K % n == 0:
        return r * K // n, (r + 1) * K // n
    G, Hl = H // K, H // n
    return r * Hl // G, ((r + 1) * Hl - 1) // G + 1


def fallback(cfg: ModelConfig, n: int) -> Dict[str, bool]:
    """The reference's divisibility fallback at a model axis of ``n``: for
    each kind of tensor-parallel layer, whether ``n`` fails to divide a
    split it takes, so that the layer is computed replicated over
    ``model`` (``whole``).  ``attn``: the heads, or the KV heads where they
    and ``n`` divide neither way; ``mlp``: ``d_ff``; ``experts``: the
    padded experts; ``shared``: the shared-expert width; ``mamba``: the
    Mamba heads or the state width (``in_proj_x`` splits whole heads,
    ``conv_b``/``conv_c`` the state columns).  The padded vocabulary needs
    no flag: its spec is replicated then, and the embedding, head and loss
    read the spec."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    E = padded_experts(cfg.num_experts) if cfg.num_experts else 0
    Fs = cfg.num_shared_experts * (cfg.d_ff_expert or cfg.d_ff)
    Hs = cfg.ssm_heads if cfg.ssm_state else 0
    return {"attn": bool(H % n or (K % n and n % K)),
            "mlp": bool(cfg.d_ff % n), "experts": bool(E % n),
            "shared": bool(Fs % n),
            "mamba": bool(Hs % n or cfg.ssm_state % n)}


def whole(p: nn.Module, attr: str) -> bool:
    """Whether the placed module ``p`` computes the layer that reads
    ``attr`` replicated over the model axis (the divisibility fallback:
    ``Model`` names those weights in ``p.whole``)."""
    return attr in getattr(p, "whole", ())


def _w(p: nn.Module, attr: str) -> torch.Tensor:
    """A placed weight with its FSDP dim gathered over the data axes; the
    weight of a layer computed whole, gathered over every axis."""
    place, prefix = p.placed
    name = f"{prefix}.{attr}"
    if whole(p, attr):
        return place.whole(name, getattr(p, attr))
    return place.gathered(name, getattr(p, attr), place.ctx.batch_axes)


def _kv_weight(p: nn.Module, attr: str, cfg: ModelConfig) -> torch.Tensor:
    """``wk``/``wv``/``bk``/``bv`` restricted to this rank's KV heads (last
    dim): its own block where the model axis splits whole heads; else
    gathered whole over every axis that splits it (the backward sums the
    ranks' partial gradients) or, replicated over the model axis, summed
    there by ``copy_to``; then the rank's heads' columns."""
    place, prefix = p.placed
    name = f"{prefix}.{attr}"
    n, r, group = model_group(place.ctx)
    if cfg.num_kv_heads % n == 0:
        return _w(p, attr)
    if place.specs[name][-1] is not None:
        full = place.gathered(name, getattr(p, attr))
    else:
        full = copy_to(_w(p, attr), group)
    hd = cfg.resolved_head_dim()
    k0, k1 = kv_heads(cfg, n, r)
    return full[..., k0 * hd:k1 * hd]


def tp_group(p: nn.Module, attr: str):
    """The model axis's group of the layer of a placed module that reads
    ``attr`` (``None`` unplaced, for a model axis of 1, or for a layer
    computed whole)."""
    placed = getattr(p, "placed", None)
    if placed is None or whole(p, attr):
        return None
    return model_group(placed[0].ctx)[2]


def weight(p: nn.Module, attr: str, cfg: Optional[ModelConfig] = None
           ) -> torch.Tensor:
    """``p.<attr>``; placed: its FSDP dim gathered over the data axes, and
    ``wk``/``wv``/``bk``/``bv`` restricted to this rank's KV heads; the
    whole tensor for a layer computed whole."""
    if getattr(p, "placed", None) is None:
        return getattr(p, attr)
    if attr in ("wk", "wv", "bk", "bv") and not whole(p, attr):
        return _kv_weight(p, attr, cfg)
    return _w(p, attr)


def linear(x: torch.Tensor, w: torch.Tensor, placed: bool) -> torch.Tensor:
    """``x (..., D) @ w``; ``placed``: a float32 product of the model-dtype
    operands rounded once, which accumulates as the one-process product of
    all the columns does (a model-dtype product of another width may take
    another kernel and another order)."""
    if not placed:
        return x @ w
    y = f32_product(x.reshape(-1, x.shape[-1]), w)
    return y.to(x.dtype).reshape(x.shape[:-1] + (-1,))


def col(p: nn.Module, x: torch.Tensor, attr: str,
        cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """``x (..., D) @ p.<attr>``; placed: this rank's columns
    (``linear``)."""
    return linear(x, weight(p, attr, cfg),
                  getattr(p, "placed", None) is not None)


def qkv_project(p: Attention, x: torch.Tensor, cfg: ModelConfig, rope
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,K,hd); qk_norm and RoPE
    applied (placed: this rank's H/n query and its KV heads, column-
    parallel behind ``copy_to``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    group = tp_group(p, "wq")
    x = copy_to(x, group)
    q = col(p, x, "wq", cfg)
    k = col(p, x, "wk", cfg)
    v = col(p, x, "wv", cfg)
    if cfg.qkv_bias:
        q, k, v = (q + weight(p, "bq", cfg), k + weight(p, "bk", cfg),
                   v + weight(p, "bv", cfg))
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if cfg.qk_norm:         # placed: replicated scales on this rank's heads
        q = rms_norm(q, copy_to(p.q_norm, group), cfg.norm_eps)
        k = rms_norm(k, copy_to(p.k_norm, group), cfg.norm_eps)
    return apply_rope(q, rope), apply_rope(k, rope), v


def all_kv_heads(p: Attention, k: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """Every KV head of a layer's new keys or values (B, S, K, hd) from
    each rank's (B, S, Kl, hd): gathered over the model axis, each head
    taken from the first rank that holds it (``k`` itself unplaced or for
    a layer computed whole)."""
    group = tp_group(p, "wk")
    if group is None:
        return k
    n = model_group(p.placed[0].ctx)[0]
    allk = C.gather_dim(k, group, 2)
    K, Kl = cfg.num_kv_heads, k.shape[2]
    first = {}
    for j in range(n):
        k0, _ = kv_heads(cfg, n, j)
        for i in range(Kl):
            first.setdefault(k0 + i, j * Kl + i)
    idx = [first[h] for h in range(K)]
    return allk if idx == list(range(n * Kl)) else allk[:, :, idx]


def all_heads(p: Attention, q: torch.Tensor) -> torch.Tensor:
    """Every query head (B, S, H, hd) from each rank's (B, S, H/n, hd)."""
    group = tp_group(p, "wq")
    return q if group is None else C.gather_dim(q, group, 2)


def seq_slice(ctx, seq_local: int) -> Tuple[int, int]:
    """(first position, count) of this rank's slice of a decode cache
    whose ``seq_local`` positions a rank are split over ``ctx.seq_axes``
    (row-major, so the slices lie in rank order)."""
    i, _ = block_index(tuple(ctx.seq_axes) or None, ctx.mesh)
    return i * seq_local, seq_local


def seq_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: int, ctx,
                         f32_scores: bool = True) -> torch.Tensor:
    """One token's attention over a cache whose positions are split over
    ``ctx.seq_axes`` of a process mesh: q (B, 1, H, hd) every head; the
    caches this rank's slice (B, K, Sl, hd) of positions ``[s Sl, (s+1)
    Sl)``; ``pos`` the position just written.  Each rank's slice gives
    its float32 partial (the decode kernel's partial mode, lengths
    clamped to the slice, 0 where it holds no valid position); the
    partials are gathered over the seq axes and merged in rank order.
    ``f32_scores=False``: each q.k rounded to the caches' dtype first.
    Returns (B, 1, H, hd) in ``q``'s dtype, the same on every rank."""
    B, _, H, hd = q.shape
    _, K, Sl, _ = k_cache.shape
    s0, _ = seq_slice(ctx, Sl)
    n_valid = min(max(int(pos) + 1 - s0, 0), Sl)
    lengths = torch.full((B * K,), n_valid, dtype=torch.int32,
                         device=q.device)
    o, lse = decode_attention_partials(q, k_cache.transpose(1, 2),
                                       v_cache.transpose(1, 2), lengths,
                                       f32_scores)
    packed = torch.cat([o.reshape(B, H * hd), lse.reshape(B, H)], dim=-1)
    axes = tuple(ctx.seq_axes)
    allp = gather_block(packed[None], P(axes or None), ctx.mesh)
    parts = [(a[:, :H * hd].reshape(B, 1, H, hd), a[:, H * hd:]
              .reshape(B, 1, H)) for a in allp]
    return merge_partials(parts, q.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Causal attention of a prompt over itself (query offset 0): q
    (B, S, H, hd), k/v (B, S, K, hd)."""
    return flash_attention(q, k, v, causal=True)


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention of every query over every key: q (B, Sq, H, hd),
    k/v (B, Skv, K, hd), Sq and Skv free (the encoder over its frames; the
    decoder's cross-attention of a prompt over the encoder output)."""
    return flash_attention(q, k, v, causal=False)


def decode_step_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor,
                          f32_scores: bool = True) -> torch.Tensor:
    """One token's attention over its caches: q (B, 1, H, hd), caches laid
    out (B, K, Smax, hd), ``lengths`` (B*K,) int32 the valid positions of
    each (batch, KV head) row (the one just written included);
    ``f32_scores=False``: each q.k rounded to the caches' dtype first."""
    return decode_attention(q, k_cache.transpose(1, 2),
                            v_cache.transpose(1, 2), lengths=lengths,
                            f32_scores=f32_scores)


def head_decode_attention(p: Attention, q: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          lengths: torch.Tensor, cfg: ModelConfig,
                          f32_scores: bool = True) -> torch.Tensor:
    """One token's attention over caches (B, K, S, hd) that hold every KV
    head and every position (the cross caches; the self caches where the
    seq axes do not divide their length), for ``p``'s query heads of this
    rank q (B, 1, Hl, hd): the decode kernel over the rank's KV heads (a
    strided view of the caches), ``lengths`` (B*K,) those of every KV
    head (every head unplaced or for a layer computed whole)."""
    if tp_group(p, "wq") is not None:
        n, r, _ = model_group(p.placed[0].ctx)
        k0, k1 = kv_heads(cfg, n, r)
        B, K = k_cache.shape[:2]
        k_cache, v_cache = k_cache[:, k0:k1], v_cache[:, k0:k1]
        lengths = lengths.reshape(B, K)[:, k0:k1].reshape(-1)
    return decode_step_attention(q, k_cache, v_cache, lengths, f32_scores)


def row(p: nn.Module, h: torch.Tensor, attr: str) -> torch.Tensor:
    """``h (..., F) @ p.<attr>``; placed: this rank's rows, summed over the
    model axis: float32 products of the model-dtype operands, added in
    float32 and rounded to the model dtype once, as the one-process
    product's float32 accumulation rounds once."""
    w = weight(p, attr)
    if getattr(p, "placed", None) is None:
        return h @ w
    y = f32_product(h.reshape(-1, h.shape[-1]), w)
    return reduce_from(y, tp_group(p, attr)).to(h.dtype).reshape(
        h.shape[:-1] + (-1,))


def attn_out(p: Attention, attn: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, D); placed: this rank's heads through its
    rows of ``wo``, summed over the model axis."""
    B, S, H, hd = attn.shape
    return row(p, attn.reshape(B, S, H * hd), "wo")


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
    """Placed: ``wi``/``wg`` column-parallel, ``wo`` row-parallel over the
    model axis."""
    x = copy_to(x, tp_group(p, "wi"))
    h = col(p, x, "wi")
    if cfg.act == "silu":
        h = F.silu(col(p, x, "wg")) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return row(p, h, "wo")
