"""Encoder-decoder backbone (whisper-large-v3).

The port of the JAX package's ``models/encdec.py``.  The conv/mel frontend
is a stub there and here: the model consumes precomputed frame embeddings
(B, enc_frames, d_model).  Encoder layer: LayerNorm, non-causal
self-attention, LayerNorm, GELU MLP.  Decoder layer: causal
self-attention, cross-attention over the encoder output, GELU MLP, each
behind a LayerNorm with bias; learned absolute positions on the decoder
(added by the caller, ``transformer.add_positions``), no RoPE.  Layers are
``nn.Module``s in ``nn.ModuleList``s, port layer ``i`` being index ``i`` of
the JAX package's stacked ``layers/enc`` or ``layers/dec`` leaves.

Attention runs through the port's kernels: the encoder and the prompt's
cross-attention through the prefill kernel with ``causal=False`` (Sq != Skv
for the cross product), the decoder's self-attention through it causal in
prefill and through the decode kernel in decode, and a decode step's
cross-attention through the decode kernel over the static cross caches.

Caches: ``k``/``v`` ``(n, B, K, S, hd)`` of the decoder's self-attention,
written at prefill and at each decoded position, and ``xk``/``xv``
``(n, B, K, enc_frames, hd)``, the cross-attention keys and values of the
encoder output, written once at prefill and only read by decode.

Over a process mesh (a model built with ``mesh=``) the encoder's and the
decoder's attention and MLPs are tensor-parallel over whole heads and
columns (``layers.py``; the divisibility fallback computes a layer whole
where the model axis does not divide its heads or width).  The self
caches hold this rank's slice of the positions (``transformer.
self_attention``), the cross caches every KV head of this rank's rows,
replicated over ``model`` (the reference's ``cache_shardings``), so a
decode step's cross-attention runs the decode kernel on this rank's query
heads and their KV heads.  LayerNorm stays plain: the RMSNorm kernel is
RMSNorm only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (Caches, remat_kwargs, remat_on,
                                            self_attention)

CROSS_CACHES = ("xk", "xv")


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D = cfg.d_model
        self.attn = L.Attention(cfg, dtype, device)
        self.attn_norm = L.Norm(D, device, with_bias=True)
        self.mlp = L.MLP(cfg, cfg.d_ff, dtype, device)
        self.mlp_norm = L.Norm(D, device, with_bias=True)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D = cfg.d_model
        self.self_attn = L.Attention(cfg, dtype, device)
        self.self_norm = L.Norm(D, device, with_bias=True)
        self.cross_attn = L.Attention(cfg, dtype, device)
        self.cross_norm = L.Norm(D, device, with_bias=True)
        self.mlp = L.MLP(cfg, cfg.d_ff, dtype, device)
        self.mlp_norm = L.Norm(D, device, with_bias=True)


def build_encoder(cfg: ModelConfig, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(EncoderLayer(cfg, dtype, device)
                         for _ in range(cfg.enc_layers))


def build_decoder(cfg: ModelConfig, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(DecoderLayer(cfg, dtype, device)
                         for _ in range(cfg.num_layers))


def run_encoder(layers: nn.ModuleList, final_norm: L.Norm,
                frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings in the model dtype -> encoder
    output (B, S_enc, D), after the final LayerNorm."""
    x = frames
    for lp in layers:
        h = L.apply_norm(x, lp.attn_norm, cfg)
        q, k, v = L.qkv_project(lp.attn, h, cfg, None)
        x = x + L.attn_out(lp.attn, L.full_attention(q, k, v))
        h = L.apply_norm(x, lp.mlp_norm, cfg)
        x = x + L.mlp_apply(lp.mlp, h, cfg)
    return L.apply_norm(x, final_norm, cfg)


def cross_kv(p: L.Attention, enc_out: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention keys and values of the encoder output, (B, S_enc,
    K, hd) each, with ``bk``/``bv`` when the config has QKV biases
    (placed: this rank's KV heads, column-parallel behind ``copy_to``)."""
    B, S, _ = enc_out.shape
    hd = cfg.resolved_head_dim()
    enc_out = L.copy_to(enc_out, L.tp_group(p, "wk"))
    k = L.col(p, enc_out, "wk", cfg)
    v = L.col(p, enc_out, "wv", cfg)
    if cfg.qkv_bias:
        k, v = k + L.weight(p, "bk", cfg), v + L.weight(p, "bv", cfg)
    return k.reshape(B, S, -1, hd), v.reshape(B, S, -1, hd)


def cross_q(p: L.Attention, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """The cross-attention queries (B, S, H, hd): no ``bq``, as in the JAX
    package (placed: this rank's heads)."""
    B, S, _ = x.shape
    x = L.copy_to(x, L.tp_group(p, "wq"))
    return L.col(p, x, "wq", cfg).reshape(B, S, -1,
                                          cfg.resolved_head_dim())


def _decoder_layer(lp: DecoderLayer, x: torch.Tensor,
                   enc_out: Optional[torch.Tensor], cfg: ModelConfig,
                   mode: str, caches: Optional[Caches] = None, i: int = 0,
                   pos: Optional[int] = None, lengths=None) -> torch.Tensor:
    """Decoder layer ``i``.  ``caches``: every layer's ``k``/``v``/``xk``/
    ``xv`` (none in ``train``), this layer's written at ``prefill``;
    ``decode`` writes position ``pos`` and attends over ``lengths`` =
    (self, cross).  Placed: the self-attention as the decoder-only
    families' (``transformer.self_attention``); the cross caches hold
    every KV head of this rank's rows, and a decode step attends this
    rank's query heads over them (``layers.head_decode_attention``)."""
    decode = mode == "decode"
    h = L.apply_norm(x, lp.self_norm, cfg)
    # float32 decode scores whatever decode_f32_scores says, as the
    # reference's decoder calls decode_attention_xla
    x = x + self_attention(lp.self_attn, h, cfg, mode, None, caches, i, pos,
                           lengths[0] if decode else None, f32_scores=True)

    h = L.apply_norm(x, lp.cross_norm, cfg)
    p = lp.cross_attn
    cq = cross_q(p, h, cfg)
    if decode:
        ca = L.head_decode_attention(p, cq, caches["xk"][i],
                                     caches["xv"][i], lengths[1], cfg)
    else:
        xk, xv = cross_kv(p, enc_out, cfg)
        if caches is not None:
            for n, t in zip(CROSS_CACHES, (xk, xv)):
                caches[n][i].copy_(L.all_kv_heads(p, t, cfg).transpose(1, 2))
        ca = L.full_attention(cq, xk, xv)
    x = x + L.attn_out(p, ca)

    h = L.apply_norm(x, lp.mlp_norm, cfg)
    return x + L.mlp_apply(lp.mlp, h, cfg)


def run_decoder(layers: nn.ModuleList, x: torch.Tensor,
                enc_out: Optional[torch.Tensor], cfg: ModelConfig, mode: str,
                caches: Optional[Caches] = None,
                pos: Optional[int] = None) -> torch.Tensor:
    """x: (B, S_dec, D) embedded tokens (positions added by the caller)
    through every decoder layer.  ``train``: no caches, each layer under
    ``torch.utils.checkpoint`` with ``cfg.remat`` and its policy (the
    reference's ``jax.checkpoint`` of its decoder body; the encoder has
    none);
    ``prefill``: writes the self caches of every position and the cross
    caches from ``enc_out``; ``decode``: one token at position ``pos``,
    written into the self caches, the cross caches only read."""
    if mode == "train":
        remat = remat_on(cfg)
        policy = remat_kwargs(cfg) if remat else {}
        for lp in layers:
            x = (checkpoint(_decoder_layer, lp, x, enc_out, cfg, mode,
                            use_reentrant=False, **policy) if remat
                 else _decoder_layer(lp, x, enc_out, cfg, mode))
        return x
    lengths = None
    if mode == "decode":    # every (batch, KV head) row, once per step
        rows = x.shape[0] * cfg.num_kv_heads
        lengths = (torch.full((rows,), pos + 1, dtype=torch.int32,
                              device=x.device),
                   torch.full((rows,), caches["xk"].shape[3],
                              dtype=torch.int32, device=x.device))
    for i, lp in enumerate(layers):
        x = _decoder_layer(lp, x, enc_out, cfg, mode, caches, i, pos, lengths)
    return x
