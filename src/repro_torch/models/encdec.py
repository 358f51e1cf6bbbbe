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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import Caches, remat_kwargs, remat_on

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
    K, hd) each, with ``bk``/``bv`` when the config has QKV biases."""
    B, S, _ = enc_out.shape
    hd, K = cfg.resolved_head_dim(), cfg.num_kv_heads
    k = enc_out @ p.wk
    v = enc_out @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return k.reshape(B, S, K, hd), v.reshape(B, S, K, hd)


def cross_q(p: L.Attention, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """The cross-attention queries (B, S, H, hd): no ``bq``, as in the JAX
    package."""
    B, S, _ = x.shape
    return (x @ p.wq).reshape(B, S, cfg.num_heads, cfg.resolved_head_dim())


def _decoder_layer(lp: DecoderLayer, x: torch.Tensor,
                   enc_out: Optional[torch.Tensor], cfg: ModelConfig,
                   mode: str, cache: Optional[Caches] = None,
                   pos: Optional[int] = None, lengths=None) -> torch.Tensor:
    """One decoder layer.  ``cache``: this layer's ``k``/``v``/``xk``/
    ``xv`` (none in ``train``), written at ``prefill``; ``decode`` writes
    position ``pos`` and attends over ``lengths`` = (self, cross)."""
    decode = mode == "decode"
    h = L.apply_norm(x, lp.self_norm, cfg)
    q, k, v = L.qkv_project(lp.self_attn, h, cfg, None)
    if decode:
        cache["k"][:, :, pos] = k[:, 0]
        cache["v"][:, :, pos] = v[:, 0]
        a = L.decode_step_attention(q, cache["k"], cache["v"], lengths[0])
    else:
        a = L.prefill_attention(q, k, v)
        xk, xv = cross_kv(lp.cross_attn, enc_out, cfg)
        if cache is not None:
            for n, t in zip(("k", "v") + CROSS_CACHES, (k, v, xk, xv)):
                cache[n].copy_(t.transpose(1, 2))
    x = x + L.attn_out(lp.self_attn, a)

    h = L.apply_norm(x, lp.cross_norm, cfg)
    cq = cross_q(lp.cross_attn, h, cfg)
    if decode:
        ca = L.cross_decode_attention(cq, cache["xk"], cache["xv"],
                                      lengths[1])
    else:
        ca = L.full_attention(cq, xk, xv)
    x = x + L.attn_out(lp.cross_attn, ca)

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
        cache = {n: caches[n][i] for n in ("k", "v") + CROSS_CACHES}
        x = _decoder_layer(lp, x, enc_out, cfg, mode, cache, pos, lengths)
    return x
