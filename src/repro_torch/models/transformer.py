"""The decoder stack of the dense family, its embedding and unembedding.

The port of the JAX package's ``models/transformer.py`` for the ``dense``
plan: decoder layers are ``nn.Module``s in an ``nn.ModuleList`` and the JAX
``lax.scan`` over stacked weights is a loop.  Modes: ``prefill`` (returns
caches) and ``decode`` (one token, writes its keys and values into the
caches in place).  The other families raise ``NotImplementedError``.

Caches are ``{"k": (L, B, K, S, hd), "v": ...}`` in the model dtype: laid out
per KV head so the decode-attention kernel reads each head's positions
contiguously, with no per-step transpose.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

Caches = Dict[str, torch.Tensor]

# the ROADMAP item that ports each family the port does not run yet
FAMILY_ITEMS = {"moe": "item 14", "hybrid": "item 15", "ssm": "item 15",
                "encdec": "item 16", "vlm": "item 16"}


def unported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"model family {family!r} is not ported yet (ROADMAP.md, modules to "
        f"port, {FAMILY_ITEMS[family]}); the port serves the dense family")


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) pattern for one period: the dense family only."""
    if cfg.family in ("moe", "hybrid", "ssm"):
        raise unported(cfg.family)
    return [("attn", "dense")]


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        gelu = cfg.act == "gelu"
        self.mixer_norm = L.Norm(cfg.d_model, device, with_bias=gelu)
        self.attn = L.Attention(cfg, dtype, device)
        self.ffn_norm = L.Norm(cfg.d_model, device, with_bias=gelu)
        self.mlp = L.MLP(cfg, cfg.d_ff, dtype, device)

    def run(self, x: torch.Tensor, cfg: ModelConfig, mode: str, rope,
            k_cache: torch.Tensor, v_cache: torch.Tensor,
            pos: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``prefill``: writes k/v of every position into the caches (B, K,
        S, hd); ``decode``: writes position ``pos`` and attends over the
        first ``lengths`` positions."""
        h = L.apply_norm(x, self.mixer_norm, cfg)
        q, k, v = L.qkv_project(self.attn, h, cfg, rope)
        if mode == "decode":
            k_cache[:, :, pos] = k[:, 0]
            v_cache[:, :, pos] = v[:, 0]
            a = L.decode_step_attention(q, k_cache, v_cache, lengths)
        else:
            a = L.prefill_attention(q, k, v)
            k_cache.copy_(k.transpose(1, 2))
            v_cache.copy_(v.transpose(1, 2))
        x = x + L.attn_out(self.attn, a)
        h = L.apply_norm(x, self.ffn_norm, cfg)
        return x + L.mlp_apply(self.mlp, h, cfg)


def run_stack(layers: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
              mode: str, positions: torch.Tensor, caches: Caches,
              pos: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, D) through every layer; caches written in place."""
    rope = L.rope_tables(positions, cfg.resolved_head_dim(), cfg.rope_theta)
    lengths = None
    if mode == "decode":        # every (batch, KV head) row, once per step
        lengths = torch.full((x.shape[0] * cfg.num_kv_heads,), pos + 1,
                             dtype=torch.int32, device=x.device)
    for i, layer in enumerate(layers):
        x = layer.run(x, cfg, mode, rope, caches["k"][i], caches["v"][i],
                      pos, lengths)
    return x


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(final_norm: L.Norm, head: torch.Tensor, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Float32 logits (B, S, V) for a few positions, from model-dtype
    operands: a float32 product of the model-dtype values, as the JAX
    package's ``preferred_element_type=float32`` gives (a bfloat16 product
    would round the logits and tie their argmax over a large vocabulary).
    ``head`` is (D, V)."""
    x = L.apply_norm(x, final_norm, cfg)
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    if x.device.type == "cpu" or x.dtype == torch.float32:
        logits = x2.float() @ head.float()
    else:
        logits = torch.mm(x2, head, out_dtype=torch.float32)
    logits = logits.reshape(B, S, -1)
    V = L.padded_vocab(cfg.vocab_size)
    if V != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits
