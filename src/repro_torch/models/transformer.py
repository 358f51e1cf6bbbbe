"""The decoder stack of the dense, MoE, SSM, hybrid and VLM families, its
embedding, learned positions and unembedding.

The port of the JAX package's ``models/transformer.py``.  A layer's mixer
is attention or a Mamba2 block and its FFN none, a dense MLP or an MoE
layer, after the family's plan (one period: ``dense``, ``vlm`` and ``moe``
one attention layer, ``ssm`` one Mamba layer, ``hybrid`` ``attn_every``
layers, attention first).  Decoder layers are ``nn.Module``s in an
``nn.ModuleList``, period after period: port layer ``j`` is period
``j // len(plan)``, sub-layer ``j % len(plan)`` of the JAX tree, whose
``lax.scan`` over stacked weights is a loop here.  Modes: ``train`` (no
caches; with ``cfg.remat`` each period recomputed in the backward, as the
reference's ``jax.checkpoint`` of its scan body, keeping what
``cfg.remat_policy`` saves), ``prefill`` (writes the
caches) and ``decode`` (one token, updates the caches in place).  The
encoder-decoder family's stacks are ``models/encdec.py``.  ``lm_loss`` is
the chunked cross-entropy of the training loss.

Caches are a dict by kind, each stacked over the layers of that kind:
``k``/``v`` ``(n_attn, B, K, S, hd)`` in the model dtype, laid out per KV
head so the decode-attention kernel reads each head's positions
contiguously; ``ssm`` ``(n_mamba, B, H, N, P)`` float32 and ``conv_x``/
``conv_b``/``conv_c`` ``(n_mamba, B, k - 1, dim)`` in the model dtype.
"""
from __future__ import annotations

import contextlib
from functools import partial
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import current_ctx, use_shard_ctx
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as X

Caches = Dict[str, torch.Tensor]

ATTN_CACHES = ("k", "v")
MAMBA_CACHES = ("ssm", "conv_x", "conv_b", "conv_c")


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) pattern for one period (the encoder-decoder family's
    decoder layers are attention and a dense MLP too, with a
    cross-attention between them: ``models/encdec.py``)."""
    if cfg.family == "encdec" and cfg.enc_layers <= 0:
        raise ValueError(f"{cfg.name}: the encdec family needs "
                         f"enc_layers > 0, got {cfg.enc_layers}")
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_state <= 0:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs "
                         f"ssm_state > 0, got {cfg.ssm_state}")
    if cfg.family == "ssm":
        return [("mamba", "none")]
    if cfg.family == "hybrid":
        if cfg.attn_every <= 0:
            raise ValueError(f"{cfg.name}: the hybrid family needs "
                             f"attn_every > 0, got {cfg.attn_every}")
        plan = []
        for i in range(cfg.attn_every):
            mixer = "attn" if i % cfg.attn_every == 0 else "mamba"
            moe = (i % cfg.moe_every == cfg.moe_every - 1) and cfg.num_experts
            plan.append((mixer, "moe" if moe else "dense"))
        return plan
    if cfg.family == "moe":
        if cfg.num_experts <= 0:
            raise ValueError(f"{cfg.name}: the moe family needs "
                             f"num_experts > 0, got {cfg.num_experts}")
        return [("attn", "moe")]
    return [("attn", "dense")]


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer, period after period."""
    plan = layer_plan(cfg)
    if cfg.num_layers % len(plan):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole "
                         f"periods of {len(plan)}")
    return [plan[j % len(plan)] for j in range(cfg.num_layers)]


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: Tuple[str, str],
                 cache_index: int, dtype, device,
                 experts: Optional[slice] = None):
        super().__init__()
        gelu = cfg.act == "gelu"
        self.mixer, self.ffn = kind
        # this layer's index in the caches of its mixer's kind
        self.cache_index = cache_index
        self.mixer_norm = L.Norm(cfg.d_model, device, with_bias=gelu)
        if self.mixer == "attn":
            self.attn = L.Attention(cfg, dtype, device)
        else:
            self.mamba = M.Mamba(cfg, dtype, device)
        if self.ffn != "none":
            self.ffn_norm = L.Norm(cfg.d_model, device, with_bias=gelu)
        if self.ffn == "moe":
            self.moe = X.MoE(cfg, dtype, device, experts)
        elif self.ffn == "dense":
            self.mlp = L.MLP(cfg, cfg.d_ff, dtype, device)

    def run(self, x: torch.Tensor, cfg: ModelConfig, mode: str, rope,
            caches: Optional[Caches], pos: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``train``: no caches (``caches`` None); ``prefill``: writes this
        layer's caches (k/v of every position, or the Mamba state and conv
        windows); ``decode``: writes position ``pos`` and attends over the
        first ``lengths`` positions, or advances the Mamba state by one
        token."""
        i = self.cache_index
        h = L.apply_norm(x, self.mixer_norm, cfg)
        if self.mixer == "attn":
            q, k, v = L.qkv_project(self.attn, h, cfg, rope)
            if mode == "decode":
                k_cache, v_cache = caches["k"][i], caches["v"][i]
                k_cache[:, :, pos] = k[:, 0]
                v_cache[:, :, pos] = v[:, 0]
                a = L.decode_step_attention(q, k_cache, v_cache, lengths)
            else:
                a = L.prefill_attention(q, k, v)
                if caches is not None:
                    caches["k"][i].copy_(k.transpose(1, 2))
                    caches["v"][i].copy_(v.transpose(1, 2))
            x = x + L.attn_out(self.attn, a)
        else:
            cache = (None if caches is None
                     else {n: caches[n][i] for n in MAMBA_CACHES})
            if mode == "decode":
                x = x + M.mamba_decode(self.mamba, cache, h, cfg)
            else:
                x = x + M.mamba_apply(self.mamba, h, cfg, cache)
        if self.ffn == "none":
            return x
        h = L.apply_norm(x, self.ffn_norm, cfg)
        if self.ffn == "dense":
            return x + L.mlp_apply(self.mlp, h, cfg)
        # the reference's rule: every expert on the token of a small decode
        # step, the configured dispatch otherwise (training included)
        small = mode == "decode" and h.shape[0] * h.shape[1] <= 16
        apply = X.moe_apply_dense if small else X.moe_apply
        return x + apply(self.moe, h, cfg)


def build_layers(cfg: ModelConfig, dtype, device,
                 experts: Optional[slice] = None) -> nn.ModuleList:
    """The decoder stack; ``experts``: the padded experts each MoE layer
    holds (a process rank's share), all of them by default."""
    counts = {"attn": 0, "mamba": 0}
    layers = []
    for kind in layer_kinds(cfg):
        layers.append(DecoderLayer(cfg, kind, counts[kind[0]], dtype, device,
                                   experts))
        counts[kind[0]] += 1
    return nn.ModuleList(layers)


def remat_on(cfg: ModelConfig) -> bool:
    """Whether a training pass recomputes its layers in the backward
    (``cfg.remat``); what it keeps is ``remat_policy``'s."""
    return cfg.remat


# products with no batch dims: JAX's ``dots_with_no_batch_dims_saveable``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_all(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE


@contextlib.contextmanager
def _within(ctx, inner):
    with use_shard_ctx(ctx), inner:
        yield


def remat_kwargs(cfg: ModelConfig) -> dict:
    """``torch.utils.checkpoint``'s keyword arguments for
    ``cfg.remat_policy`` (the reference's ``_remat_policy``): ``"full"``
    saves nothing and recomputes the period; ``"dots"`` saves the outputs
    of the matrix products with no batch dims (``aten.mm``, ``aten.addmm``)
    and recomputes the rest, ``aten.bmm`` included; ``"offloadable"`` (the
    reference's ``save_anything_except_these_names()`` with no names)
    saves every operation's output, so the recompute returns each one as
    the forward left it (buffers the forward filled in place included).  A
    policy changes memory and time, never the loss or the gradients.  The
    hand-written kernels run again in the recompute under every policy,
    writing the same values.

    The recompute runs where the backward runs: on the card, in the
    autograd engine's own thread, which does not see the caller's
    thread-local ``ShardCtx``; the forward's context is entered there
    again, so a period recomputes the dispatch it ran (the EP MoE's)."""
    if cfg.remat_policy == "full":
        sac = None
    elif cfg.remat_policy == "dots":
        sac = partial(create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy == "offloadable":
        sac = partial(create_selective_checkpoint_contexts, _save_all,
                      allow_cache_entry_mutation=True)
    else:
        raise ValueError(f"remat_policy={cfg.remat_policy!r}: not one of "
                         "'full', 'dots', 'offloadable'")
    ctx = current_ctx()
    if ctx is None:
        return {} if sac is None else {"context_fn": sac}

    def context_fn():
        fwd, rec = (sac() if sac is not None else
                    (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _within(ctx, rec)
    return {"context_fn": context_fn}


def _run_period(layers: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
                rope) -> torch.Tensor:
    for layer in layers:
        x = layer.run(x, cfg, "train", rope, None)
    return x


def run_stack(layers: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
              mode: str, positions: torch.Tensor,
              caches: Optional[Caches] = None,
              pos: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, D) through every layer; caches written in place (none in
    ``train``, where with ``cfg.remat`` each period of the plan runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward, but for what ``remat_policy`` saves, and its kernels launched
    again)."""
    rope = lengths = None
    if any(layer.mixer == "attn" for layer in layers):
        rope = L.rope_tables(positions, cfg.resolved_head_dim(),
                             cfg.rope_theta)
        if mode == "decode":    # every (batch, KV head) row, once per step
            lengths = torch.full((x.shape[0] * cfg.num_kv_heads,), pos + 1,
                                 dtype=torch.int32, device=x.device)
    if mode == "train":
        remat = remat_on(cfg)
        policy = remat_kwargs(cfg) if remat else {}
        period = len(layer_plan(cfg))
        for p0 in range(0, len(layers), period):
            block = layers[p0:p0 + period]
            x = (checkpoint(_run_period, block, x, cfg, rope,
                            use_reentrant=False, **policy) if remat
                 else _run_period(block, x, cfg, rope))
        return x
    for layer in layers:
        x = layer.run(x, cfg, mode, rope, caches, pos, lengths)
    return x


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def add_positions(pos_emb: Optional[torch.Tensor], x: torch.Tensor,
                  offset: int) -> torch.Tensor:
    """x (B, S, D) plus the learned positions ``offset .. offset + S - 1``
    (no-op without ``pos_emb``).  The JAX package's ``dynamic_slice``
    clamps a window that runs past the table; here it raises."""
    if pos_emb is None:
        return x
    S = x.shape[1]
    if not 0 <= offset <= pos_emb.shape[0] - S:
        raise ValueError(f"positions {offset}..{offset + S - 1} outside the "
                         f"{pos_emb.shape[0]} learned positions (max_seq)")
    return x + pos_emb[offset:offset + S]


def unembed(final_norm: L.Norm, head: torch.Tensor, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Float32 logits (B, S, V) for a few positions, from model-dtype
    operands: a float32 product of the model-dtype values, as the JAX
    package's ``preferred_element_type=float32`` gives (a bfloat16 product
    would round the logits and tie their argmax over a large vocabulary).
    ``head`` is (D, V)."""
    x = L.apply_norm(x, final_norm, cfg)
    B, S, D = x.shape
    logits = logits_f32(x.reshape(B * S, D), head).reshape(B, S, -1)
    V = L.padded_vocab(cfg.vocab_size)
    if V != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


class _Logits32(torch.autograd.Function):
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


def logits_f32(x2: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(T, D) @ (D, V) in float32 from model-dtype operands: a float32
    product of the model-dtype values, as the JAX package's
    ``preferred_element_type=float32`` gives."""
    if x2.device.type == "cpu" or x2.dtype == torch.float32:
        return x2.float() @ head.float()
    return _Logits32.apply(x2, head)


def lm_loss(final_norm: L.Norm, head: torch.Tensor, x: torch.Tensor,
            labels: torch.Tensor, loss_mask: torch.Tensor, cfg: ModelConfig,
            chunk: int = 0) -> torch.Tensor:
    """Chunked cross-entropy, the logits of ``chunk`` positions (default
    ``cfg.loss_chunk``; all of them where S is not a multiple) at a time,
    so (B, S, V) never materialises at once.  x: (B, S, D) pre-final-norm
    hidden states; labels / loss_mask: (B, S).  Float32 logits, the padded
    vocabulary masked to -1e30; the masked mean over max(count, 1)."""
    x = L.apply_norm(x, final_norm, cfg)
    B, S, D = x.shape
    V = head.shape[-1]
    chunk = min(chunk or cfg.loss_chunk, S)
    if S % chunk:
        chunk = S       # the reference's fallback (tiny configs)
    vocab_ok = torch.arange(V, device=x.device) < cfg.vocab_size
    labels = labels.long()
    loss_mask = loss_mask.float()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        xc = x[:, c0:c0 + chunk].reshape(-1, D)
        logits = logits_f32(xc, head).reshape(B, -1, V)
        logits = torch.where(vocab_ok, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[:, c0:c0 + chunk, None])[..., 0]
        mc = loss_mask[:, c0:c0 + chunk]
        tot = tot + ((lse - ll) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)
