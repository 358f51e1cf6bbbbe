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

Over a process mesh (a model built with ``mesh=``) the layers are
tensor-parallel (``layers.py``, ``mamba.py``, ``moe.py``), the embedding,
the loss and the unembedding vocabulary-parallel over the model axis (a
tied model's head is its embedding's block), a Mamba cache holds this
rank's heads and channels, and an attention cache this rank's slice of
the positions of every KV head (``cache_shardings``): prefill and
decode gather the step's new keys and values over the model axis and
the rank that owns a position writes it; decode gathers q and attends
every head over its own positions (``layers.seq_decode_attention``),
then keeps its heads for the row-parallel ``wo``.
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
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (P, current_ctx, gather_block,
                                              use_shard_ctx)
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
            x = x + self_attention(self.attn, h, cfg, mode, rope, caches, i,
                                   pos, lengths)
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
        # step (of the global batch), the configured dispatch otherwise
        # (training included)
        small = mode == "decode" and X.dispatch_tokens(self.moe, h) <= 16
        apply = X.moe_apply_dense if small else X.moe_apply
        return x + apply(self.moe, h, cfg)


class PlacedCaches(dict):
    """A placed model's caches (``Model.new_caches``): ``seq_split`` says
    whether its attention caches hold this rank's slice of the positions
    (over the context's seq axes) or, where those axes do not divide the
    cache's length (``cache_shardings``' fallback), every position."""

    def __init__(self, caches: Caches, seq_split: bool):
        super().__init__(caches)
        self.seq_split = seq_split


def self_attention(p: L.Attention, h: torch.Tensor, cfg: ModelConfig,
                   mode: str, rope, caches: Optional[Caches], i: int,
                   pos: Optional[int] = None,
                   lengths: Optional[torch.Tensor] = None,
                   f32_scores: Optional[bool] = None) -> torch.Tensor:
    """The self-attention block over the caches ``caches["k"][i]`` and
    ``["v"][i]`` (none in ``train``; ``prefill`` writes every position,
    ``decode`` position ``pos`` and attends over ``lengths``).  A placed
    layer's caches hold every KV head: the step's new keys and values are
    gathered over the model axis.  Where they hold this rank's slice of
    the positions, the rank that owns a position writes it, and a decode
    step attends every head over the slice (``seq_decode_attention``),
    keeping this rank's heads; where they hold every position
    (``PlacedCaches.seq_split`` false), every rank writes, and a decode
    step attends this rank's heads over them (``head_decode_attention``).
    A layer computed whole (``layers.whole``) attends every head.  A
    decode step's scores follow ``cfg.decode_f32_scores`` unless
    ``f32_scores`` is given."""
    if f32_scores is None:
        f32_scores = cfg.decode_f32_scores
    placed = getattr(p, "placed", None)
    ctx = None if placed is None else placed[0].ctx
    split = ctx is not None and getattr(caches, "seq_split", True)
    q, k, v = L.qkv_project(p, h, cfg, rope)
    if caches is not None:
        kc, vc = caches["k"][i], caches["v"][i]
        s0, Sl = (L.seq_slice(ctx, kc.shape[2]) if split
                  else (0, kc.shape[2]))
        kf, vf = L.all_kv_heads(p, k, cfg), L.all_kv_heads(p, v, cfg)
        if mode == "decode":
            if s0 <= pos < s0 + Sl:
                kc[:, :, pos - s0] = kf[:, 0]
                vc[:, :, pos - s0] = vf[:, 0]
        else:
            w = min(kf.shape[1], s0 + Sl) - s0
            if w > 0:
                kc[:, :, :w].copy_(kf[:, s0:s0 + w].transpose(1, 2))
                vc[:, :, :w].copy_(vf[:, s0:s0 + w].transpose(1, 2))
    if mode != "decode":
        a = L.prefill_attention(q, k, v)
    elif not split:
        a = L.head_decode_attention(p, q, kc, vc, lengths, cfg, f32_scores)
    else:
        Hl = q.shape[2]
        a = L.seq_decode_attention(L.all_heads(p, q), kc, vc, pos, ctx,
                                   f32_scores)
        if L.tp_group(p, "wq") is not None:
            r = L.model_group(ctx)[1]
            a = a[:, :, r * Hl:(r + 1) * Hl]
    return L.attn_out(p, a)


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


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 place=None) -> torch.Tensor:
    """``table[tokens]``; ``place`` (a ``Placement``): vocabulary-parallel,
    each rank looking up the tokens in its rows of the vocabulary (its
    FSDP columns gathered first), zero elsewhere, summed over the model
    axis."""
    if place is None:
        return table[tokens]
    ctx = place.ctx
    t = place.gathered("embed", table, ctx.batch_axes)
    if place.specs["embed"][0] is None:     # the vocabulary replicated
        return t[tokens]
    _, r, group = L.model_group(ctx)
    Vl = t.shape[0]
    local = tokens - r * Vl
    ok = (local >= 0) & (local < Vl)
    x = torch.where(ok[..., None], t[local.clamp(0, Vl - 1)],
                    torch.zeros((), dtype=t.dtype, device=t.device))
    return C.reduce_from(x, group)


def _vocab_block(place, head: torch.Tensor):
    """A placed head (D, V/n) with its FSDP rows gathered, its first
    vocabulary row and the model group (``None`` if the vocabulary is
    replicated).  A tied model's head is its embedding block transposed,
    ``("fsdp", "vocab")`` of the table's ``("vocab", "fsdp")``: the
    lookup's and the head's gradients add into the table's one block."""
    ctx = place.ctx
    if "lm_head" in place.specs:
        spec = place.specs["lm_head"]
    else:
        spec = P(place.specs["embed"][1], place.specs["embed"][0])
    h = gather_block(head, spec, place.mesh, ctx.batch_axes)
    if spec[1] is None:
        return h, 0, None
    _, r, group = L.model_group(ctx)
    return h, r * h.shape[1], group


def add_positions(pos_emb: Optional[torch.Tensor], x: torch.Tensor,
                  offset: int, place=None) -> torch.Tensor:
    """x (B, S, D) plus the learned positions ``offset .. offset + S - 1``
    (no-op without ``pos_emb``).  The JAX package's ``dynamic_slice``
    clamps a window that runs past the table; here it raises.  Placed
    (``place``): the table's ``D`` dim, a data-axis block under ``fsdp``,
    gathered over the data axes first."""
    if pos_emb is None:
        return x
    if place is not None:
        pos_emb = place.gathered("pos_emb", pos_emb, place.ctx.batch_axes)
    S = x.shape[1]
    if not 0 <= offset <= pos_emb.shape[0] - S:
        raise ValueError(f"positions {offset}..{offset + S - 1} outside the "
                         f"{pos_emb.shape[0]} learned positions (max_seq)")
    return x + pos_emb[offset:offset + S]


def unembed(final_norm: L.Norm, head: torch.Tensor, x: torch.Tensor,
            cfg: ModelConfig, place=None) -> torch.Tensor:
    """Float32 logits (B, S, V) for a few positions, from model-dtype
    operands: a float32 product of the model-dtype values, as the JAX
    package's ``preferred_element_type=float32`` gives (a bfloat16 product
    would round the logits and tie their argmax over a large vocabulary).
    ``head`` is (D, V); placed (``place``): this rank's (D, V/n) block,
    the logits gathered over the model axis."""
    x = L.apply_norm(x, final_norm, cfg)
    B, S, D = x.shape
    group = None
    if place is not None:       # this rank's vocabulary, then all of it
        head, _, group = _vocab_block(place, head)
    logits = L.f32_product(x.reshape(B * S, D), head).reshape(B, S, -1)
    if group is not None:
        logits = C.gather_dim(logits, group, 2)
    V = L.padded_vocab(cfg.vocab_size)
    if V != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def lm_loss(final_norm: L.Norm, head: torch.Tensor, x: torch.Tensor,
            labels: torch.Tensor, loss_mask: torch.Tensor, cfg: ModelConfig,
            chunk: int = 0, place=None,
            count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunked cross-entropy, the logits of ``chunk`` positions (default
    ``cfg.loss_chunk``; all of them where S is not a multiple) at a time,
    so (B, S, V) never materialises at once.  x: (B, S, D) pre-final-norm
    hidden states; labels / loss_mask: (B, S).  Float32 logits, the padded
    vocabulary masked to -1e30; the masked mean over max(count, 1).

    Placed (``place``, a ``Placement``): vocabulary-parallel on ``lm_head``
    (``("fsdp", "vocab")``; a tied model's embedding rows), the max, the
    sum of exponentials and the label's logit each reduced over the model
    axis; ``count`` is the mask's count over the whole batch (every data
    shard), so a rank's loss is its rows' share of the global mean."""
    x = L.apply_norm(x, final_norm, cfg)
    B, S, D = x.shape
    v0, group = 0, None
    if place is not None:       # this rank's vocabulary rows
        head, v0, group = _vocab_block(place, head)
    V = head.shape[-1]
    labels = labels.long()
    if group is not None:
        x = C.copy_to(x, group)
        labels = labels - v0
        own = (labels >= 0) & (labels < V)
        labels = labels.clamp(0, V - 1)
    chunk = min(chunk or cfg.loss_chunk, S)
    if S % chunk:
        chunk = S       # the reference's fallback (tiny configs)
    vocab_ok = torch.arange(v0, v0 + V, device=x.device) < cfg.vocab_size
    loss_mask = loss_mask.float()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        xc = x[:, c0:c0 + chunk].reshape(-1, D)
        logits = L.f32_product(xc, head).reshape(B, -1, V)
        logits = torch.where(vocab_ok, logits, -1e30)
        ll = torch.gather(logits, -1, labels[:, c0:c0 + chunk, None])[..., 0]
        if group is None:
            lse = torch.logsumexp(logits, dim=-1)
        else:
            m = C.all_reduce(logits.detach().amax(-1), group, "max")
            lse = m + torch.log(C.reduce_from(
                torch.exp(logits - m[..., None]).sum(-1), group))
            ll = C.reduce_from(torch.where(own[:, c0:c0 + chunk], ll, 0.0),
                               group)
        mc = loss_mask[:, c0:c0 + chunk]
        tot = tot + ((lse - ll) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt if count is None else count, min=1.0)
