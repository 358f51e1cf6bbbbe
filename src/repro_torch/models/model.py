"""Public model API: ``build_model(cfg) -> Model`` with ``init``,
``train_loss``, ``prefill`` and ``decode``, the abstract parameters, caches
and inputs of the dry run (``init_abstract``, ``cache_spec``,
``input_specs``), and ``params_from_jax``.

The port of the JAX package's ``models/model.py`` for the decoder-only
dense, MoE, SSM, hybrid and VLM models and the encoder-decoder model.
``Model`` owns its weights as an ``nn.Module`` on one device (``cuda``
unless the caller asks for the CPU).  ``prefill`` and ``decode`` take an
optional parameter set — a dict of tensors by parameter name, such as a
merged LoRA set that replaces a few weights and shares the rest — that
stands in for the model's own weights during the call.

Batch layouts (the JAX package's batch dict; as keyword arguments for
prefill and decode)
  train (LM):       {tokens (B, S), labels (B, S), loss_mask (B, S)}
  train (vlm):      {tokens (B, S_text), patch_embeds (B, P, D), labels,
                     loss_mask}: the loss covers the text suffix only
  train (encdec):   {frames (B, enc_frames, D), tokens (B, S), labels,
                     loss_mask}
  prefill (LM):     tokens (B, S)
  prefill (vlm):    tokens (B, S_text), patch_embeds (B, P, D); the
                    projected patches go in front of the tokens, so the
                    caches hold P + S_text positions
  prefill (encdec): tokens (B, S), frames (B, enc_frames, D)
                    -> (caches, last-position logits (B, 1, V) f32)
  decode:  (caches, token (B, 1), pos) -> (caches, logits (B, 1, V) f32);
           the caches are written in place and returned (a VLM decodes at
           pos = P + S_text + step)
Caches are a dict by kind (``transformer.py``): ``k``/``v`` for the
attention layers, ``ssm`` and ``conv_{x,b,c}`` for the Mamba layers, and
the encoder-decoder's cross caches ``xk``/``xv`` (``encdec.py``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, torch.Tensor]


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 max_seq: int = 0, experts: Optional[slice] = None):
        """``max_seq``: rows of the learned position table of a model
        without RoPE (``rope_theta <= 0``: the encoder-decoder's decoder);
        0 means none, as the JAX package's ``init(max_seq=0)``.
        ``experts``: the padded experts each MoE layer holds (a process
        rank's share, ``sharding.expert_rows``); all by default."""
        super().__init__()
        kinds = T.layer_kinds(cfg)  # raises for a config its family
                                    # cannot run
        if not cfg.decode_f32_scores:
            raise NotImplementedError(
                "decode_f32_scores=False: the decode-attention kernel scores "
                "in float32 only (no configuration sets it)")
        self.cfg = cfg
        self.device = resolve_device(device)
        dt = self.dtype
        dev = self.device
        V, D = L.padded_vocab(cfg.vocab_size), cfg.d_model
        self.embed = L.new_param((V, D), dt, dev)
        self.final_norm = L.Norm(D, dev, with_bias=(cfg.act == "gelu"))
        self.lm_head = (None if cfg.tie_embeddings
                        else L.new_param((D, V), dt, dev))
        self.pos_emb = (L.new_param((max_seq, D), dt, dev)
                        if cfg.rope_theta <= 0 and max_seq > 0 else None)
        self.projector = (L.new_param((D, D), dt, dev)
                          if cfg.family == "vlm" else None)
        if cfg.family == "encdec":
            self.encoder = E.build_encoder(cfg, dt, dev)
            self.enc_final_norm = L.Norm(D, dev, with_bias=True)
            self.layers = E.build_decoder(cfg, dt, dev)
        else:
            self.layers = T.build_layers(cfg, dt, dev, experts)
        self.n_attn = sum(m == "attn" for m, _ in kinds)
        self.n_mamba = len(kinds) - self.n_attn
        self._slots = {name: (mod, attr)
                       for mod_name, mod in self.named_modules()
                       for attr, _ in mod.named_parameters(recurse=False)
                       for name in [f"{mod_name}.{attr}" if mod_name
                                    else attr]}

    @property
    def dtype(self) -> torch.dtype:
        return L.torch_dtype(self.cfg.dtype)

    # ------------------------------------------------------------- params
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every weight from ``generator`` (on the model's device) with
        the JAX package's scales: normal in float32 times the scale, cast to
        the model dtype, one tensor at a time (so the largest float32
        temporary is one weight, the embedding; ``pos_emb`` std 0.02, the
        VLM ``projector`` 1/sqrt(D)); a module's ``init_fn``
        leaves (the Mamba ``dt_bias`` and ``a_log``) as that function
        draws them; norms ones, biases zeros.  A layer holding a share of
        its experts draws each expert tensor whole and keeps its rows (one
        layer's full tensor at a time), so the share equals those rows of
        the whole model's."""
        stds = {"embed": 0.02, "pos_emb": 0.02,
                "projector": 1.0 / np.sqrt(self.cfg.d_model)}
        fns, full = {}, {}
        if self.lm_head is not None:
            stds["lm_head"] = 1.0 / np.sqrt(self.cfg.d_model)
        for mod_name, mod in self.named_modules():
            for name, std in getattr(mod, "init_std", {}).items():
                stds[f"{mod_name}.{name}"] = std
            for name, fn in getattr(mod, "init_fn", {}).items():
                fns[f"{mod_name}.{name}"] = fn
            for name, shape in getattr(mod, "init_full", {}).items():
                full[f"{mod_name}.{name}"] = (shape, mod.experts)
        for name, p in self.named_parameters():
            if name in fns:
                p.copy_(fns[name](p.shape, generator, p.device))
                continue
            if name not in stds:        # norm scales, biases
                p.fill_(0.0 if name.split(".")[-1].startswith("b") else 1.0)
                continue
            shape, rows = full.get(name, (p.shape, slice(None)))
            tmp = torch.empty(shape, dtype=torch.float32, device=p.device)
            tmp.normal_(generator=generator).mul_(stds[name])
            p.copy_(tmp[rows])
            del tmp
        return self

    def params(self) -> Params:
        """The model's own parameter set (tensors shared, not copied)."""
        return {name: p for name, p in self.named_parameters()}

    def init_abstract(self, max_seq: int = 0) -> Params:
        """The parameter set of this configuration with ``max_seq`` learned
        positions, as tensors on the ``meta`` device: names, shapes and
        dtypes, no data (nothing is drawn)."""
        return Model(self.cfg, "meta", max_seq).params()

    def trainable(self, flag: bool = True) -> "Model":
        """Let the weights take gradients (``requires_grad``), or stop
        them; ``prefill`` and ``decode`` run without gradients either
        way, with the same results."""
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    @torch.no_grad()
    def load_params(self, params: Dict[str, Any]) -> "Model":
        """Copy a parameter set (tensors or arrays by name, every name of
        the model) into the model's weights, cast to their dtypes (norm
        scales, the MoE router and shared gate and the Mamba ``dt_bias``,
        ``a_log`` and ``d`` stay float32)."""
        own = self.params()
        missing = sorted(set(own) - set(params))
        extra = sorted(set(params) - set(own))
        if missing or extra:
            raise KeyError(f"parameter names differ: missing {missing[:4]}, "
                           f"unexpected {extra[:4]}")
        for name, p in own.items():
            src = torch.as_tensor(params[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)}, model "
                                 f"has {tuple(p.shape)}")
            p.copy_(src.to(device=p.device, dtype=p.dtype))
        return self

    @contextlib.contextmanager
    def _using(self, params: Optional[Params]):
        """Stand ``params`` in for the model's own weights (only those that
        differ are swapped) for the duration of the block."""
        swapped = []
        try:
            for name, t in (params or {}).items():
                mod, attr = self._slots[name]
                cur = mod._parameters[attr]
                if cur is not t:
                    swapped.append((mod, attr, cur))
                    mod._parameters[attr] = t
            yield
        finally:
            for mod, attr, cur in reversed(swapped):
                mod._parameters[attr] = cur

    # ------------------------------------------------------------ forward
    def _head(self) -> torch.Tensor:
        return self.embed.t() if self.lm_head is None else self.lm_head

    def new_caches(self, batch: int, seq: int) -> T.Caches:
        """Zeroed caches for ``batch`` rows of ``seq`` positions (the JAX
        package's ``cache_spec``, stacked by kind; the encoder-decoder's
        cross caches hold ``enc_frames`` positions)."""
        cfg = self.cfg
        z = lambda *s, dtype=self.dtype: torch.zeros(  # noqa: E731
            s, dtype=dtype, device=self.device)
        caches = {}
        if self.n_attn:
            for n in T.ATTN_CACHES:
                caches[n] = z(self.n_attn, batch, cfg.num_kv_heads, seq,
                              cfg.resolved_head_dim())
        if cfg.family == "encdec":
            for n in E.CROSS_CACHES:
                caches[n] = z(self.n_attn, batch, cfg.num_kv_heads,
                              cfg.enc_frames, cfg.resolved_head_dim())
        if self.n_mamba:
            k1 = cfg.ssm_conv - 1
            caches["ssm"] = z(self.n_mamba, batch, cfg.ssm_heads,
                              cfg.ssm_state, cfg.ssm_head_dim,
                              dtype=torch.float32)
            caches["conv_x"] = z(self.n_mamba, batch, k1, cfg.d_inner)
            caches["conv_b"] = z(self.n_mamba, batch, k1, cfg.ssm_state)
            caches["conv_c"] = z(self.n_mamba, batch, k1, cfg.ssm_state)
        return caches

    def cache_spec(self, batch_size: int, max_seq: int) -> T.Caches:
        """The decode caches of ``batch_size`` rows of ``max_seq`` positions
        on the ``meta`` device: ``new_caches``' layout (a dict by kind,
        stacked over the layers of the kind) and dtypes."""
        return Model(self.cfg, "meta").new_caches(batch_size, max_seq)

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Abstract (``meta``) inputs of one dry-run cell, as the
        reference's: the batch dict (int32 tokens and labels, a float32
        loss mask, bfloat16 frames or patch embeddings) of a train or
        prefill cell, or a decode step's caches, int32 token ``(B, 1)`` and
        position ``()``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        meta = torch.device("meta")
        tok = lambda *sh: torch.empty(sh, dtype=torch.int32,  # noqa: E731
                                      device=meta)
        f = lambda *sh: torch.empty(sh, dtype=torch.bfloat16,  # noqa: E731
                                    device=meta)
        if shape.kind == "decode":
            return {"caches": self.cache_spec(B, S), "token": tok(B, 1),
                    "pos": tok()}
        if cfg.family == "encdec":
            batch = {"frames": f(B, cfg.enc_frames, cfg.d_model),
                     "tokens": tok(B, S)}
        elif cfg.family == "vlm":
            batch = {"tokens": tok(B, S - cfg.vision_patches),
                     "patch_embeds": f(B, cfg.vision_patches, cfg.d_model)}
        else:
            batch = {"tokens": tok(B, S)}
        if shape.kind == "train":
            n_lab = batch["tokens"].shape[1]
            batch["labels"] = tok(B, n_lab)
            batch["loss_mask"] = torch.empty((B, n_lab), dtype=torch.float32,
                                             device=meta)
        return {"batch": batch}

    def _side_input(self, t: Optional[torch.Tensor], name: str, want: str,
                    batch: int, rows: Optional[int]) -> Optional[torch.Tensor]:
        """Input ``name`` (frames or patch embeddings) where ``name`` is the
        one the family wants: checked (batch, ``rows`` if given, d_model)
        and cast to the model dtype.  ``None`` where the family takes no
        ``name``; passing one there, or omitting a wanted one, raises."""
        family = self.cfg.family
        if want != name:
            if t is not None:
                raise ValueError(f"{self.cfg.name}: the {family} family takes "
                                 f"no {name}")
            return None
        if t is None:
            raise ValueError(f"{self.cfg.name}: the {family} family needs "
                             f"{name} (B, {rows or 'P'}, d_model)")
        D = self.cfg.d_model
        if (t.ndim != 3 or t.shape[0] != batch or t.shape[2] != D
                or (rows is not None and t.shape[1] != rows)
                or t.shape[1] == 0):
            raise ValueError(f"{self.cfg.name}: {name} of shape "
                             f"{tuple(t.shape)}, want ({batch}, "
                             f"{rows or 'P >= 1'}, {D})")
        return t.to(device=self.device, dtype=self.dtype)

    def train_loss(self, batch: Dict[str, Any],
                   params: Optional[Params] = None) -> torch.Tensor:
        """The training loss of ``batch`` (tensors or arrays by the JAX
        package's names: ``tokens``, ``labels``, ``loss_mask``, with
        ``frames`` for the encoder-decoder and ``patch_embeds`` for the
        VLM), a float32 scalar on the model's device, with gradients
        enabled: the masked mean next-token cross-entropy (``lm_loss``)."""
        cfg = self.cfg
        b = {k: torch.as_tensor(v, device=self.device)
             for k, v in batch.items()}
        tokens = b["tokens"].long()
        B = tokens.shape[0]
        want = {"encdec": "frames", "vlm": "patch_embeds"}.get(cfg.family)
        frames = self._side_input(b.get("frames"), "frames", want, B,
                                  cfg.enc_frames)
        patches = self._side_input(b.get("patch_embeds"), "patch_embeds",
                                   want, B, None)
        with torch.enable_grad(), self._using(params):
            x = T.embed_tokens(self.embed, tokens)
            if patches is not None:
                x = torch.cat([patches @ self.projector, x], dim=1)
            x = T.add_positions(self.pos_emb, x, 0)
            if frames is not None:
                enc_out = E.run_encoder(self.encoder, self.enc_final_norm,
                                        frames, cfg)
                x = E.run_decoder(self.layers, x, enc_out, cfg, "train")
            else:
                positions = torch.arange(x.shape[1], device=self.device)
                x = T.run_stack(self.layers, x, cfg, "train", positions)
                if patches is not None:     # the loss covers the text only
                    x = x[:, patches.shape[1]:]
            return T.lm_loss(self.final_norm, self._head(), x, b["labels"],
                             b["loss_mask"], cfg)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, params: Optional[Params] = None,
                *, frames: Optional[torch.Tensor] = None,
                patch_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[T.Caches, torch.Tensor]:
        """tokens (B, S), with ``frames`` (B, enc_frames, D) for the
        encoder-decoder and ``patch_embeds`` (B, P, D) for the VLM (a
        missing one raises ``ValueError``) -> (caches, last-position
        logits (B, 1, V) float32)."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        want = {"encdec": "frames", "vlm": "patch_embeds"}.get(cfg.family)
        frames = self._side_input(frames, "frames", want, B, cfg.enc_frames)
        patches = self._side_input(patch_embeds, "patch_embeds", want, B,
                                   None)
        with self._using(params):
            x = T.embed_tokens(self.embed, tokens)
            if patches is not None:
                x = torch.cat([patches @ self.projector, x], dim=1)
            x = T.add_positions(self.pos_emb, x, 0)
            caches = self.new_caches(B, x.shape[1])
            if frames is not None:
                enc_out = E.run_encoder(self.encoder, self.enc_final_norm,
                                        frames, cfg)
                x = E.run_decoder(self.layers, x, enc_out, cfg, "prefill",
                                  caches)
            else:
                positions = torch.arange(x.shape[1], device=self.device)
                x = T.run_stack(self.layers, x, cfg, "prefill", positions,
                                caches)
            logits = T.unembed(self.final_norm, self._head(), x[:, -1:], cfg)
        return caches, logits

    @torch.no_grad()
    def decode(self, caches: T.Caches, token: torch.Tensor, pos: int,
               params: Optional[Params] = None
               ) -> Tuple[T.Caches, torch.Tensor]:
        """token (B, 1) at position ``pos`` (the current length): writes its
        keys and values into ``caches`` at ``pos`` and advances the Mamba
        states, in place, and returns ``(caches, logits (B, 1, V)
        float32)``."""
        pos = int(pos)
        if "k" in caches and not 0 <= pos < caches["k"].shape[3]:
            raise ValueError(f"decode position {pos} outside the caches' "
                             f"{caches['k'].shape[3]} positions")
        token = token.to(self.device)
        with self._using(params):
            x = T.embed_tokens(self.embed, token)
            x = T.add_positions(self.pos_emb, x, pos)
            if self.cfg.family == "encdec":
                x = E.run_decoder(self.layers, x, None, self.cfg, "decode",
                                  caches, pos)
            else:
                positions = torch.arange(pos, pos + 1, device=self.device)
                x = T.run_stack(self.layers, x, self.cfg, "decode",
                                positions, caches, pos)
            logits = T.unembed(self.final_norm, self._head(), x, self.cfg)
        return caches, logits


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                max_seq: int = 0, mesh=None) -> Model:
    """The model with uninitialised weights: call ``init`` or
    ``load_params``.  ``max_seq``: the learned position table's rows
    (``Model``).  ``mesh``: a ``ProcessMesh`` whose model axis splits the
    experts; the model then holds this rank's share
    (``sharding.expert_rows``), the rest replicated."""
    experts = None
    if mesh is not None and cfg.num_experts:
        from repro_torch.distributed.sharding import expert_rows
        experts = expert_rows(mesh, L.padded_experts(cfg.num_experts))
    return Model(cfg, device, max_seq, experts)


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # exact in float32
        a = a.astype(np.float32)
    return a


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter tree (arrays, e.g. numpy) as the port's
    parameter names.  A dense, moe, ssm, hybrid or vlm model: the stacked
    leaves of ``layers/sub<i>/...`` unstacked along their leading period
    dim, period ``p`` sub-layer ``i`` becoming layer ``p * period + i``.
    The encoder-decoder: ``layers/enc/<group>/...`` (stacked over
    ``enc_layers``) as ``encoder.<i>.<group>...``, ``layers/dec/...``
    (over ``num_layers``) as ``layers.<i>...`` and
    ``layers/enc_final_norm`` as ``enc_final_norm``.  ``pos_emb`` and
    ``projector/kernel`` as ``pos_emb`` and ``projector``.  Every weight
    kept in its ``(in, out)`` orientation (expert stacks ``(E, in, out)``,
    the router ``(D, num_experts)``).  Values come as float32 (bfloat16
    widened exactly); ``Model.load_params`` casts them to the model
    dtype."""
    t = lambda a: torch.tensor(_np(a))  # noqa: E731  (a copy)
    out = {"embed": t(tree["embed"]["table"])}
    for name, arr in tree["final_norm"].items():
        out[f"final_norm.{name}"] = t(arr)
    if "lm_head" in tree:
        out["lm_head"] = t(tree["lm_head"]["kernel"])
    if "pos_emb" in tree:
        out["pos_emb"] = t(tree["pos_emb"])
    if "projector" in tree:
        out["projector"] = t(tree["projector"]["kernel"])
    subs = tree["layers"]
    if "enc" in subs:
        if set(subs) != {"enc", "dec", "enc_final_norm"}:
            raise ValueError(f"params_from_jax: encoder-decoder layers "
                             f"{sorted(subs)} are not enc, dec, "
                             "enc_final_norm")
        for name, arr in subs["enc_final_norm"].items():
            out[f"enc_final_norm.{name}"] = t(arr)
        for prefix, key in (("encoder", "enc"), ("layers", "dec")):
            for group, leaves in subs[key].items():
                for name, arr in leaves.items():
                    a = _np(arr)
                    for i in range(a.shape[0]):
                        out[f"{prefix}.{i}.{group}.{name}"] = t(a[i])
        return out
    period = len(subs)
    if set(subs) != {f"sub{i}" for i in range(period)}:
        raise ValueError(f"params_from_jax: sub-layers {sorted(subs)} are "
                         "not sub0..sub<n-1>")
    n = None
    for i in range(period):
        sub = subs[f"sub{i}"]
        if ("attn" in sub) == ("mamba" in sub) or ("mlp" in sub and
                                                   "moe" in sub):
            raise ValueError(f"params_from_jax: sub{i} must hold one mixer "
                             "(attn or mamba) and at most one FFN (mlp or "
                             f"moe), got {sorted(sub)}")
        for group in sub:
            for name, arr in sub[group].items():
                a = _np(arr)
                n = a.shape[0] if n is None else n
                if a.shape[0] != n:
                    raise ValueError(f"sub{i}/{group}/{name}: leading dim "
                                     f"{a.shape[0]} != {n} periods")
                for p in range(n):
                    out[f"layers.{p * period + i}.{group}.{name}"] = t(a[p])
    return out


def reference_leaf(name: str, period: int) -> str:
    """The JAX package's leaf that holds the port's parameter ``name``:
    the port keeps one tensor per layer where the reference stacks a
    sub-layer's weight over its periods (``layers/sub<j % period>/...``,
    ``layers/enc/...``, ``layers/dec/...``), so every port layer of one
    such leaf maps to the same name.  ``period``: the layers of one period
    of the family's plan (1 for the encoder-decoder)."""
    head, _, rest = name.partition(".")
    if head in ("layers", "encoder"):
        layer, _, tail = rest.partition(".")
        sub = int(layer) % period if head == "layers" else 0
        return f"{head}.sub{sub}.{tail}"
    return name


def reference_ndim(name: str, t: torch.Tensor) -> int:
    """The number of dims of the reference's leaf of ``name``: one more
    than the port tensor's for a layer's parameter (stacked over the
    periods there, so a per-layer norm scale or Mamba vector is 2-D), the
    same for the others (embedding, head, ``final_norm``,
    ``enc_final_norm``, ``pos_emb``, ``projector``)."""
    return t.dim() + (1 if name.startswith(("layers.", "encoder.")) else 0)
