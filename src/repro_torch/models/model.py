"""Public model API: ``build_model(cfg) -> Model`` with ``init``,
``prefill`` and ``decode``, and ``params_from_jax``.

The port of the JAX package's ``models/model.py`` for decoder-only dense,
MoE, SSM and hybrid models.  ``Model`` owns its weights as an
``nn.Module`` on one device (``cuda`` unless the caller asks for the CPU).
``prefill`` and ``decode`` take an optional parameter set — a dict of
tensors by parameter name, such as a merged LoRA set that replaces a few
weights and shares the rest — that stands in for the model's own weights
during the call.

Batch layouts
  prefill: tokens (B, S) -> (caches, last-position logits (B, 1, V) f32)
  decode:  (caches, token (B, 1), pos) -> (caches, logits (B, 1, V) f32);
           the caches are written in place and returned
Caches are a dict by kind (``transformer.py``): ``k``/``v`` for the
attention layers, ``ssm`` and ``conv_{x,b,c}`` for the Mamba layers.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, torch.Tensor]


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        kinds = T.layer_kinds(cfg)  # raises for the unported families
                                    # and for a config its family cannot run
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
        self.layers = T.build_layers(cfg, dt, dev)
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
        temporary is one weight, the embedding); a module's ``init_fn``
        leaves (the Mamba ``dt_bias`` and ``a_log``) as that function
        draws them; norms ones, biases zeros."""
        stds = {"embed": 0.02}
        fns = {}
        if self.lm_head is not None:
            stds["lm_head"] = 1.0 / np.sqrt(self.cfg.d_model)
        for mod_name, mod in self.named_modules():
            for name, std in getattr(mod, "init_std", {}).items():
                stds[f"{mod_name}.{name}"] = std
            for name, fn in getattr(mod, "init_fn", {}).items():
                fns[f"{mod_name}.{name}"] = fn
        for name, p in self.named_parameters():
            if name in fns:
                p.copy_(fns[name](p.shape, generator, p.device))
                continue
            if name not in stds:        # norm scales, biases
                p.fill_(0.0 if name.split(".")[-1].startswith("b") else 1.0)
                continue
            tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            tmp.normal_(generator=generator).mul_(stds[name])
            p.copy_(tmp)
            del tmp
        return self

    def params(self) -> Params:
        """The model's own parameter set (tensors shared, not copied)."""
        return {name: p for name, p in self.named_parameters()}

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
        package's ``cache_spec``, stacked by kind)."""
        cfg = self.cfg
        z = lambda *s, dtype=self.dtype: torch.zeros(  # noqa: E731
            s, dtype=dtype, device=self.device)
        caches = {}
        if self.n_attn:
            for n in T.ATTN_CACHES:
                caches[n] = z(self.n_attn, batch, cfg.num_kv_heads, seq,
                              cfg.resolved_head_dim())
        if self.n_mamba:
            k1 = cfg.ssm_conv - 1
            caches["ssm"] = z(self.n_mamba, batch, cfg.ssm_heads,
                              cfg.ssm_state, cfg.ssm_head_dim,
                              dtype=torch.float32)
            caches["conv_x"] = z(self.n_mamba, batch, k1, cfg.d_inner)
            caches["conv_b"] = z(self.n_mamba, batch, k1, cfg.ssm_state)
            caches["conv_c"] = z(self.n_mamba, batch, k1, cfg.ssm_state)
        return caches

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, params: Optional[Params] = None
                ) -> Tuple[T.Caches, torch.Tensor]:
        """tokens (B, S) -> (caches, last-position logits (B, 1, V)
        float32)."""
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        with self._using(params):
            x = T.embed_tokens(self.embed, tokens)
            caches = self.new_caches(B, S)
            positions = torch.arange(S, device=self.device)
            x = T.run_stack(self.layers, x, self.cfg, "prefill", positions,
                            caches)
            logits = T.unembed(self.final_norm, self._head(), x[:, -1:],
                               self.cfg)
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
            positions = torch.arange(pos, pos + 1, device=self.device)
            x = T.run_stack(self.layers, x, self.cfg, "decode", positions,
                            caches, pos)
            logits = T.unembed(self.final_norm, self._head(), x, self.cfg)
        return caches, logits


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """The model with uninitialised weights: call ``init`` or
    ``load_params``."""
    return Model(cfg, device)


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # exact in float32
        a = a.astype(np.float32)
    return a


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter tree (arrays, e.g. numpy) of a dense,
    moe, ssm or hybrid model as the port's parameter names: the stacked
    leaves of ``layers/sub<i>/...`` unstacked along their leading period
    dim, period ``p`` sub-layer ``i`` becoming layer ``p * period + i``;
    every weight kept in its ``(in, out)`` orientation (expert stacks
    ``(E, in, out)``, the router ``(D, num_experts)``).  Values come as
    float32 (bfloat16 widened exactly); ``Model.load_params`` casts them to
    the model dtype."""
    t = lambda a: torch.tensor(_np(a))  # noqa: E731  (a copy)
    out = {"embed": t(tree["embed"]["table"]),
           "final_norm.scale": t(tree["final_norm"]["scale"])}
    if "lm_head" in tree:
        out["lm_head"] = t(tree["lm_head"]["kernel"])
    subs = tree["layers"]
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
