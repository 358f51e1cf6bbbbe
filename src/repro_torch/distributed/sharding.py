"""Logical-axis sharding: name-based rules mapping parameter and activation
dims to mesh axes, and a ``shard()`` helper.

The port of the JAX package's ``distributed/sharding.py``.  A ``ShardCtx``
resolves the model code's logical names to the axes of a mesh
(``launch.mesh.Mesh``, or anything with ``axis_names`` and ``shape``):

  single pod : ("data", "model")
  multi pod  : ("pod", "data", "model")

  "batch"  -> ("pod", "data")          data parallel (pods are extra DP)
  "fsdp"   -> ("pod", "data") or None  parameter sharding for fsdp mode
  "model"  -> "model"                  tensor/expert parallel
  "seq"    -> "model"                  KV-cache sequence sharding (decode)

A spec is a ``P``, a tuple of one entry per dim: ``None`` (replicated), an
axis name, or a tuple of axis names.  Nothing is placed: ``shard()``
resolves its names as the reference does (an unknown name raises
``KeyError``) and returns its input, and the specs serve the dry run's
per-device accounting (``launch/dryrun.py``) and the expert-parallel MoE's
mesh shape (``distributed/ep_moe.py``).  Over a ``ProcessMesh`` (one
process a position) the context also names this rank's data shard and
model rank, and ``shard_params`` keeps a rank's share of the experts.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Dict, Optional, Tuple

import torch

_CTX = threading.local()


class P(tuple):
    """A partition spec: one entry per dim (``None``, an axis name, or a
    tuple of axis names), normalised as JAX's ``PartitionSpec``: a one-name
    tuple is the name, an empty one ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class ShardCtx:
    """Resolved mesh context: which mesh axes implement each logical axis."""

    def __init__(self, mesh, param_sharding: str = "fsdp"):
        self.mesh = mesh
        names = tuple(mesh.axis_names)
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in names)
        self.model_axis: Optional[str] = "model" if "model" in names else None
        self.param_sharding = param_sharding

    @property
    def process(self) -> bool:
        """Whether the mesh's positions are processes (a ``ProcessMesh``):
        then this process holds one position's share."""
        return bool(getattr(self.mesh, "process", False))

    @property
    def data_shard(self) -> int:
        """This rank's index over the batch axes (row-major), 0 without
        them (process meshes only)."""
        i = 0
        for a in self.batch_axes:
            i = i * self.mesh.shape[a] + self.mesh.index(a)
        return i

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the model axis (process meshes
        only)."""
        return self.mesh.index(self.model_axis) if self.model_axis else 0

    def logical(self, name: Optional[str]):
        if name is None:
            return None
        if name == "batch":
            return self.batch_axes if self.batch_axes else None
        if name == "fsdp":
            # fsdp shards params over the data axes; dp/zero1 replicate them
            if self.param_sharding == "fsdp" and self.batch_axes:
                return self.batch_axes
            return None
        if name in ("model", "seq", "expert", "heads", "vocab", "mlp"):
            return self.model_axis
        raise KeyError(f"unknown logical axis {name!r}")

    def pspec(self, *logical_names) -> P:
        return P(*[self.logical(n) for n in logical_names])


def current_ctx() -> Optional[ShardCtx]:
    return getattr(_CTX, "ctx", None)


@contextlib.contextmanager
def use_shard_ctx(ctx: Optional[ShardCtx]):
    """Make ``ctx`` this thread's context for the block; the previous one
    comes back on exit."""
    prev = getattr(_CTX, "ctx", None)
    _CTX.ctx = ctx
    try:
        yield ctx
    finally:
        _CTX.ctx = prev


def _axis_size(ctx: ShardCtx, phys) -> int:
    if phys is None:
        return 1
    if isinstance(phys, tuple):
        n = 1
        for a in phys:
            n *= ctx.mesh.shape[a]
        return n
    return ctx.mesh.shape[phys]


def _fit(ctx: ShardCtx, entries, shape) -> P:
    """The divisibility fallback: a dim whose size its axes do not divide
    is replicated (e.g. qwen2-7b's 28 heads on a 16-way model axis)."""
    return P(*[None if phys is not None and shape[dim]
               % _axis_size(ctx, phys) else phys
               for dim, phys in enumerate(entries)])


def shard(x: torch.Tensor, *logical_names) -> torch.Tensor:
    """The reference's sharding constraint keyed by logical names.  Without
    a context it does nothing; with one it resolves the names (with the
    divisibility fallback) and, on one device, returns ``x`` itself."""
    ctx = current_ctx()
    if ctx is not None:
        _fit(ctx, [ctx.logical(n) for n in logical_names], x.shape)
    return x


# ---------------------------------------------------------------------------
# Name-based parameter sharding rules (the reference's, copied).
#
# Rules are (regex over the reference's '/'.joined param path) -> tuple of
# logical axis names (one per trailing dim; leading unmatched dims — e.g.
# the stacked-layer dim — are None).  First match wins.
PARAM_RULES: Tuple[Tuple[str, Optional[Tuple[Optional[str], ...]]], ...] = (
    (r"embed/table$",            ("vocab", "fsdp")),
    (r"pos_emb$",                (None, "fsdp")),
    (r"lm_head/kernel$",         ("fsdp", "vocab")),
    (r"projector/kernel$",       ("fsdp", "model")),
    # attention
    (r"attn.*/w(q|k|v)$",        ("fsdp", "model")),
    (r"attn.*/wo$",              ("model", "fsdp")),
    (r"attn.*/b(q|k|v)$",        ("model",)),
    (r"attn.*/(q|k)_norm$",      (None,)),
    # dense mlp
    (r"mlp/w(i|g)$",             ("fsdp", "model")),
    (r"mlp/wo$",                 ("model", "fsdp")),
    # moe: experts on the model axis (EP); router replicated over model
    (r"moe/router$",             ("fsdp", None)),
    (r"moe/w(i|g)$",             ("expert", "fsdp", None)),
    (r"moe/wo$",                 ("expert", None, "fsdp")),
    (r"moe/shared_w(i|g)$",      ("fsdp", "model")),
    (r"moe/shared_wo$",          ("model", "fsdp")),
    (r"moe/shared_gate$",        ("fsdp",)),
    # mamba2
    (r"mamba/in_proj_(z|x)$",    ("fsdp", "model")),
    (r"mamba/in_proj_(b|c)$",    ("fsdp", None)),
    (r"mamba/in_proj_dt$",       ("fsdp", "model")),
    (r"mamba/(dt_bias|a_log|d)$", ("model",)),
    (r"mamba/conv_.*$",          (None, "model")),
    (r"mamba/norm_scale$",       ("model",)),
    (r"mamba/out_proj$",         ("model", "fsdp")),
    # norms / everything small: replicated
    (r".*(norm|scale|bias).*$",  None),
)


def spec_for_path(path: str, ndim: int) -> P:
    for pat, axes in PARAM_RULES:
        if re.search(pat, path):
            if axes is None:
                return P()
            pad = (None,) * (ndim - len(axes))
            return P(*(pad + tuple(axes)))
    return P()  # default: replicate


# the reference's leaf under the port's whole-tensor names
_LEAF_PATHS = {"embed": "embed/table", "lm_head": "lm_head/kernel",
               "projector": "projector/kernel"}


def param_pspecs(params: Dict[str, torch.Tensor], period: int
                 ) -> Dict[str, P]:
    """Spec of each of the port's parameters (names as ``Model.params()``),
    by the rules on its reference leaf (``models.model.reference_leaf``,
    ``period`` the layers of one period of the family's plan, 1 for the
    encoder-decoder) at the leaf's rank (``reference_ndim``).  A layer's
    reference leaf is stacked over the periods; its leading entry (always
    ``None``) is dropped, since the port keeps one tensor a layer.  Weights
    keep the reference's ``(in, out)`` orientation, so no entry moves."""
    from repro_torch.models.model import reference_leaf, reference_ndim
    out = {}
    for name, t in params.items():
        leaf = reference_leaf(name, period)
        path = _LEAF_PATHS.get(leaf, leaf.replace(".", "/"))
        ndim = reference_ndim(name, t)
        spec = spec_for_path(path, ndim)
        out[name] = P(*spec[1:]) if ndim > t.dim() and spec else spec
    return out


def resolve_pspec(ctx: ShardCtx, spec) -> P:
    """Map logical names inside a spec to mesh axes."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            resolved: list = []
            for e in entry:
                r = ctx.logical(e)
                if r is None:
                    continue
                resolved.extend(r if isinstance(r, tuple) else (r,))
            out.append(tuple(resolved) if resolved else None)
        else:
            r = ctx.logical(entry)
            if r is None:
                out.append(None)
            elif isinstance(r, tuple):
                out.append(r if len(r) > 1 else r[0])
            else:
                out.append(r)
    return P(*out)


def named_shardings(ctx: ShardCtx, params: Dict[str, Any], period: int
                    ) -> Dict[str, P]:
    """Each parameter's spec over ``ctx``'s mesh axes, one entry a dim,
    with the divisibility fallback (tensors or meta tensors by name)."""
    out = {}
    for name, spec in param_pspecs(params, period).items():
        t = params[name]
        resolved = resolve_pspec(ctx, spec)
        entries = list(resolved) + [None] * (t.dim() - len(resolved))
        out[name] = _fit(ctx, entries, t.shape)
    return out


_EXPERT_WEIGHT = re.compile(r"(^|\.)moe\.w[igo]$")


def expert_rows(mesh, num_experts: int) -> Optional[slice]:
    """The padded experts this rank of a process ``mesh`` holds (``E / n``
    of them, ``n`` the model axis), or ``None`` where it holds them all (a
    logical mesh, no model axis, or ``n`` not dividing the experts: the
    EP dispatch then runs the sort path, which needs every expert)."""
    ctx = ShardCtx(mesh)
    if not ctx.process or ctx.model_axis is None:
        return None
    n = mesh.shape[ctx.model_axis]
    if n == 1 or num_experts % n:
        return None
    e = num_experts // n
    return slice(ctx.model_rank * e, (ctx.model_rank + 1) * e)


def shard_params(params: Dict[str, torch.Tensor], mesh
                 ) -> Dict[str, torch.Tensor]:
    """This rank's share of a full parameter set over a process ``mesh``:
    each MoE layer's ``wi``, ``wg`` and ``wo`` cut to the rank's experts
    (a copy, so the full tensor can be freed), every other tensor as it
    is (replicated)."""
    out = {}
    for name, t in params.items():
        rows = (expert_rows(mesh, t.shape[0])
                if _EXPERT_WEIGHT.search(name) else None)
        out[name] = t if rows is None else t[rows].clone()
    return out
