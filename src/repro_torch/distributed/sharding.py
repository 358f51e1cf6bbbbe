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
axis name, or a tuple of axis names.  On one device nothing is placed:
``shard()`` resolves its names as the reference does (an unknown name
raises ``KeyError``) and returns its input, and the specs serve the dry
run's per-device accounting (``launch/dryrun.py``) and the expert-parallel
MoE's mesh shape (``distributed/ep_moe.py``).

Over a ``ProcessMesh`` (one process a position) the specs place: a rank
holds ``local_block`` of each tensor, the blocks laid as ``NamedSharding``
lays them (a dim over several axes split row-major over them), and
``gather_block`` puts a tensor back together on every rank
(``gather_whole`` on one).  ``Placement`` is a model's map of every
parameter to its spec (``named_shardings``; every family, ``places``),
and ``shard_params`` cuts a full parameter set to this rank's blocks.
Where the divisibility fallback leaves a layer's heads or width whole
(``_fit``), the blocks may still split its weights' columns, even in the
middle of a head; such a layer is computed replicated over ``model``
from its weights gathered whole (``Placement.whole``).  An MoE model
that keeps the expert share (``expert_share``, by default with
``moe_impl="ep"``) holds instead its experts cut to the rank's
(``expert_rows``), every other tensor replicated.
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

    def __init__(self, mesh, param_sharding: str = "fsdp",
                 seq_axes: Optional[Tuple[str, ...]] = None):
        """``seq_axes``: the axes a decode cache's positions split over,
        row-major (default the model axis; the reference's batch-1 cell
        with a pod axis takes ``("pod", "model")``)."""
        self.mesh = mesh
        names = tuple(mesh.axis_names)
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in names)
        self.model_axis: Optional[str] = "model" if "model" in names else None
        self.param_sharding = param_sharding
        if seq_axes is None:
            seq_axes = (self.model_axis,) if self.model_axis else ()
        unknown = [a for a in seq_axes if a not in names]
        if unknown:
            raise ValueError(f"seq_axes {tuple(seq_axes)}: {unknown} not "
                             f"axes of the mesh {names}")
        self.seq_axes: Tuple[str, ...] = tuple(seq_axes)

    @property
    def sharded(self) -> bool:
        """A process mesh with a data or model axis above 1."""
        return self.process and any(s > 1 for s in self.mesh.shape.values())

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


def cache_shardings(ctx: ShardCtx, cache_spec: Dict[str, Any],
                    seq_axes=None) -> Dict[str, P]:
    """Decode caches (``Model.cache_spec``'s layout): batch -> (pod, data);
    the attention KV's sequence dim -> model (+ pod where the batch cannot
    use it, e.g. long_500k's B = 1); Mamba heads and channels -> model.
    The reference's rules; its KV caches are ``(n, B, S, K, hd)``, the
    port's ``(n, B, K, S, hd)``, so the sequence entry sits one dim later
    here."""
    b = ctx.logical("batch")
    m = ctx.logical("model")
    seq = seq_axes if seq_axes is not None else m
    out = {}
    for name, leaf in cache_spec.items():
        nd = leaf.dim()
        if name in ("k", "v"):            # (n, B, K, S, hd)
            spec = [None] * (nd - 4) + [b, None, seq, None]
        elif name in ("xk", "xv"):        # (n, B, K, F, hd): cross KV, small
            spec = [None] * (nd - 4) + [b, None, None, None]
        elif name == "ssm":               # (n, B, H, N, P)
            spec = [None] * (nd - 4) + [b, m, None, None]
        elif name.startswith("conv"):     # (n, B, k - 1, C)
            spec = [None] * (nd - 3) + [b, None, m]
        else:
            spec = [None] * nd
        out[name] = _fit(ctx, spec, leaf.shape)
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


# ---------------------------------------------------------------------------
# Blocks over a process mesh

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names."""
    return tuple(a for e in spec for a in _entry_axes(e))


def block_index(spec_entry, mesh, coords=None) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) of a dim with
    ``spec_entry``: row-major over its axes' coordinates (``coords``, one
    an axis of ``mesh``: another rank's)."""
    i, n = 0, 1
    for a in _entry_axes(spec_entry):
        c = mesh.index(a) if coords is None else \
            coords[mesh.axis_names.index(a)]
        i = i * mesh.shape[a] + c
        n *= mesh.shape[a]
    return i, n


def block_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's block of a tensor of ``shape`` (every
    sharded dim divisible by its axes, as ``_fit`` leaves it)."""
    out = []
    for dim, size in enumerate(shape):
        _, n = block_index(spec[dim] if dim < len(spec) else None, mesh)
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"into {n} blocks ({spec})")
        out.append(size // n)
    return tuple(out)


def block_slices(shape, spec, mesh, coords=None) -> Tuple[slice, ...]:
    """This rank's block (or that of the rank at ``coords``) of a tensor
    of ``shape`` as one slice a dim."""
    size = block_shape(shape, spec, mesh)
    out = []
    for dim in range(len(shape)):
        i, _ = block_index(spec[dim] if dim < len(spec) else None, mesh,
                           coords)
        out.append(slice(i * size[dim], (i + 1) * size[dim]))
    return tuple(out)


def local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under a resolved spec
    over the process ``mesh`` (a contiguous copy)."""
    return t[block_slices(t.shape, spec, mesh)].clone(
        memory_format=torch.contiguous_format)


def gather_block(t: torch.Tensor, spec, mesh,
                 axes: Optional[Tuple[str, ...]] = None,
                 alike: Tuple[str, ...] = ()) -> torch.Tensor:
    """The inverse of ``local_block``: every dim whose axes are all in
    ``axes`` (default: every sharded dim) gathered back over them, the
    last axis first, so the blocks land row-major.  Through
    ``collectives.gather_dim``, so a gradient flows back to the block
    (summed over the ranks that gathered it); over the axes of ``alike``
    through ``collectives.gather_alike`` (the ranks along them use the
    result alike: the block's gradient is this rank's, unsummed)."""
    from repro_torch.distributed.collectives import gather_alike, gather_dim
    for dim, entry in enumerate(spec):
        ax = _entry_axes(entry)
        if not ax or (axes is not None and not set(ax) <= set(axes)):
            continue
        for a in reversed(ax):
            gather = gather_alike if a in alike else gather_dim
            t = gather(t, mesh.group(a), dim)
    return t


def gather_whole(t: torch.Tensor, spec, mesh,
                 root: int = 0) -> Optional[torch.Tensor]:
    """The whole tensor of which ``t`` is this rank's block under
    ``spec``, on rank ``root`` of the process ``mesh`` (``None`` on the
    others): one gather of every rank's block (on the host over gloo),
    each laid at its rank's coordinates.  No gradient; a quarter of the
    traffic of ``gather_block`` on every rank of a 4-rank mesh."""
    import numpy as np
    import torch.distributed as dist
    t = t.detach().contiguous()
    if mesh.backend == "gloo":
        t = t.cpu()
    me = mesh.rank == root
    blocks = [torch.empty_like(t) for _ in range(mesh.size)] if me else None
    dist.gather(t, blocks, dst=root)
    if not me:
        return None
    full = tuple(d * block_index(spec[i] if i < len(spec) else None,
                                 mesh)[1] for i, d in enumerate(t.shape))
    out = t.new_empty(full)
    dims = tuple(mesh.shape[a] for a in mesh.axis_names)
    for r, b in enumerate(blocks):
        coords = tuple(int(c) for c in np.unravel_index(r, dims))
        out[block_slices(full, spec, mesh, coords)] = b
    return out


class Placement:
    """A model's parameters over a process mesh: each one's full shape and
    spec (``named_shardings`` over ``ctx``), so this rank holds
    ``local_block`` of each."""

    def __init__(self, ctx: ShardCtx, full: Dict[str, Any], period: int):
        self.ctx = ctx
        self.mesh = ctx.mesh
        self.full = {n: tuple(t.shape) for n, t in full.items()}
        self.specs = named_shardings(ctx, full, period)

    def block_shape(self, name: str) -> Tuple[int, ...]:
        return block_shape(self.full[name], self.specs[name], self.mesh)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return local_block(t, self.specs[name], self.mesh)

    def gathered(self, name: str, t: torch.Tensor,
                 axes: Optional[Tuple[str, ...]] = None) -> torch.Tensor:
        return gather_block(t, self.specs[name], self.mesh, axes)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole of ``name`` from this rank's block ``t``, for a layer
        computed replicated over the model axis: gathered over the data
        axes (the backward sums the data shards' gradients there) and over
        ``model`` (the backward keeps this rank's block, since every model
        rank computes the same gradient of the whole)."""
        model = self.ctx.model_axis
        return gather_block(t, self.specs[name], self.mesh,
                            alike=(model,) if model else ())

    def replicated_axes(self, name: str) -> Tuple[str, ...]:
        """The mesh axes that do not split ``name``: every rank along
        them holds the same block."""
        used = spec_axes(self.specs[name])
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def counted_here(self, name: str) -> bool:
        """Whether this rank stands for its block in a sum over the whole
        mesh: the first rank along every axis that replicates it."""
        return all(self.mesh.index(a) == 0
                   for a in self.replicated_axes(name))


def places(cfg, mesh, expert_share: Optional[bool] = None) -> bool:
    """Whether ``mesh`` (a ``ProcessMesh``, or a ``ShardCtx`` over any
    mesh) places ``cfg``'s model by ``named_shardings``: a process mesh,
    but not for an MoE model that keeps the expert share (``expert_share``;
    by default, ``None``, the models with ``moe_impl="ep"``)."""
    ctx = mesh if isinstance(mesh, ShardCtx) else ShardCtx(mesh)
    if not ctx.process:
        return False
    if expert_share is None:
        expert_share = cfg.moe_impl == "ep"
    return not (cfg.family == "moe" and expert_share)


def shard_params(params: Dict[str, torch.Tensor], mesh, cfg=None,
                 expert_share: Optional[bool] = None
                 ) -> Dict[str, torch.Tensor]:
    """This rank's share of a full parameter set over a process ``mesh``
    (or a ``ShardCtx`` over one).  With a ``cfg`` that ``mesh`` places
    (``places(cfg, mesh, expert_share)``): every tensor's ``local_block``
    under ``named_shardings``.  Otherwise (no ``cfg``, or the expert
    share) each MoE layer's ``wi``, ``wg`` and ``wo`` cut to the rank's
    experts, every other tensor as it is (replicated).  Blocks are
    copies, so the full tensors can be freed."""
    ctx = mesh if isinstance(mesh, ShardCtx) else ShardCtx(mesh)
    if cfg is not None and places(cfg, mesh, expert_share):
        from repro_torch.models.transformer import layer_plan
        place = Placement(ctx, params, len(layer_plan(cfg)))
        return {n: place.local(n, t) for n, t in params.items()}
    mesh = ctx.mesh
    out = {}
    for name, t in params.items():
        rows = (expert_rows(mesh, t.shape[0])
                if _EXPERT_WEIGHT.search(name) else None)
        out[name] = t if rows is None else t[rows].clone()
    return out
