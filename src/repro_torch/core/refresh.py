"""DEPRECATED facade over the split refresh backbone.

The PyTorch counterpart of ``repro.core.refresh``, the reference's
deprecation shim: every attribute access re-exports the symbol from its
real home in this package and emits a :class:`DeprecationWarning` that
names that home.  Import directly from:

* :mod:`repro_torch.core.arena` — the persistent slot store
  (``QueueState``): slot lifecycle (admit/retire/free-lists), dirty
  tracking, shard placement and the repack epoch.
* :mod:`repro_torch.core.refresh_pipeline` — the device pipelines: MC walk
  → histogram → Gittins rank → triage → prewarm triggers, plus the
  single-device ``refresh_ranks_fused`` / ``refresh_ranks_delta`` entry
  points.
* :mod:`repro_torch.core.refresh_mesh` — ``RefreshMesh``: the same
  pipeline over the shards of a sharded arena.

The private names the reference's shim also re-exports are served where
the port has them (``_arrival_hists``, ``_delta_pipeline``,
``_fused_pipeline``, ``_prewarm_triggers`` and ``_walk_total`` have no
counterpart of that name here).
"""
import importlib
import warnings

_HOMES = {
    "repro_torch.core.arena": ("QueueState", "build_queue_state"),
    "repro_torch.core.refresh_pipeline": (
        "DeltaTick", "FusedRefresh", "_dispatch_rows", "_prewarm_args",
        "_store_results", "_triage_stats", "_triggers_from_hists",
        "refresh_ranks_delta", "refresh_ranks_fused"),
    "repro_torch.core.refresh_mesh": ("MeshTick", "RefreshMesh",
                                      "refresh_ranks_mesh"),
}
_HOME_OF = {name: mod for mod, names in _HOMES.items() for name in names}

__all__ = [
    "QueueState", "build_queue_state",
    "FusedRefresh", "DeltaTick", "refresh_ranks_fused", "refresh_ranks_delta",
    "MeshTick", "RefreshMesh", "refresh_ranks_mesh",
]


def __getattr__(name):
    home = _HOME_OF.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    warnings.warn(
        f"repro_torch.core.refresh is deprecated; import {name} from {home}",
        DeprecationWarning, stacklevel=2)
    return getattr(importlib.import_module(home), name)


def __dir__():
    return sorted(__all__)
