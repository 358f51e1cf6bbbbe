"""RefreshConfig: the one validated construction surface for the refresh
backbone.

The knobs that select and tune the priority-refresh pipeline — ``mode``,
``walker``, ``mesh_shards``, ``delta_full_threshold``,
``queue_delay_correction``, ``rank_in_kernel``, ``lane_balance`` — live in
one frozen dataclass with the reference's value names, so one config object
means the same thing in both packages.  Build one and pass it to either
entry point::

    from repro_torch.core.refresh_config import RefreshConfig
    from repro_torch.core.scheduler import HermesScheduler
    from repro_torch.serving.simulator import SimConfig

    rc = RefreshConfig(mode="fused_delta", walker="pallas")
    sched = HermesScheduler(kb, policy="gittins", refresh=rc)
    cfg = SimConfig(policy="gittins", refresh=rc)

Every validation rule lives in exactly one place,
``RefreshConfig.__post_init__``.  Values outside the port's slice pass
validation here and raise ``NotImplementedError`` when the scheduler is
built.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

MODES = ("looped", "composed", "fused", "fused_delta")
WALKERS = ("pallas", "threefry")


@dataclass(frozen=True)
class RefreshConfig:
    """Validated refresh-backbone configuration (see module docstring).

    mode
        ``looped`` (seed per-app walk), ``composed`` (PR-1 batched walk),
        ``fused`` (one device dispatch per tick), ``fused_delta`` (the
        default: dirty-set delta refresh over the persistent slot arena).
    walker
        Fused-mode MC backend: ``pallas`` (counter-RNG kernel package,
        fastest) or ``threefry`` (bit-identical streams to composed/looped).
    mesh_shards
        Partition the slot arena across this many mesh devices (power of
        two; requires ``mode="fused_delta"``).  ``None`` keeps the
        single-arena pipeline; ``1`` runs the mesh pipeline on a degenerate
        one-device mesh (the scaling baseline).
    delta_full_threshold
        Dirty fraction past which a delta tick falls back to re-walking the
        whole occupied set (the subset gather/scatter stops paying).
    queue_delay_correction
        §3.4 refinement: condition prewarm trigger times on each app's
        observed wall/service stretch EWMA instead of assuming continuous
        execution.  Off by default (the paper model).
    rank_in_kernel
        One-pass VMEM-resident refresh: the walk, the demand-histogram
        reduction, and the Gittins rank run as ONE dispatch
        (``pdgraph_walk_ranked``) instead of walk → ``(A, W)`` totals
        round-trip → histogram → rank.  ``None`` (default) resolves to
        ``True`` when ``walker="pallas"`` and ``False`` for ``threefry``
        (the threefry walker has no fused program — asking for both is an
        error).  Bit-identical to the composed pipeline either way.
    lane_balance
        Mesh walker-lane balancing threshold (requires ``mesh_shards``):
        when ``max(per-shard dirty count) > (1 + lane_balance) * mean``,
        the tick redistributes walker lanes round-robin across shards and
        all-gathers the packed result rows back to their owners, trading
        one collective for the straggler gap.  ``0.0`` balances every
        tick; ``None`` (default) keeps shard-local walks.
    """
    mode: str = "fused_delta"
    walker: str = "pallas"
    mesh_shards: Optional[int] = None
    delta_full_threshold: float = 0.5
    queue_delay_correction: bool = False
    rank_in_kernel: Optional[bool] = None
    lane_balance: Optional[float] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown refresh mode {self.mode!r}; "
                             f"known: {MODES}")
        if self.walker not in WALKERS:
            raise ValueError(f"unknown fused walker {self.walker!r}; "
                             f"known: {WALKERS}")
        if self.mesh_shards is not None:
            # the one rule that used to live only in HermesScheduler — now
            # both entry points (and any direct construction) share it
            if self.mode != "fused_delta":
                raise ValueError("mesh_shards requires mode='fused_delta' "
                                 f"(got mode={self.mode!r})")
            n = self.mesh_shards
            if n < 1 or n & (n - 1):
                raise ValueError("mesh_shards must be a power of two, "
                                 f"got {n}")
        if self.rank_in_kernel is None:
            object.__setattr__(self, "rank_in_kernel",
                               self.walker == "pallas")
        elif self.rank_in_kernel and self.walker != "pallas":
            raise ValueError(
                "rank_in_kernel=True requires walker='pallas' (the "
                f"{self.walker!r} walker has no fused one-pass program)")
        if self.lane_balance is not None:
            if self.mesh_shards is None:
                raise ValueError("lane_balance requires mesh_shards "
                                 "(it balances walker lanes across shards)")
            if self.lane_balance < 0.0:
                raise ValueError("lane_balance must be >= 0, "
                                 f"got {self.lane_balance}")
        if not 0.0 <= self.delta_full_threshold <= 1.0:
            raise ValueError("delta_full_threshold must be in [0, 1], "
                             f"got {self.delta_full_threshold}")

