"""Training loop: the train step, checkpoint/restart and the straggler
watchdog, with optional microbatch accumulation and int8 gradient
compression.

The port of the JAX package's ``training/train_loop.py``.
``run_training`` is the restartable inner driver of ``launch/train.py``:
it restores the latest checkpoint if there is one, then steps until
``total_steps``, checkpointing every ``checkpoint_every``.  The first
weights are drawn from ``torch.Generator(device).manual_seed(dcfg.seed)``
(the reference draws from ``PRNGKey(dcfg.seed)``; the two differ), so a
run matches the reference step by step from the same weights, not from
the same seed.  Over a process mesh (``mesh=``, a ``ProcessMesh`` or a
``ShardCtx`` over one) the model is placed (``sharding.places``; an MoE
model with ``moe_impl="ep"`` too, built with ``expert_share=False``, so
its EP body runs on its placed share of the experts) and every rank
runs the loop on its blocks: the same global batches, checkpoints
gathered whole (rank 0 writes them) and restored onto whatever mesh the
restart has.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.checkpoint.checkpointing import CheckpointManager, latest_step
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, batch_at, side_inputs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import P, places
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 StragglerWatchdog)
from repro_torch.training.optimizer import AdamState, init_opt_state


@dataclass
class TrainReport:
    losses: List[float] = field(default_factory=list)
    steps_run: int = 0
    restarts: int = 0
    straggler_steps: List[int] = field(default_factory=list)
    wall_s: float = 0.0
    step_s: List[float] = field(default_factory=list)  # host clock a step


def run_training(cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig, *,
                 total_steps: int, ckpt_dir: Optional[str] = None,
                 injector: Optional[FailureInjector] = None,
                 log_every: int = 10,
                 report: Optional[TrainReport] = None,
                 verbose: bool = True,
                 device: DeviceLike = None, mesh=None) -> TrainReport:
    """Train ``cfg`` on ``dcfg``'s stream on ``device`` (``cuda`` unless
    the caller asks for the CPU; over ``mesh``, this rank's device).  A
    step's time runs from its batch to its loss on the host (which waits
    for the device)."""
    report = report or TrainReport()
    dev = resolve_device(device)
    t0 = time.time()
    if mesh is not None and not places(cfg, mesh, expert_share=False):
        raise ValueError(f"{cfg.name}: run_training over a mesh trains a "
                         "placed model: give a process mesh")
    # an EP model is placed too (expert_share=False: its experts split by
    # named_shardings), the reference's GSPMD placement around its body
    model = build_model(cfg, device=dev, mesh=mesh,
                        expert_share=False).init(
        torch.Generator(device=dev).manual_seed(dcfg.seed)).trainable()
    params = model.params()
    opt_state = init_opt_state(params, cfg.opt_state_dtype)
    place = model.placement
    ckw = {}
    if place is not None:
        ckw = dict(mesh=place.mesh, shardings=(
            place.specs, AdamState(P(), place.specs, place.specs)))
    start = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr is not None and latest_step(ckpt_dir) is not None:
        (saved, opt_state), extra = mgr.restore_latest((params, opt_state),
                                                       **ckw)
        model.load_params(saved)
        start = int(extra["step"]) + 1
        report.restarts += 1
        if verbose:
            print(f"[train] restored step {start - 1}, resuming")

    step_fn = make_train_step(model, tcfg)
    watchdog = StragglerWatchdog()

    try:
        for step in range(start, total_steps):
            ts = time.time()
            batch = batch_at(dcfg, step)
            batch.update(side_inputs(cfg, dcfg, step))
            if injector is not None:
                injector.maybe_fail(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            report.losses.append(loss)
            report.steps_run += 1
            dt = time.time() - ts
            report.step_s.append(dt)
            if watchdog.record(dt):
                report.straggler_steps.append(step)
            if mgr is not None and (step + 1) % tcfg.checkpoint_every == 0:
                mgr.save(step, (params, opt_state), {"step": step}, **ckw)
            if verbose and step % log_every == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({dt*1000:.0f} ms)", flush=True)
    finally:
        # a failure waits for the save in flight, so a restart finds the
        # checkpoint it would have found (the reference's loop does not:
        # a restart that comes before the save is published starts over)
        if mgr is not None:
            mgr.wait()
    if mgr is not None:
        mgr.save(total_steps - 1, (params, opt_state),
                 {"step": total_steps - 1}, blocking=True, **ckw)
    report.wall_s = time.time() - t0
    return report


def run_training_with_restarts(cfg: ModelConfig, tcfg: TrainConfig,
                               dcfg: DataConfig, *, total_steps: int,
                               ckpt_dir: str,
                               injector: Optional[FailureInjector] = None,
                               max_restarts: int = 3,
                               verbose: bool = True,
                               device: DeviceLike = None) -> TrainReport:
    """Outer supervisor: restart from the checkpoint on (injected)
    failures — the single-host stand-in for a cluster controller's
    restart loop.  A device that cannot run raises at once."""
    report = TrainReport()
    device = resolve_device(device)
    for _attempt in range(max_restarts + 1):
        try:
            return run_training(cfg, tcfg, dcfg, total_steps=total_steps,
                                ckpt_dir=ckpt_dir, injector=injector,
                                report=report, verbose=verbose,
                                device=device)
        except Exception as e:  # noqa: BLE001 — supervisor catches anything
            if verbose:
                print(f"[train] failure: {e!r}; restarting from checkpoint")
            continue
    raise RuntimeError("exceeded max_restarts")
