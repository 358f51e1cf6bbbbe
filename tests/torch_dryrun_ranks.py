"""What each rank of the spawned world of ``test_torch_dryrun.py`` runs.

Every function here runs inside one rank of a ``launch.procs.spawn`` world
of 4 processes on the CPU (gloo) and imports only the port.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import TrainConfig
from repro_torch.configs import PERF_PRESETS
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.launch.mesh import init_process_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model
from repro_torch.testing import tiny_config
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_loop import run_training

AXES = ("data", "model")
EP_ARCH = "qwen2-moe-a2.7b"
STEPS = 2


def ep_preset():
    """The tiny float32 Qwen1.5-MoE under its ``PERF_PRESETS`` entry
    (``moe_impl="ep"``, ``remat=False``), in two microbatches: the
    preset's 16 do not split the test's 8 rows."""
    return tiny_config(EP_ARCH, dtype="float32",
                       **dict(PERF_PRESETS[EP_ARCH], microbatch=2))


def train_config() -> TrainConfig:
    return TrainConfig(warmup_steps=1)


def data_config() -> DataConfig:
    return DataConfig(vocab_size=256, seq_len=16, global_batch=8, seed=23)


def run_world(_inp) -> Dict[str, Any]:
    """``run_training(mesh=)`` of the EP preset over (2, 2), and the same
    steps by hand from the placed model ``run_training`` builds (its
    weights drawn from the data seed): the losses of both, the placed
    model's expert count and the first step's gradient blocks."""
    pm = init_process_mesh((2, 2), AXES, backend="gloo", device="cpu")
    cfg, tcfg, dcfg = ep_preset(), train_config(), data_config()
    rep = run_training(cfg, tcfg, dcfg, total_steps=STEPS, device="cpu",
                       mesh=pm, verbose=False)
    model = build_model(cfg, device="cpu", mesh=pm, expert_share=False).init(
        torch.Generator(device="cpu").manual_seed(dcfg.seed)).trainable()
    step = make_train_step(model, tcfg)
    params = model.params()
    state = init_opt_state(params, cfg.opt_state_dtype)
    losses, first = [], None
    for s in range(STEPS):
        loss, grads = step.gradients(params, batch_at(dcfg, s))
        if first is None:
            first = {n: g.detach().numpy().copy() for n, g in grads.items()}
        params, state, _ = step.apply(params, state, loss, grads)
        losses.append(float(loss))
    return {"rank": pm.rank, "coords": pm.coords,
            "run_training": rep.losses, "by_hand": losses,
            "experts": int(model.layers[0].moe.wi.shape[0]),
            "placed": model.placement is not None,
            "specs": {n: tuple(s) for n, s in model.placement.specs.items()},
            "grads": first}
