"""Serving entry point: Hermes end to end on the real inference engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --apps 12 --policy gittins

Builds the PDGraph knowledge base, spins up the inference engine with
prefix/LoRA pools, converts each application's LLM units into real engine
requests (non-LLM units are host-side sleeps scaled down), and serves them
under the chosen policy with Hermes prewarming — the whole Fig. 4
architecture, with real tensors.

The port of the JAX package's ``launch/serve.py``, step for step.  The
scheduler and the engine run on ``device`` (``cuda`` unless the caller asks
for the CPU); the model is ``cfg`` (the tiny Llama-3 of the reference when
``None``) with random weights drawn on the device from seed 0.  The
scheduler is built bare, as the reference's is, so it runs the ``composed``
refresh: threefry host samples ranked on the host, the reference's ranks
bit for bit.  ``run``
returns the engine, the model and the scheduler for callers that measure
them; ``main`` is the command line.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.apps.suite import SUITE, build_knowledge_base
from repro_torch.apps.workload import make_workload
from repro_torch.config import ModelConfig
from repro_torch.core.scheduler import HermesScheduler
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model, build_model
from repro_torch.serving.engine import (InferenceEngine, Request,
                                        check_token_only)
from repro_torch.serving.lora import make_random_adapter
from repro_torch.testing import tiny_config

# engine-scale token costs (tiny model on CPU)
T_IN = 2e-4
T_OUT = 2e-3
SCALE_TOKENS = 0.02          # scale app token counts down to engine scale


@dataclass
class ServeRun:
    n_apps: int
    engine: InferenceEngine
    model: Model
    sched: HermesScheduler
    init_s: float             # model construction and weight draw, seconds


def run(argv=None, *, cfg: Optional[ModelConfig] = None,
        device: DeviceLike = None) -> ServeRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--apps", type=int, default=10)
    ap.add_argument("--policy", default="gittins")
    ap.add_argument("--window", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = cfg if cfg is not None else tiny_config("llama3-8b")
    check_token_only(cfg)       # before anything is built
    dev = resolve_device(device)

    kb = build_knowledge_base(n_trials=150, seed=3)
    insts = make_workload(args.apps, args.window, seed=args.seed,
                          t_in=T_IN, t_out=T_OUT)
    sched = HermesScheduler(kb, policy=args.policy, t_in=T_IN, t_out=T_OUT,
                            mc_walkers=128, device=dev)

    t0 = time.perf_counter()
    model = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    params = model.params()
    prefixes: Dict[str, List[int]] = {}
    rngp = np.random.default_rng(7)
    for app in SUITE.values():
        for unit in app.units.values():
            if unit.backend.prefix:
                prefixes[unit.backend.prefix] = \
                    rngp.integers(1, cfg.vocab_size, size=24).tolist()
    eng = InferenceEngine(model, params, max_slots=4, max_seq=192,
                          prefix_prompts=prefixes)
    for app in SUITE.values():
        for unit in app.units.values():
            if unit.backend.lora and unit.backend.lora not in eng.lora.adapters:
                eng.lora.register(make_random_adapter(unit.backend.lora, params))

    t_start = time.monotonic()
    acts = {}
    rng = np.random.default_rng(args.seed)
    for inst in insts:
        sched.on_arrival(inst.app_id, inst.app_name, time.monotonic() - t_start)
        for unit, obs in inst.trajectory:
            node = kb[inst.app_name].units[unit]
            now = time.monotonic() - t_start
            sched.on_unit_start(inst.app_id, unit, now)
            # fire prewarm signals for downstream units
            for sig in sched.prewarm_signals(
                    inst.app_id, now,
                    lambda k: 0.05,
                    lambda k: (k.startswith("kv:") and k[3:] in eng.prefix.entries)
                    or (k.startswith("lora:") and eng.lora.is_warm(k[5:]))):
                key = sig.resource_key
                if key.startswith("kv:"):
                    eng.prewarm_prefix(key[3:])
                elif key.startswith("lora:"):
                    eng.prewarm_lora(key[5:])
            if node.backend.kind == "llm":
                n_out = max(2, int(obs["out"] * SCALE_TOKENS))
                ranks = sched.priorities(now)
                for j in range(int(obs["par"])):
                    eng.submit(Request(
                        req_id=f"{inst.app_id}.{unit}.{j}",
                        prompt=rng.integers(1, cfg.vocab_size, size=8).tolist(),
                        max_new_tokens=n_out, app_id=inst.app_id,
                        lora_id=node.backend.lora,
                        prefix_id=node.backend.prefix))
                eng.run(rank_fn=lambda r: ranks.get(r.app_id, 1e9))
                svc = obs["par"] * (obs["in"] * T_IN + obs["out"] * T_OUT)
            else:
                time.sleep(min(obs["dur"] * 0.002, 0.05))
                svc = obs["dur"]
            sched.on_progress(inst.app_id, svc)
        # final unit bookkeeping
        last_unit = inst.trajectory[-1][0]
        sched.on_unit_finish(inst.app_id, last_unit, inst.trajectory[-1][1],
                             time.monotonic() - t_start, None)
        acts[inst.app_id] = time.monotonic() - t_start - 0.0

    done = {r.req_id: r for r in eng.done}
    hits = sum(1 for r in eng.done if r.prefix_hit)
    total_p = sum(1 for r in eng.done if r.prefix_id)
    print(f"[serve] {len(insts)} apps, {len(done)} llm requests served")
    print(f"[serve] prefix hit ratio: {hits}/{total_p} "
          f"({hits/max(total_p,1):.0%}); lora merges: {eng.lora.merges}")
    print(f"[serve] mean ttft: "
          f"{1000*np.mean([r.ttft for r in eng.done if r.ttft]):.0f} ms")
    return ServeRun(len(insts), eng, model, sched, init_s)


def main(argv=None, *, cfg: Optional[ModelConfig] = None,
         device: DeviceLike = None) -> int:
    run(argv, cfg=cfg, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
