#!/usr/bin/env python3
"""Build the PyTorch/CUDA port (``src/repro_torch``) on one GPU and drive it.

    python3 chip_smoke.py                 # every phase, full size
    python3 chip_smoke.py --sim-apps 300  # a shorter main-path trace

Phases (any failure raises and the script exits non-zero):

1. build the port's CUDA source and print ptxas's register /
   shared-memory / spill report;
2. the main path: ``run_sim`` on an open-arrival trace at ``SimConfig()``
   defaults on ``cuda``, with every kernel launch counter set to 0 just
   before and read just after;
3. hold each kernel against its plain PyTorch version on the card
   (bitwise) at 4,096 apps, first at the main path's walker count and
   override width as phase 2 left them, then at W=512 with override width
   64; time both with CUDA events;
4. one delta refresh tick on a 16,384-slot arena with 8 % dirty slots and
   prewarming on at the main path's walker count, timed and profiled;
5. the same small trace on ``cuda`` and on the CPU (the plain versions):
   identical completion order and ACTs.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository around it, it exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet and Hopper white paper), in
# the units the bound counts: HBM3 bytes/s; float32 instructions/s outside
# the tensor cores (the data sheet's 67 TFLOP/s counts an FMA as two, the
# kernel's compares and adds are one each); int32 instructions/s (64 of the
# 128 lanes per SM)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 33.5e12
PEAK_I32_S = 16.7e12


def log(*a) -> None:
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.pdgraph_walk import kernel as walk_kernel
    t0 = time.perf_counter()
    lib, text = build.build(walk_kernel.SOURCE)
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in (text or "(library already built)").strip().splitlines():
        log(f"[build:{walk_kernel.SOURCE.stem}] {line}")


def _kernel_inputs(device, A, So, seed=11):
    """Queue rows: random graphs and positions, overrides of up to ``So``
    samples on a quarter of the rows, a few padding rows."""
    import numpy as np
    import torch
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.core.pdgraph import pack_graphs
    from repro_torch.kernels.pdgraph_walk.ref import walker_streams
    kb = build_knowledge_base(n_trials=100, seed=3)
    packed = pack_graphs(kb, T_IN, T_OUT, device=device)
    G, U, S = packed.samples.shape
    rng = np.random.default_rng(seed)
    gi = rng.integers(0, G, A).astype(np.int32)
    start = np.where(rng.random(A) < 0.5, packed.entry[gi],
                     rng.integers(0, U, A)).astype(np.int32)
    ex = rng.uniform(0.0, 2.0, A).astype(np.float32)
    att = rng.uniform(0.0, 30.0, A).astype(np.float32)
    valid = np.ones(A, bool)
    valid[-A // 64:] = False
    ovs = np.zeros((A, U, So), np.float32)
    ovc = np.zeros((A, U), np.int32)
    for a in range(0, A, 4):
        u = int(rng.integers(0, U))
        n = int(rng.integers(1, So + 1))
        ovc[a, u] = n
        ovs[a, u, :n] = rng.uniform(0.05, 20.0, n)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    streams = walker_streams(7, np.arange(A), rng.integers(0, 9, A),
                             device=device)
    return packed, dict(graph_idx=t(gi), start=t(start), executed=t(ex),
                        streams=streams, attained=t(att),
                        ov_samples=t(ovs), ov_counts=t(ovc), valid=t(valid))


def _check_kernel(device, A, W, So, STEPS=64, NB=10):
    """The fused walk against its plain version at one shape: bitwise on
    every output, both timed, and the bound from this run's inputs.  The
    kernel's time is that of its wrapper on operands converted beforehand;
    ``ops_ms`` adds the conversions ``pdgraph_walk_ranked`` makes per call."""
    import torch
    from repro_torch.kernels.pdgraph_walk import kernel, ops
    packed, rows = _kernel_inputs(device, A, So)
    G, U, S = packed.samples.shape
    tag = f"[kernel:pdgraph_walk_fused A={A} W={W} So={So}]"

    def call(fn):
        r = rows
        return fn(packed.samples, packed.counts, packed.cum_trans,
                  r["graph_idx"], r["start"], r["executed"], r["streams"],
                  r["attained"], r["ov_samples"], r["ov_counts"],
                  valid=r["valid"], n_walkers=W, max_steps=STEPS,
                  n_buckets=NB, track_arrivals=True)

    r = rows
    operands = ops.kernel_operands(
        packed.samples, packed.counts, packed.cum_trans, r["graph_idx"],
        r["start"], r["executed"], r["streams"], r["attained"],
        r["ov_samples"], r["ov_counts"], r["valid"])

    def launch():
        return kernel.pdgraph_walk_fused_kernel(
            *operands, n_walkers=W, max_steps=STEPS, n_buckets=NB,
            with_arrivals=True, with_total=False)

    kern = call(ops.pdgraph_walk_ranked)
    plain = call(ops.pdgraph_walk_ranked_plain)
    torch.cuda.synchronize()
    keys = ("probs", "edges", "ranks", "a_hist", "a_lo", "a_span", "a_reach")
    err = 0.0
    for k in keys:
        same = torch.equal(kern[k], plain[k])
        d = float((kern[k] - plain[k]).abs().max())
        err = max(err, d)
        log(f"{tag} {k:8s} {tuple(kern[k].shape)} bitwise={same} "
            f"max_abs_err={d}")
        if not same:
            raise AssertionError(f"pdgraph_walk_fused (W={W}, So={So}): {k} "
                                 f"differs from the plain version (max abs "
                                 f"err {d})")
    if not torch.equal(launch()["ranks"], kern["ranks"]):
        raise AssertionError("pdgraph_walk_fused: the wrapper on converted "
                             "operands disagrees with pdgraph_walk_ranked")
    ms = cuda_time_ms(launch, iters=50)
    ops_ms = cuda_time_ms(lambda: call(ops.pdgraph_walk_ranked), iters=50)
    # the kernel's own device time (no host gaps), to tell whether the
    # event timings above are set by the host
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            launch()
        torch.cuda.synchronize()
    dev_ms = [e.self_device_time_total / e.count / 1e3
              for e in prof.key_averages() if "walk_fused_kernel" in e.key]
    plain_ms = cuda_time_ms(lambda: call(ops.pdgraph_walk_ranked_plain),
                            iters=3, warmup=1)
    # the least the card could take: every input read once, every output
    # written once; operations counted per walker-step this data needs
    in_bytes = 4 * (G * U * S + G * U + G * U * (U + 1)
                    + A * U * So + A * U + 5 * A) + A
    out_bytes = 4 * (2 * A * NB + A + A * U * (NB + 3))
    steps = plain["walker_steps"]
    f_ops = steps * (9 + (U + 1)) + A * W * 4 + A * 3 * NB * NB
    i_ops = steps * 16 + A * W * 4
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_S
    t_ops = max(f_ops / PEAK_F32_S, i_ops / PEAK_I32_S)
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"{tag} max_steps={STEPS} walker_steps={steps} (mean "
        f"{steps / (A * W):.2f}) bytes={in_bytes + out_bytes} "
        f"f32_ops={f_ops} i32_ops={i_ops}")
    log(f"{tag} kernel {ms:.4f} ms  ops {ops_ms:.4f} ms  plain "
        f"{plain_ms:.3f} ms  bound {bound_ms:.6f} ms ({bound_by})  "
        f"profiled device ms/launch {dev_ms}")
    return {"name": "pdgraph_walk_fused", "route": "cuda",
            "source": "src/repro_torch/kernels/pdgraph_walk/csrc/"
                      "walk_fused.cu",
            "replaces": "src/repro/kernels/pdgraph_walk/kernel.py:297",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_kernels(device, main_W, main_So):
    """Each kernel against its plain version: at the main path's walker
    count and override width (the shape its launches there had), and at
    the W=512 cell.  Returns the main-path shape's entry."""
    entry = _check_kernel(device, 4096, main_W, main_So)
    _check_kernel(device, 4096, 512, 64)
    return [entry]


def phase_delta_tick(device, W):
    """One delta tick on a 16,384-slot arena, 8 % of the slots dirty."""
    import numpy as np
    import torch
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.core.arena import QueueState
    from repro_torch.core.hermeslet import warmup_time_for
    from repro_torch.core.pdgraph import pack_graphs
    from repro_torch.core.prewarm import build_prewarm_table
    from repro_torch.core.refresh_pipeline import refresh_ranks_delta
    from repro_torch.kernels import LAUNCHES, reset_launches
    CAP, DIRTY = 16384, 0.08
    kb = build_knowledge_base(n_trials=100, seed=3)
    packed = pack_graphs(kb, T_IN, T_OUT, device=device)
    tab = build_prewarm_table(kb, packed, warmup_time_for)
    qs = QueueState(packed, capacity=CAP)
    rng = np.random.default_rng(4)
    gi = rng.integers(0, len(packed.names), CAP)
    qs.admit_many([(f"a{i}", int(g), int(packed.entry[g]), i, None)
                   for i, g in enumerate(gi)])
    kw = dict(n_walkers=W, prewarm_table=tab, prewarm_k=0.5)
    refresh_ranks_delta(packed, qs, 0, walked=qs.take_dirty(), **kw)
    n_dirty = int(DIRTY * CAP)
    times = []
    reset_launches()
    for rep in range(6):
        for s in rng.choice(CAP, n_dirty, replace=False):
            qs.add_progress(qs.ids[s], 0.25)
            qs.set_unit(qs.ids[s], int(rng.integers(0, packed.n_units)))
        walked = qs.take_dirty()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick = refresh_ranks_delta(packed, qs, 0, walked=walked, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        qs.bump_refresh(walked)
        if not np.isfinite(tick.ranks[qs.occupied()]).all():
            raise AssertionError("delta tick produced non-finite ranks")
    log(f"[delta_tick] cap={CAP} dirty={n_dirty} W={W} prewarm=on "
        f"ms/tick median={statistics.median(times[1:]):.3f} "
        f"min={min(times[1:]):.3f} all={['%.3f' % t for t in times]} "
        f"launches={dict(LAUNCHES)}")
    # where one tick's time goes: device time by operator (torch.profiler)
    from torch.profiler import ProfilerActivity, profile
    for s in rng.choice(CAP, n_dirty, replace=False):
        qs.set_unit(qs.ids[s], int(rng.integers(0, packed.n_units)))
    walked = qs.take_dirty()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        refresh_ranks_delta(packed, qs, 0, walked=walked, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, copies): CPU operators carry the
    # same device time again
    evs = sorted((e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in evs)
    log(f"[delta_tick:profile] wall={wall:.3f} ms (profiled) device_busy="
        f"{total / 1e3:.3f} ms device_ops={sum(e.count for e in evs)}")
    for e in evs[:8]:
        log(f"[delta_tick:profile]   {e.key[:60]:60s} "
            f"device={e.self_device_time_total / 1e3:.3f} ms "
            f"calls={e.count}")


def _trace(n_apps):
    from repro_torch.apps.suite import T_IN, T_OUT
    from repro_torch.apps.workload import make_open_workload
    return make_open_workload(4000.0, t_in=T_IN, t_out=T_OUT,
                              target_load=0.85, n_service_slots=128,
                              process="gamma", cv=2.5, tenants=16, seed=1,
                              max_apps=n_apps)


def phase_main_path(device, n_apps):
    """run_sim at SimConfig() defaults (fused_delta, pallas walker, rank in
    kernel, hermes prewarm) over 128 LLM slots on the card.  Returns the
    launch counts, the walker count and the arena's override width."""
    import numpy as np
    import torch
    from repro_torch.apps.suite import build_knowledge_base
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.simulator import ClusterSim, SimConfig
    kb = build_knowledge_base(n_trials=100, seed=3)
    insts = _trace(n_apps)
    if n_apps < 2100:
        log(f"[main_path] trace cut to {len(insts)} apps (--sim-apps)")
    cfg = SimConfig(n_llm_slots=128, n_docker_slots=256, n_dnn_slots=24,
                    kv_capacity=128, lora_capacity=64, docker_capacity=256,
                    dnn_capacity=16, seed=2)
    sim = ClusterSim(kb, cfg)
    reset_launches()
    t0 = time.perf_counter()
    res = sim.run(insts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    qs = sim.sched._qstate
    on_card = all(t is not None and t.is_cuda for t in
                  (sim.sched._packed[1].samples, qs.d_probs, qs.d_edges,
                   qs.a_hist))
    acts = res.act_values()
    ov_width = int(qs.ov_samples.shape[2])
    log(f"[main_path] W={cfg.mc_walkers} override_width={ov_width} "
        f"apps={len(insts)} completed={len(res.acts)} "
        f"mean_act={res.mean_act():.3f} s p95_act={res.p95_act():.3f} s "
        f"ticks={res.policy_calls} ms/tick="
        f"{1e3 * res.policy_time_s / max(res.policy_calls, 1):.3f} "
        f"wall={wall:.1f} s launches={launches} arena_on_cuda={on_card}")
    if len(res.acts) != len(insts) or not np.isfinite(acts).all() \
            or (acts <= 0).any():
        raise AssertionError("main path: not every application completed "
                             "with a finite positive ACT")
    if not on_card:
        raise AssertionError("main path: arena tensors are not on cuda")
    if min(launches.values()) <= 0:
        raise AssertionError(f"main path did not launch every kernel: "
                             f"{launches}")
    return launches, cfg.mc_walkers, ov_width


def phase_reference():
    """A small trace on the card and on the CPU: the kernel path and the
    plain path must schedule identically."""
    import numpy as np
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.apps.workload import make_workload
    from repro_torch.serving.simulator import SimConfig, run_sim
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = run_sim(build_knowledge_base(n_trials=40, seed=3),
                           make_workload(30, 120.0, seed=29, t_in=T_IN,
                                         t_out=T_OUT),
                           SimConfig(seed=5, n_llm_slots=8, mc_walkers=32,
                                     device=dev))
    g, c = out["cuda"], out["cpu"]
    same = g.completion_order == c.completion_order
    ga = np.asarray([g.acts[a] for a in c.completion_order])
    ca = np.asarray([c.acts[a] for a in c.completion_order])
    rel = float(np.max(np.abs(ga - ca) / np.abs(ca)))
    log(f"[reference] 30-app trace cuda vs cpu: completion_order_equal="
        f"{same} max_rel_act_diff={rel}")
    if not same or rel > 1e-6:
        raise AssertionError("cuda and cpu runs of the small trace differ")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sim-apps", type=int, default=2100,
                    help="applications in the main-path trace")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run this from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build()
    launches, W, ov_width = phase_main_path(dev, args.sim_apps)
    kernels = phase_kernels(dev, W, ov_width)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase_delta_tick(dev, W)
    phase_reference()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
