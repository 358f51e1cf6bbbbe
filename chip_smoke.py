#!/usr/bin/env python3
"""Build the PyTorch/CUDA port (``src/repro_torch``) on one GPU and drive it.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --sim-apps 2100  # the full 2,100-app trace
    python3 chip_smoke.py --sim-apps 300   # shorter main-path traces

Phases (any failure raises and the script exits non-zero):

1. build every CUDA source of the port, one ``nvcc`` each, all at once,
   and print ptxas's register / shared-memory / spill report;
2. the main path: ``run_sim`` on an open-arrival trace at ``SimConfig()``
   defaults on ``cuda`` (the fused walk kernel, K1), with every kernel
   launch counter set to 0 just before and read just after.  The trace is
   the first 1,400 applications of a 2,100-app trace by default, so that
   this phase and the next, which runs the same trace, fit the script's
   time; ``--sim-apps 2100`` runs all of it;
3. the composed path: the same trace with ``RefreshConfig(rank_in_kernel=
   False)`` (the per-phase walk kernel, K2, with compaction between
   phases), counters reset and read around it; its completion order and
   ACTs must equal phase 2's;
4. the posterior path: the drift benchmark's full scenario with online
   posterior learning (K1 with posterior operands) on ``cuda``, counters
   reset and read around it, and on the CPU: identical completion order,
   ACTs within 1e-6 relative;
5. hold each kernel against its plain PyTorch version on the card
   (bitwise) at 4,096 apps: K1 at the main path's walker count and
   override width as phase 2 left them and at W=512 with override width
   64; K1 with posterior tables; K2 launch by launch through a compacted
   walk and once single-phase with posterior tables; time each with CUDA
   events;
6. delta refresh ticks on a 16,384-slot arena with 8 % dirty slots and
   prewarming on at the main path's walker count, with the rank in the
   kernel and composed from K2, from the same arena state: bitwise equal,
   timed and profiled;
7. a small trace on ``cuda`` and on the CPU (the plain versions):
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


def device_ms(launch, kernel_name: str, iters: int = 10) -> float:
    """The kernel's own device time per launch (torch.profiler), free of
    the host gaps between launches that CUDA events also measure when the
    wrapper's host work outlasts the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            launch()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel_name in e.key]
    if not evs:
        raise AssertionError(f"the profiler saw no {kernel_name} launch")
    return sum(e.self_device_time_total for e in evs) / iters / 1e3


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.pdgraph_walk import kernel as walk_kernel
    t0 = time.perf_counter()
    built = build.build_all(walk_kernel.SOURCES)
    log(f"[build] {[lib.name for lib, _ in built]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, (lib, text) in zip(walk_kernel.SOURCES, built):
        for line in (text or "(library already built)").strip().splitlines():
            log(f"[build:{src.stem}] {line}")


def _bound(n_bytes, f_ops, i_ops):
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger (ms, and which)."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = max(f_ops / PEAK_F32_S, i_ops / PEAK_I32_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _posterior_tables(packed, graph_idx, seed=5):
    """Posterior walk tables of random statistics rows with non-zero
    counts (a third of the units unobserved, so they keep the prior)."""
    import numpy as np
    import torch
    from repro_torch.core.posterior import (posterior_tables, prior_mean,
                                            row_width)
    rng = np.random.default_rng(seed)
    A = graph_idx.shape[0]
    U = packed.samples.shape[1]
    rows = np.zeros((A, U, row_width(U)), np.float32)
    seen = rng.random((A, U)) < 0.67
    rows[..., :U + 1] = rng.integers(0, 6, (A, U, U + 1)) * seen[..., None]
    rows[..., U + 2] = rng.integers(1, 9, (A, U)) * seen
    rows[..., U + 1] = rows[..., U + 2] * rng.uniform(0.1, 30.0, (A, U))
    g = graph_idx.long()
    return posterior_tables(torch.as_tensor(rows, device=packed.device),
                            packed.cum_trans[g],
                            prior_mean(packed.samples, packed.counts)[g],
                            branch_strength=8.0, demand_strength=8.0)


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


def _check_kernel(device, A, W, So, STEPS=64, NB=10, posterior=False):
    """The fused walk against its plain version (single-phase, as the
    kernel walks) at one shape, with posterior tables or without: bitwise
    on every output, both timed, and the bound from this run's inputs.
    The kernel's time is that of its wrapper on operands converted
    beforehand; ``ops_ms`` adds the conversions ``pdgraph_walk_ranked``
    makes per call."""
    import torch
    from repro_torch.kernels.pdgraph_walk import kernel, ops
    packed, rows = _kernel_inputs(device, A, So)
    G, U, S = packed.samples.shape
    name = kernel.POSTERIOR_NAME if posterior else kernel.NAME
    tag = f"[kernel:{name} A={A} W={W} So={So}]"
    po = (dict(zip(("po_cum", "po_scale"),
                   _posterior_tables(packed, rows["graph_idx"])))
          if posterior else {})

    def call(fn, **kw):
        r = rows
        return fn(packed.samples, packed.counts, packed.cum_trans,
                  r["graph_idx"], r["start"], r["executed"], r["streams"],
                  r["attained"], r["ov_samples"], r["ov_counts"],
                  valid=r["valid"], n_walkers=W, max_steps=STEPS,
                  n_buckets=NB, track_arrivals=True, **po, **kw)

    def plain_call():
        return call(ops.pdgraph_walk_ranked_plain, compact_schedule=())

    r = rows
    operands = ops.kernel_operands(
        packed.samples, packed.counts, packed.cum_trans, r["graph_idx"],
        r["start"], r["executed"], r["streams"], r["attained"],
        r["ov_samples"], r["ov_counts"], r["valid"], **po)

    def launch():
        return kernel.pdgraph_walk_fused_kernel(
            *operands, n_walkers=W, max_steps=STEPS, n_buckets=NB,
            with_arrivals=True, with_total=False)

    kern = call(ops.pdgraph_walk_ranked)
    plain = plain_call()
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
            raise AssertionError(f"{name} (W={W}, So={So}): {k} differs "
                                 f"from the plain version (max abs err {d})")
    if not torch.equal(launch()["ranks"], kern["ranks"]):
        raise AssertionError(f"{name}: the wrapper on converted operands "
                             "disagrees with pdgraph_walk_ranked")
    ms = cuda_time_ms(launch, iters=50)
    ops_ms = cuda_time_ms(lambda: call(ops.pdgraph_walk_ranked), iters=50)
    # the kernel's own device time (no host gaps), to tell whether the
    # event timings above are set by the host
    dev_ms = device_ms(launch, "walk_fused_kernel")
    plain_ms = cuda_time_ms(plain_call, iters=3, warmup=1)
    # the least the card could take: every input read once, every output
    # written once (of the override table, only the samples the counts
    # name); operations counted per walker-step this data needs
    n_ov = int(r["ov_counts"].sum())
    in_bytes = 4 * (G * U * S + G * U + G * U * (U + 1)
                    + A * U + n_ov + 5 * A) + A
    if posterior:
        in_bytes += 4 * (A * U * (U + 1) + A * U)
    out_bytes = 4 * (2 * A * NB + A + A * U * (NB + 3))
    steps = plain["walker_steps"]
    f_ops = (steps * (9 + (U + 1) + (2 if posterior else 0)) + A * W * 4
             + A * 3 * NB * NB)
    i_ops = steps * 16 + A * W * 4
    bound_ms, bound_by = _bound(in_bytes + out_bytes, f_ops, i_ops)
    log(f"{tag} max_steps={STEPS} walker_steps={steps} (mean "
        f"{steps / (A * W):.2f}) bytes={in_bytes + out_bytes} "
        f"f32_ops={f_ops} i32_ops={i_ops}")
    log(f"{tag} kernel {ms:.4f} ms  ops {ops_ms:.4f} ms  plain "
        f"{plain_ms:.3f} ms  bound {bound_ms:.6f} ms ({bound_by})  "
        f"profiled device ms/launch {dev_ms}")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/pdgraph_walk/csrc/"
                      "walk_fused.cu",
            "replaces": "src/repro/kernels/pdgraph_walk/kernel.py:297",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def _check_phase_kernel(device, A, W, So, STEPS=64, split=16, shrink=4):
    """The per-phase walk against its plain version (``walk_phase_ref``)
    launch by launch on the same state: steps 0..split, compaction of the
    survivors into N / shrink lanes, steps split..STEPS; then once
    single-phase with posterior tables.  Bitwise on cur, total, done and
    the first-arrival times; each launch timed by the profiler's device
    time (CUDA events on its wrapper printed beside); the bound from this
    run's inputs and walker-steps."""
    import torch
    from repro_torch.core.pdgraph import ARRIVAL_NEVER
    from repro_torch.kernels.pdgraph_walk import kernel
    from repro_torch.kernels.pdgraph_walk.ref import walk_phase_ref
    packed, r = _kernel_inputs(device, A, So)
    G, U, S = packed.samples.shape
    N = A * W
    i32 = torch.int32
    rep = lambda t: torch.repeat_interleave(t, W)  # noqa: E731
    tables = (packed.samples, packed.counts.float(), packed.cum_trans)
    flat = (packed.samples.reshape(G * U, S),
            packed.counts.reshape(G * U).float(),
            packed.cum_trans.reshape(G * U, U + 1))
    ov = (r["ov_samples"].reshape(A * U, So),
          r["ov_counts"].reshape(A * U).float())
    po_cum, po_scale = _posterior_tables(packed, r["graph_idx"])
    po = (po_cum.reshape(A * U, U + 1), po_scale.reshape(A * U))
    n_ov = int(r["ov_counts"].sum())    # override samples the counts name
    stream = rep(r["streams"]).to(torch.int64)
    state0 = dict(cur=rep(r["start"]).to(i32),
                  total=torch.zeros(N, device=device), done=rep(~r["valid"]),
                  gi=rep(r["graph_idx"]).to(i32),
                  app=torch.arange(A, device=device,
                                   dtype=i32).repeat_interleave(W),
                  stream=stream, lane=torch.arange(W, device=device,
                                                   dtype=i32).repeat(A),
                  ex=rep(r["executed"]),
                  arr=torch.full((U, N), ARRIVAL_NEVER, device=device))
    runs = {"compacted": ((0, split, N // shrink), (split, STEPS - split,
                                                     None)),
            "posterior": ((0, STEPS, None),)}
    err, ms, plain_ms, steps, n_bytes = 0.0, {}, {}, {}, {}
    for run, phases in runs.items():
        st = dict(state0)
        with_po = run == "posterior"
        pot = po if with_po else (None, None)
        ms[run], plain_ms[run], steps[run], n_bytes[run] = 0.0, 0.0, 0, 0
        for step0, n_steps, keep in phases:
            n = st["cur"].shape[0]
            s32 = torch.where(st["stream"] >= 2 ** 31,
                              st["stream"] - 2 ** 32, st["stream"]).to(i32)

            def launch():
                return kernel.pdgraph_walk_kernel(
                    *tables, *ov, *pot, st["cur"], st["total"], st["done"],
                    st["gi"], st["app"], s32, st["lane"], st["ex"],
                    st["arr"], step0=step0, n_steps=n_steps,
                    lanes_per_app=W, n_apps=A)

            def plain(stats=None):
                return walk_phase_ref(
                    *flat, *ov, st["cur"].long(), st["total"], st["done"],
                    st["gi"].long(), st["app"].long(), st["stream"],
                    st["lane"].long(), st["ex"], step0=step0,
                    n_steps=n_steps, lanes_per_app=W,
                    arrivals=st["arr"].t().clone(), stats=stats,
                    fpo_cum=pot[0], fpo_scale=pot[1])

            k = launch()
            stats = {"walker_steps": 0}
            p = plain(stats)
            torch.cuda.synchronize()
            tag = (f"[kernel:pdgraph_walk_phase A={A} W={W} So={So} {run} "
                   f"steps {step0}..{step0 + n_steps} lanes={n}]")
            for name, a, b in (("cur", k[0].long(), p[0]),
                               ("total", k[1], p[1]), ("done", k[2], p[2]),
                               ("arrivals", k[3], p[3].t())):
                same = torch.equal(a, b)
                d = float((a.float() - b.float()).abs().max())
                err = max(err, d)
                log(f"{tag} {name:8s} bitwise={same} max_abs_err={d}")
                if not same:
                    raise AssertionError(
                        f"pdgraph_walk_phase ({run}, steps {step0}.."
                        f"{step0 + n_steps}): {name} differs from "
                        f"walk_phase_ref (max abs err {d})")
            # the launches are short enough for the wrapper's host work to
            # set the event timing on a slow host: the kernel's time is
            # the profiler's device time, the event time is printed beside
            t_launch = cuda_time_ms(launch, iters=50)
            t_dev = device_ms(launch, "walk_phase_kernel")
            t_plain = cuda_time_ms(plain, iters=3, warmup=1)
            ms[run] += t_dev
            plain_ms[run] += t_plain
            steps[run] += stats["walker_steps"]
            # state read and written once, tables read once (of the
            # override table, the counts and only the samples they name)
            lane_bytes = n * (4 * 6 + 1 + (4 if step0 == 0 else 0)
                              + 4 * 2 + 1 + 2 * 4 * U)
            table_bytes = 4 * (G * U * S + G * U + G * U * (U + 1)
                               + A * U + n_ov)
            if with_po:
                table_bytes += 4 * A * U * (U + 2)
            n_bytes[run] += lane_bytes + table_bytes
            log(f"{tag} kernel {t_dev:.4f} ms (device)  {t_launch:.4f} ms "
                f"(events)  plain {t_plain:.3f} ms  "
                f"walker_steps={stats['walker_steps']}")
            if keep is None:
                break
            alive = int((~k[2]).sum())
            if alive > keep:
                raise AssertionError(f"compaction to {keep} lanes spills "
                                     f"({alive} alive)")
            order = torch.argsort(k[2].to(i32), stable=True)[:keep]
            st = {key: v[order] for key, v in st.items()
                  if key not in ("arr", "ex")}
            st.update(cur=k[0][order], total=k[1][order], done=k[2][order],
                      arr=k[3][:, order], ex=None)
    entries = []
    for run, name in (("compacted", "pdgraph_walk_phase"),):
        f_ops = steps[run] * (9 + (U + 1))
        i_ops = steps[run] * 16
        bound_ms, bound_by = _bound(n_bytes[run], f_ops, i_ops)
        log(f"[kernel:pdgraph_walk_phase A={A} W={W}] {run}: kernel "
            f"{ms[run]:.4f} ms  plain {plain_ms[run]:.3f} ms  bound "
            f"{bound_ms:.6f} ms ({bound_by})  walker_steps={steps[run]} "
            f"bytes={n_bytes[run]}")
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/pdgraph_walk/csrc/"
                      "walk_phase.cu",
            "replaces": "src/repro/kernels/pdgraph_walk/kernel.py:221",
            "launches": 0, "max_abs_err": err, "ms": ms[run],
            "plain_ms": plain_ms[run], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    run = "posterior"
    bound_ms, _ = _bound(n_bytes[run], steps[run] * (11 + U + 1),
                         steps[run] * 16)
    log(f"[kernel:pdgraph_walk_phase A={A} W={W}] posterior single-phase: "
        f"kernel {ms[run]:.4f} ms  plain {plain_ms[run]:.3f} ms  bound "
        f"{bound_ms:.6f} ms  walker_steps={steps[run]}")
    return entries


def phase_kernels(device, main_W, main_So):
    """Each kernel against its plain version: K1 at the main path's walker
    count and override width (the shape its launches there had) and at
    the W=512 cell, K1 with posterior tables and K2 at the main path's
    shape.  Returns the kernels-line entries."""
    entry = _check_kernel(device, 4096, main_W, main_So)
    _check_kernel(device, 4096, 512, 64)
    post = _check_kernel(device, 4096, main_W, main_So, posterior=True)
    phase = _check_phase_kernel(device, 4096, main_W, main_So)
    return [entry, post] + phase


def _profile_tick(tag, tick):
    """Device time of one tick by operator (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, copies): CPU operators carry the
    # same device time again
    evs = sorted((e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in evs)
    log(f"[{tag}:profile] wall={wall:.3f} ms (profiled) device_busy="
        f"{total / 1e3:.3f} ms device_ops={sum(e.count for e in evs)}")
    for e in evs[:8]:
        log(f"[{tag}:profile]   {e.key[:60]:60s} "
            f"device={e.self_device_time_total / 1e3:.3f} ms "
            f"calls={e.count}")


_ARENA_ROWS = ("d_probs", "d_edges", "a_hist", "a_lo", "a_span", "a_reach",
               "trig", "reach")


def phase_delta_tick(device, W):
    """Delta ticks on a 16,384-slot arena, 8 % of the slots dirty: each
    tick runs from the same arena state with the rank in the kernel (K1)
    and composed from the per-phase walk (K2); ranks, histogram and arrival
    rows and prewarm triggers must be the same bits."""
    import copy
    import numpy as np
    import torch
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.core.arena import QueueState
    from repro_torch.core.hermeslet import warmup_time_for
    from repro_torch.core.pdgraph import pack_graphs
    from repro_torch.core.prewarm import build_prewarm_table
    from repro_torch.core.refresh_pipeline import refresh_ranks_delta
    from repro_torch.kernels import LAUNCHES, reset_launches
    CAP, DIRTY, REPS = 16384, 0.08, 6
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
    times = {True: [], False: []}
    launches = {}

    def timed(state, walked, in_kernel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick = refresh_ranks_delta(packed, state, 0, walked=walked,
                                   rank_in_kernel=in_kernel, **kw)
        torch.cuda.synchronize()
        times[in_kernel].append((time.perf_counter() - t0) * 1e3)
        return tick

    spill = 0
    for rep in range(REPS):
        for s in rng.choice(CAP, n_dirty, replace=False):
            qs.add_progress(qs.ids[s], 0.25)
            qs.set_unit(qs.ids[s], int(rng.integers(0, packed.n_units)))
        walked = qs.take_dirty()
        composed = copy.deepcopy(qs)
        # alternate which form runs first, so neither always finds the
        # caches warm
        order = (True, False) if rep % 2 == 0 else (False, True)
        ticks = {}
        for in_kernel in order:
            reset_launches()
            ticks[in_kernel] = timed(qs if in_kernel else composed, walked,
                                     in_kernel)
            for k, v in LAUNCHES.items():
                launches[(in_kernel, k)] = launches.get((in_kernel, k), 0) + v
        spill += ticks[False].spill
        occ = qs.occupied()
        if not np.isfinite(ticks[True].ranks[occ]).all():
            raise AssertionError("delta tick produced non-finite ranks")
        if not np.array_equal(ticks[True].ranks[occ],
                              ticks[False].ranks[occ]):
            raise AssertionError("composed delta tick: ranks differ from "
                                 "the in-kernel tick")
        for name in _ARENA_ROWS:
            a, b = getattr(qs, name), getattr(composed, name)
            same = (torch.equal(a[occ], b[occ]) if torch.is_tensor(a)
                    else np.array_equal(a[occ], b[occ]))
            if not same:
                raise AssertionError(f"composed delta tick: {name} differs "
                                     "from the in-kernel tick")
        qs.bump_refresh(walked)
    for in_kernel, label in ((True, "in_kernel"), (False, "composed")):
        t = times[in_kernel]
        per = {k: v / REPS for (ik, k), v in launches.items()
               if ik == in_kernel and v}
        log(f"[delta_tick] {label} cap={CAP} dirty={n_dirty} W={W} "
            f"prewarm=on ms/tick median={statistics.median(t[1:]):.3f} "
            f"min={min(t[1:]):.3f} all={['%.3f' % x for x in t]} "
            f"launches/tick={per}")
    log(f"[delta_tick] composed == in_kernel bitwise over {REPS} ticks "
        f"(ranks, {', '.join(_ARENA_ROWS)}); composed spill={spill}")
    # where one tick's time goes, for each form
    for in_kernel, label in ((True, "in_kernel"), (False, "composed")):
        for s in rng.choice(CAP, n_dirty, replace=False):
            qs.set_unit(qs.ids[s], int(rng.integers(0, packed.n_units)))
        walked = qs.take_dirty()
        _profile_tick(f"delta_tick:{label}", lambda: refresh_ranks_delta(
            packed, qs, 0, walked=walked, rank_in_kernel=in_kernel, **kw))
        qs.bump_refresh(walked)


def _trace(n_apps):
    from repro_torch.apps.suite import T_IN, T_OUT
    from repro_torch.apps.workload import make_open_workload
    return make_open_workload(4000.0, t_in=T_IN, t_out=T_OUT,
                              target_load=0.85, n_service_slots=128,
                              process="gamma", cv=2.5, tenants=16, seed=1,
                              max_apps=n_apps)


def _run_path(tag, kb, insts, cfg):
    """``ClusterSim.run`` with every launch counter set to 0 just before
    and read just after.  Returns the result, the counts and the sim."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving.simulator import ClusterSim
    sim = ClusterSim(kb, cfg)
    reset_launches()
    t0 = time.perf_counter()
    res = sim.run(insts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    log(f"[{tag}] apps={len(insts)} completed={len(res.acts)} "
        f"mean_act={res.mean_act():.3f} s p95_act={res.p95_act():.3f} s "
        f"ticks={res.policy_calls} ms/tick="
        f"{1e3 * res.policy_time_s / max(res.policy_calls, 1):.3f} "
        f"wall={wall:.1f} s spill={sim.sched.fused_spill} "
        f"launches={launches}")
    return res, launches, sim


def _check_completed(tag, res, insts, launches, kernels):
    import numpy as np
    acts = res.act_values()
    if len(res.acts) != len(insts) or not np.isfinite(acts).all() \
            or (acts <= 0).any():
        raise AssertionError(f"{tag}: not every application completed with "
                             "a finite positive ACT")
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{tag} did not launch {missing}: {launches}")


def _same_schedule(tag, ref, res, rtol):
    import numpy as np
    same = res.completion_order == ref.completion_order
    ids = ref.completion_order
    a = np.asarray([ref.acts[i] for i in ids])
    b = np.asarray([res.acts[i] for i in ids]) if same else a + np.inf
    rel = float(np.max(np.abs(b - a) / np.abs(a)))
    log(f"[{tag}] completion_order_equal={same} max_rel_act_diff={rel}")
    if not same or rel > rtol:
        raise AssertionError(f"{tag}: the schedule differs")


def _main_config(**kw):
    from repro_torch.serving.simulator import SimConfig
    return SimConfig(n_llm_slots=128, n_docker_slots=256, n_dnn_slots=24,
                     kv_capacity=128, lora_capacity=64, docker_capacity=256,
                     dnn_capacity=16, seed=2, **kw)


def phase_main_path(device, n_apps):
    """run_sim at SimConfig() defaults (fused_delta, pallas walker, rank in
    kernel, hermes prewarm) over 128 LLM slots on the card.  Returns the
    result, the launch counts, the walker count and the arena's override
    width."""
    from repro_torch.apps.suite import build_knowledge_base
    from repro_torch.kernels.pdgraph_walk import kernel
    kb = build_knowledge_base(n_trials=100, seed=3)
    insts = _trace(n_apps)
    if n_apps < 2100:
        log(f"[main_path] trace cut to its first {len(insts)} of 2,100 apps "
            "(--sim-apps)")
    cfg = _main_config()
    res, launches, sim = _run_path("main_path", kb, insts, cfg)
    qs = sim.sched._qstate
    on_card = all(t is not None and t.is_cuda for t in
                  (sim.sched._packed[1].samples, qs.d_probs, qs.d_edges,
                   qs.a_hist))
    ov_width = int(qs.ov_samples.shape[2])
    log(f"[main_path] W={cfg.mc_walkers} override_width={ov_width} "
        f"arena_on_cuda={on_card}")
    _check_completed("main path", res, insts, launches, [kernel.NAME])
    if not on_card:
        raise AssertionError("main path: arena tensors are not on cuda")
    return res, launches, cfg.mc_walkers, ov_width


def phase_composed_path(device, n_apps, main_res):
    """The main path's trace with ``RefreshConfig(rank_in_kernel=False)``:
    every walk goes through the per-phase kernel; the reference's contract
    is the same schedule as the in-kernel rank."""
    from repro_torch.apps.suite import build_knowledge_base
    from repro_torch.core.refresh_config import RefreshConfig
    from repro_torch.kernels.pdgraph_walk import kernel
    kb = build_knowledge_base(n_trials=100, seed=3)
    insts = _trace(n_apps)
    res, launches, _ = _run_path(
        "composed_path", kb, insts,
        _main_config(refresh=RefreshConfig(rank_in_kernel=False)))
    _check_completed("composed path", res, insts, launches,
                     [kernel.PHASE_NAME])
    _same_schedule("composed_path vs main_path", main_res, res, 0.0)
    return launches


# the drift benchmark's full scenario (benchmarks/drift.py, FULL)
DRIFT = dict(duration_s=600.0, shift_at=120.0, rate_per_s=0.3,
             demand_mult=3.0, p_repeat=0.35, n_llm_slots=8, kb_trials=120,
             seed=11, mc_walkers=64,
             mix={"EV": 0.144, "FEV": 0.144, "CC": 0.144, "ALFWI": 0.144,
                  "KBQAV": 0.144, "CG": 0.13, "PE": 0.13},
             drift_apps=("FEV", "ALFWI", "KBQAV"))


def phase_posterior_path(device):
    """Online posterior learning on the drift scenario, on the card and on
    the CPU: the same schedule; every application completes."""
    import numpy as np
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.apps.workload import TenantProfile, make_drift_workload
    from repro_torch.core.posterior import PosteriorConfig
    from repro_torch.kernels.pdgraph_walk import kernel
    from repro_torch.serving.simulator import SimConfig
    p = DRIFT
    insts = make_drift_workload(
        p["duration_s"], t_in=T_IN, t_out=T_OUT, shift_at=p["shift_at"],
        rate_per_s=p["rate_per_s"], demand_mult=p["demand_mult"],
        p_repeat=p["p_repeat"], drift_apps=p["drift_apps"],
        n_service_slots=p["n_llm_slots"],
        tenants=[TenantProfile(name="t0", app_mix=p["mix"])], seed=p["seed"])
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = SimConfig(policy="gittins", seed=5, prewarm_mode="lru",
                        n_llm_slots=p["n_llm_slots"],
                        mc_walkers=p["mc_walkers"],
                        posterior=PosteriorConfig(), device=dev)
        kb = build_knowledge_base(n_trials=p["kb_trials"], seed=3)
        res, launches, sim = _run_path(f"posterior_path:{dev}", kb, insts,
                                       cfg)
        out[dev] = (res, launches)
        drift = [res.acts[i.app_id] for i in insts
                 if i.app_id.startswith("drift")]
        log(f"[posterior_path:{dev}] post-shift apps={len(drift)} "
            f"post_shift_mean_act={float(np.mean(drift)):.3f} s "
            f"observations={sim.sched._post_state.n_observations()}")
    _check_completed("posterior path", out["cuda"][0], insts, out["cuda"][1],
                     [kernel.POSTERIOR_NAME])
    _check_completed("posterior path (cpu)", out["cpu"][0], insts,
                     out["cpu"][1], [])
    _same_schedule("posterior_path cuda vs cpu", out["cpu"][0],
                   out["cuda"][0], 1e-6)
    return out["cuda"][1]


def phase_reference():
    """A small trace on the card and on the CPU: the kernel path and the
    plain path must schedule identically."""
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
    _same_schedule("reference: 30-app trace cuda vs cpu", out["cpu"],
                   out["cuda"], 1e-6)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sim-apps", type=int, default=1400,
                    help="applications in the main and composed paths' "
                         "trace (at most 2100)")
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
    main_res, launches, W, ov_width = phase_main_path(dev, args.sim_apps)
    launches_composed = phase_composed_path(dev, args.sim_apps, main_res)
    launches_posterior = phase_posterior_path(dev)
    kernels = phase_kernels(dev, W, ov_width)
    # each kernel's launches on its own path
    from repro_torch.kernels.pdgraph_walk import kernel
    path = {kernel.NAME: launches, kernel.PHASE_NAME: launches_composed,
            kernel.POSTERIOR_NAME: launches_posterior}
    for k in kernels:
        k["launches"] = path[k["name"]][k["name"]]
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
