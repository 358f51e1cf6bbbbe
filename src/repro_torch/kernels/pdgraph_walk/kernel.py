"""Bindings of the walk kernels (``csrc/walk_fused.cu``, ``csrc/walk_phase.cu``).

Each wrapper checks its operands, allocates the outputs, launches its CUDA
kernel on the current stream and raises if the launch is refused:

* ``pdgraph_walk_fused_kernel`` replaces the TPU kernel
  ``pdgraph_walk_fused_kernel`` of ``repro.kernels.pdgraph_walk.kernel``
  (one-pass walk, histogram rows, rank and arrival rows);
* ``pdgraph_walk_kernel`` replaces the TPU kernel ``pdgraph_walk_kernel``
  (one walk phase over flat walker state).

What bounds each on the card and how its design differs is noted at the top
of its CUDA source.  They take CUDA tensors only — the plain PyTorch
versions live in ``ops.py`` and ``ref.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, build
from repro_torch.kernels.binding import on_device, sm_count, stream_of

NAME = "pdgraph_walk_fused"
# the fused kernel's launches with posterior operands count apart, so a run
# shows which of its paths went through the kernel
POSTERIOR_NAME = "pdgraph_walk_fused_posterior"
PHASE_NAME = "pdgraph_walk_phase"
SOURCE = Path(__file__).parent / "csrc" / "walk_fused.cu"
PHASE_SOURCE = Path(__file__).parent / "csrc" / "walk_phase.cu"
SOURCES = (SOURCE, PHASE_SOURCE)
NB_MAX = 32
SMEM_MAX = 232448               # bytes of shared memory one block may use
# the walk kernels' CDF scans are unrolled over one of these unit counts
UNITS_MAX = (4, 8, 16, 32)
PHASE_THREADS = 256             # the per-phase kernel's threads a block, at most
for _name in (NAME, POSTERIOR_NAME, PHASE_NAME):
    LAUNCHES.setdefault(_name, 0)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class WalkPlan(NamedTuple):
    threads: int         # a block's threads: a multiple of 32, at most 256
    units_max: int       # the CDF scan's unrolled length, >= U


def walk_plan(W: int, U: int, A: int = 1, sms: int = 132) -> WalkPlan:
    """The fused kernel's launch plan for ``A`` apps of ``W`` walkers on a
    card of ``sms`` multiprocessors.  Each thread walks one walker at a
    time and takes the next from the block's counter.  A launch of up to
    two blocks per multiprocessor (the main path's: one or two apps a
    tick) is set by one block's latency: a walker a thread, up to 256.  A
    larger one is throughput: about two walkers a thread over 32 to 128
    threads, so more apps share a multiprocessor.  The CDF scan is
    unrolled over the smallest of ``UNITS_MAX`` that holds ``U``."""
    if U > UNITS_MAX[-1]:
        raise ValueError(f"pdgraph_walk_fused takes at most {UNITS_MAX[-1]} "
                         f"units, got {U}")
    if A <= 2 * sms:
        threads = min(-(-W // 32) * 32, 256)
    else:
        threads = min(max(1 << max(-(-W // 2) - 1, 0).bit_length(), 32), 128)
    return WalkPlan(threads, next(m for m in UNITS_MAX if U <= m))


class PhasePlan(NamedTuple):
    threads: int          # a block's threads (a lane each): at most 256
    units_max: int        # the CDF scan's unrolled length, >= U


def phase_plan(N: int, U: int) -> PhasePlan:
    """The per-phase kernel's launch plan for ``N`` lanes: a lane a thread,
    blocks of up to 256, the CDF scan unrolled over the smallest of
    ``UNITS_MAX`` that holds ``U``."""
    if U > UNITS_MAX[-1]:
        raise ValueError(f"pdgraph_walk_phase takes at most {UNITS_MAX[-1]} "
                         f"units, got {U}")
    return PhasePlan(min(max(-(-N // 32) * 32, 32), PHASE_THREADS),
                     next(m for m in UNITS_MAX if U <= m))


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.pdgraph_walk_fused
    if fn.argtypes is None:
        fn.argtypes = [_P] * 18 + [_I] * 9 + [_F, _F, _P]
        fn.restype = ctypes.c_int
        lib.pdgraph_walk_fused_smem.argtypes = [_I] * 7
        lib.pdgraph_walk_fused_smem.restype = ctypes.c_size_t
        lib.pdgraph_walk_error_string.argtypes = [_I]
        lib.pdgraph_walk_error_string.restype = ctypes.c_char_p
    return lib


def _phase_lib() -> ctypes.CDLL:
    lib = build.load(PHASE_SOURCE)
    fn = lib.pdgraph_walk_phase
    if fn.argtypes is None:
        fn.argtypes = [_P] * 20 + [_I] * 9 + [_P]
        fn.restype = ctypes.c_int
        lib.pdgraph_walk_phase_error_string.argtypes = [_I]
        lib.pdgraph_walk_phase_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> int:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def pdgraph_walk_fused_kernel(samples: torch.Tensor,     # (G, U, S) f32
                              counts: torch.Tensor,      # (G, U) f32
                              cum_trans: torch.Tensor,   # (G, U, U+1) f32
                              ov_samples: Optional[torch.Tensor],  # (A*U, So)
                              ov_counts: Optional[torch.Tensor],   # (A*U,) f32
                              attained: torch.Tensor,    # (A,) f32
                              start: torch.Tensor,       # (A,) i32
                              graph_idx: torch.Tensor,   # (A,) i32
                              streams: torch.Tensor,     # (A,) i32 (uint32 bits)
                              executed: torch.Tensor,    # (A,) f32
                              valid: torch.Tensor,       # (A,) u8
                              po_cum: Optional[torch.Tensor] = None,  # (A*U, U+1)
                              po_scale: Optional[torch.Tensor] = None,  # (A*U,)
                              *, n_walkers: int, max_steps: int,
                              n_buckets: int, with_arrivals: bool,
                              with_total: bool) -> Dict[str, torch.Tensor]:
    """Launch the fused walk.  Returns ``probs``/``edges`` (A, nb),
    ``ranks`` (A,), ``arrstats`` (A*U, nb+3) with arrivals, ``rem`` (A, W)
    raw remaining-service totals with ``with_total``.  ``po_cum`` /
    ``po_scale`` (per-app posterior walk tables) replace the graphs' CDF rows
    and scale every sampled service.  Graph and start indices must lie in
    range (``[0, G)`` and ``[0, U)``)."""
    dev = samples.device
    G, U, S = samples.shape
    A = graph_idx.shape[0]
    W, nb = int(n_walkers), int(n_buckets)
    if W < 1 or max_steps < 0:
        raise ValueError(f"need n_walkers >= 1 and max_steps >= 0, got "
                         f"{W} / {max_steps}")
    if not 2 <= nb <= NB_MAX:
        raise ValueError(f"n_buckets must be in [2, {NB_MAX}], got {nb}")
    f32, i32 = torch.float32, torch.int32
    ptrs = [_check(samples, "samples", f32, (G, U, S), dev),
            _check(counts, "counts", f32, (G, U), dev),
            _check(cum_trans, "cum_trans", f32, (G, U, U + 1), dev)]
    with_ov = ov_samples is not None
    So = 1
    if with_ov:
        So = ov_samples.shape[1]
        ptrs += [_check(ov_samples, "ov_samples", f32, (A * U, So), dev),
                 _check(ov_counts, "ov_counts", f32, (A * U,), dev)]
    else:
        ptrs += [None, None]
    ptrs += [_check(attained, "attained", f32, (A,), dev),
             _check(start, "start", i32, (A,), dev),
             _check(graph_idx, "graph_idx", i32, (A,), dev),
             _check(streams, "streams", i32, (A,), dev),
             _check(executed, "executed", f32, (A,), dev),
             _check(valid, "valid", torch.uint8, (A,), dev)]
    with_po = po_cum is not None
    if with_po:
        ptrs += [_check(po_cum, "po_cum", f32, (A * U, U + 1), dev),
                 _check(po_scale, "po_scale", f32, (A * U,), dev)]
    else:
        ptrs += [None, None]
    out = {"probs": torch.empty((A, nb), dtype=f32, device=dev),
           "edges": torch.empty((A, nb), dtype=f32, device=dev),
           "ranks": torch.empty((A,), dtype=f32, device=dev)}
    if with_arrivals:
        out["arrstats"] = torch.empty((A * U, nb + 3), dtype=f32, device=dev)
    if with_total:
        out["rem"] = torch.empty((A, W), dtype=f32, device=dev)
    if A == 0:
        return out
    plan = walk_plan(W, U, A, sm_count(dev))
    lib = _lib()
    smem = lib.pdgraph_walk_fused_smem(W, U, S, So, plan.threads,
                                       int(with_ov), int(with_arrivals))
    if smem > SMEM_MAX:
        raise ValueError(f"pdgraph_walk_fused needs {smem} B of shared "
                         f"memory per block (W={W}, U={U}, S={S}, So={So}); "
                         f"the card offers {SMEM_MAX}")
    ptrs += [out["probs"].data_ptr(), out["edges"].data_ptr(),
             out["ranks"].data_ptr(),
             out["arrstats"].data_ptr() if with_arrivals else None,
             out["rem"].data_ptr() if with_total else None]
    with on_device(dev):
        stream = stream_of(dev)
        rc = lib.pdgraph_walk_fused(
            *ptrs, A, W, U, S, So, int(max_steps), nb, *plan,
            float(np.float32(1.0 / W)), float(np.float32(1.0 / nb)), stream)
    if rc != 0:
        msg = lib.pdgraph_walk_error_string(rc).decode()
        raise RuntimeError(f"pdgraph_walk_fused launch failed: {msg} ({rc})")
    LAUNCHES[POSTERIOR_NAME if with_po else NAME] += 1
    return out


def pdgraph_walk_kernel(samples: torch.Tensor,     # (G, U, S) f32
                        counts: torch.Tensor,      # (G, U) f32
                        cum_trans: torch.Tensor,   # (G, U, U+1) f32
                        ov_samples: Optional[torch.Tensor],  # (A*U, So) f32
                        ov_counts: Optional[torch.Tensor],   # (A*U,) f32
                        po_cum: Optional[torch.Tensor],      # (A*U, U+1) f32
                        po_scale: Optional[torch.Tensor],    # (A*U,) f32
                        cur: torch.Tensor,         # (N,) i32
                        total: torch.Tensor,       # (N,) f32
                        done: torch.Tensor,        # (N,) bool
                        gi: torch.Tensor,          # (N,) i32
                        app: torch.Tensor,         # (N,) i32
                        stream: torch.Tensor,      # (N,) i32 (uint32 bits)
                        lane: torch.Tensor,        # (N,) i32 original lane
                        executed: Optional[torch.Tensor],    # (N,) f32
                        arrivals: Optional[torch.Tensor] = None,  # (U, N) f32
                        *, step0: int, n_steps: int, lanes_per_app: int,
                        n_apps: int):
    """Launch one walk phase: global steps ``step0 .. step0 + n_steps``
    over flat walker state, on the plan of :func:`phase_plan`.
    ``executed`` is consumed at global step 0; override and posterior rows
    are indexed by ``app`` (``n_apps`` rows of ``U``).  Returns new ``(cur,
    total, done)`` tensors, plus the updated ``(U, N)`` first-arrival times
    when ``arrivals`` is given."""
    dev = samples.device
    G, U, S = samples.shape
    N = cur.shape[0]
    A = int(n_apps)
    if lanes_per_app < 1 or n_steps < 0 or step0 < 0:
        raise ValueError(f"need lanes_per_app >= 1 and n_steps, step0 >= 0, "
                         f"got {lanes_per_app} / {n_steps} / {step0}")
    f32, i32 = torch.float32, torch.int32
    ptrs = [_check(samples, "samples", f32, (G, U, S), dev),
            _check(counts, "counts", f32, (G, U), dev),
            _check(cum_trans, "cum_trans", f32, (G, U, U + 1), dev)]
    So = 1
    if ov_samples is not None:
        So = ov_samples.shape[1]
        ptrs += [_check(ov_samples, "ov_samples", f32, (A * U, So), dev),
                 _check(ov_counts, "ov_counts", f32, (A * U,), dev)]
    else:
        ptrs += [None, None]
    if po_cum is not None:
        ptrs += [_check(po_cum, "po_cum", f32, (A * U, U + 1), dev),
                 _check(po_scale, "po_scale", f32, (A * U,), dev)]
    else:
        ptrs += [None, None]
    ptrs += [_check(cur, "cur", i32, (N,), dev),
             _check(total, "total", f32, (N,), dev),
             _check(done, "done", torch.bool, (N,), dev),
             _check(gi, "gi", i32, (N,), dev),
             _check(app, "app", i32, (N,), dev),
             _check(stream, "stream", i32, (N,), dev),
             _check(lane, "lane", i32, (N,), dev),
             None if executed is None
             else _check(executed, "executed", f32, (N,), dev),
             None if arrivals is None
             else _check(arrivals, "arrivals", f32, (U, N), dev)]
    cur_o = torch.empty_like(cur)
    total_o = torch.empty_like(total)
    done_o = torch.empty_like(done)
    arr_o = None if arrivals is None else torch.empty_like(arrivals)
    if N == 0:
        return (cur_o, total_o, done_o) + (() if arr_o is None else (arr_o,))
    ptrs += [cur_o.data_ptr(), total_o.data_ptr(), done_o.data_ptr(),
             None if arr_o is None else arr_o.data_ptr()]
    plan = phase_plan(N, U)
    lib = _phase_lib()
    with on_device(dev):
        cuda_stream = stream_of(dev)
        rc = lib.pdgraph_walk_phase(
            *ptrs, N, U, S, So, int(lanes_per_app), int(step0), int(n_steps),
            *plan, cuda_stream)
    if rc != 0:
        msg = lib.pdgraph_walk_phase_error_string(rc).decode()
        raise RuntimeError(f"pdgraph_walk_phase launch failed: {msg} ({rc})")
    LAUNCHES[PHASE_NAME] += 1
    return (cur_o, total_o, done_o) + (() if arr_o is None else (arr_o,))
