"""Start a ``torch.distributed`` world of processes on this machine.

``spawn(fn, world_size, *args)`` runs ``fn(*args)`` in ``world_size``
fresh processes, each with the environment ``torchrun --nproc-per-node
world_size`` gives a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), so
``launch.mesh.init_process_mesh`` joins the world there as it would under
torchrun.  The rendezvous store is a ``TCPStore`` that this process holds
on a port the operating system chose, so concurrent worlds never collide.

``env`` adds to each rank's environment (``OMP_NUM_THREADS`` also sets
torch's intra-op threads, since unpickling ``fn`` may import torch
first).  It returns each rank's return value, in rank order.  A rank
that raises fails the call with that rank's traceback, and a world that
has not finished within ``timeout_s`` is stopped and fails the call too:
every process it started has ended when it returns or raises.  ``fn`` must be
importable by name (a module-level function), as the spawn start method
pickles it.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Any, Callable, Dict, List, Optional


def _child(fn: Callable, rank: int, world: int, port: int,
           env: Dict[str, str], out, args) -> None:
    os.environ.update(
        RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
        LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(port),
        # join the store this parent holds, as torchrun's agent store
        TORCHELASTIC_USE_AGENT_STORE="True")
    if os.path.exists("/sys/class/net/lo"):
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.update(env)
    if "OMP_NUM_THREADS" in env:        # torch may be imported already
        import torch
        torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
    try:
        out.put((rank, True, fn(*args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, timeout_s: float = 600.0,
          env: Optional[Dict[str, str]] = None) -> List[Any]:
    """``fn(*args)`` on every rank of a fresh world of ``world_size``
    processes; the ranks' results in rank order (see the module
    docstring)."""
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world_size, store.port,
                               dict(env or {}), out, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    failed: Dict[int, str] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(failed) < world_size and not failed:
            try:
                rank, ok, val = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results]
                if dead:
                    # a rank died without reporting (killed, or crashed
                    # in native code): give its report a moment to land
                    time.sleep(2.0)
                    while not out.empty():
                        rank, ok, val = out.get()
                        (results if ok else failed)[rank] = val
                    for r in dead:
                        failed.setdefault(r, f"rank {r} exited with code "
                                          f"{procs[r].exitcode}")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"a world of {world_size} ranks ran past "
                        f"{timeout_s:.0f} s; ranks done: {sorted(results)}")
                continue
            (results if ok else failed)[rank] = val
    finally:
        for p in procs:
            p.join(timeout=30.0 if not failed else 1.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        del store
    if failed:
        rank = min(failed)
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                           f"{failed[rank]}")
    return [results[r] for r in range(world_size)]
