"""CPU time of the port's ranked walk with and without the quantized walk
tables (``repro_torch.kernels.pdgraph_walk.quant``).

    PYTHONPATH=src python scripts/torch_quant_walk_time.py [--apps 256 4096]

For each app count: the knowledge base of ``apps.suite`` packed, random
queue rows (as ``tests/test_torch_ranked.py`` draws them), then
``ops.pdgraph_walk_ranked`` on the CPU without and with the tables, in
turns (without, with, with, without, ...), median wall ms of each; the two
walks' outputs must be bitwise equal.  Prints one line per app count and
the table build time.  CPU times only: they say nothing of the card, where
the walk kernels read no tables.
"""
import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
from repro_torch.core.pdgraph import pack_graphs
from repro_torch.kernels.pdgraph_walk import ops, quant
from repro_torch.kernels.pdgraph_walk.ref import walker_streams


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--apps", type=int, nargs="+", default=[256, 4096])
    ap.add_argument("--walkers", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    packed = pack_graphs(build_knowledge_base(n_trials=60, seed=3), T_IN,
                         T_OUT, device="cpu")
    t0 = time.perf_counter()
    tables = quant.build_quant_tables(packed.samples, packed.counts,
                                      packed.cum_trans)
    G, U, S = packed.samples.shape
    print(f"tables for G={G} U={U}: built in "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms, "
          f"{sum(t.numel() * t.element_size() for t in tables)} bytes; "
          f"torch {torch.__version__}, {torch.get_num_threads()} threads")
    for A in args.apps:
        rng = np.random.default_rng(A)
        gi = rng.integers(0, G, A).astype(np.int32)
        executed = rng.uniform(0, 0.5, A).astype(np.float32)
        t = torch.as_tensor
        run = lambda q: ops.pdgraph_walk_ranked(  # noqa: E731
            packed.samples, packed.counts, packed.cum_trans, t(gi),
            t(packed.entry[gi].astype(np.int32)), t(executed),
            walker_streams(7, np.arange(A), np.zeros(A)),
            t(np.zeros(A, np.float32)), n_walkers=args.walkers,
            max_steps=64, track_arrivals=True, with_total=True, quant=q)
        times = {"plain": [], "tables": []}
        outs = {}
        for i in range(2 * args.repeats):
            which = ("plain", "tables", "tables", "plain")[i % 4]
            t0 = time.perf_counter()
            outs[which] = run(tables if which == "tables" else None)
            times[which].append(1e3 * (time.perf_counter() - t0))
        same = all(torch.equal(outs["plain"][k], outs["tables"][k])
                   for k in ("probs", "edges", "ranks", "total", "a_hist"))
        plain = statistics.median(times["plain"])
        tab = statistics.median(times["tables"])
        print(f"A={A} W={args.walkers}: plain {plain:.1f} ms, tables "
              f"{tab:.1f} ms ({plain / tab:.2f}x); runs "
              f"{[round(x, 1) for x in times['plain']]} / "
              f"{[round(x, 1) for x in times['tables']]}; bitwise equal: "
              f"{same}")
        if not same:
            raise SystemExit("the walks differ")


if __name__ == "__main__":
    main()
