"""Dry run: every (arch x shape x mesh) cell's step traced as one rank
of the production mesh, with no device work.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single

The port of the JAX package's ``launch/dryrun.py``.  The reference lowers
and compiles each cell on 256 or 512 placeholder devices and reads the
compiled program's cost and memory analysis and its collectives.  Here
this process joins a stand-in world of the production mesh's 256 or 512
ranks as rank 0 (``launch.mesh.stand_in_mesh``: 16 x 16, or 2 x 16 x 16),
builds the cell's model placed over it on the ``meta`` device
(``build_model(cfg, device="meta", mesh=)``; an EP preset with
``expert_share=False``, as the reference places it) and runs the cell's
step (``launch.steps.cell_functions``) on the rank's blocks under a
``launch.costs.CostCounter``.  Rank 0 is the rank that does the most: the
global norm of the gradients sums each block on the first rank along
every axis that replicates it, which rank 0 is for every block it holds.
A record holds the reference's keys:

* ``hlo_flops_per_dev``, ``hlo_bytes_per_dev`` and ``collectives`` (wire
  bytes by type, ``total_wire_bytes``, ``num_collectives``), summed from
  the one- and two-period accounting variants (``accounting_cfg``,
  ``extrapolate``); bytes are every eager operation's operands and
  outputs, unfused, and the kernels K3-K7 count by their own formulas;
* ``scanned_program``: the same counts of the full-depth program (the
  port has no scan over the layers, so it counts every layer);
* ``memory_analysis``: ``argument_size_in_bytes`` and
  ``output_size_in_bytes`` (the rank's arguments and outputs; XLA's also
  count its output tuple's 8 bytes a leaf, which eager PyTorch does not
  have, ROADMAP §3) and ``temp_size_in_bytes`` (the peak of the storages
  the step made);
* ``lower_s`` (the full-depth trace's seconds), ``params_bytes_per_dev``,
  ``model_flops_per_dev`` (6 N_active T for training, 2 N_active T
  otherwise), ``useful_flops_ratio`` (model FLOPs over executed ones);
* ``roofline``: ``compute_s``, ``memory_s`` and ``collective_s`` (the
  executed FLOPs, bytes and wire bytes at ``config.H100_SXM``'s rates),
  ``dominant``, ``step_s_lower_bound`` and ``roofline_fraction``;
* ``extrapolated``: the model FLOPs, parameter bytes and product FLOPs
  (what ``FlopCounterMode`` counts) of the accounting variants,
  extrapolated the same way; and ``ok``, with ``error`` and
  ``traceback`` on failure.

``compile_s`` and ``generated_code_size_in_bytes`` have no counterpart
(nothing is compiled) and are absent (ROADMAP §3).

Results are written to ``results/dryrun/<mesh>/<arch>__<shape>.json``
(existing cells are skipped unless ``--force``), so a sweep is restartable.
At its end a run prints a markdown table of its cells (``table_row``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch

from repro_torch.config import (H100_SXM, SHAPES, ModelConfig,
                                applicable_shapes, get_config, list_configs)
from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
from repro_torch.launch.costs import CostCounter, nbytes
from repro_torch.launch.mesh import production_shape, stand_in_mesh
from repro_torch.launch.steps import (cell_functions, cell_max_seq,
                                      decode_seq_axes)
from repro_torch.models.model import build_model
from repro_torch.models.transformer import layer_kinds, layer_plan


def tree_device_bytes(specs: Dict[str, Any], abstract: Dict[str, Any],
                      mesh_shape: Dict[str, int]) -> int:
    """Per-device resident bytes of ``abstract`` (tensors by name) under
    ``specs`` (a spec by the same names) over a mesh of ``mesh_shape``
    (axis -> size): each tensor's bytes over the positions its spec
    splits it into, rounded down as the reference's."""
    total = 0
    for name, ab in abstract.items():
        k = 1
        for entry in specs[name]:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                k *= mesh_shape[a]
        total += ab.numel() * ab.element_size() // k
    return total


def model_flops(cfg: ModelConfig, shape, n_devices: int) -> float:
    """6*N_active*tokens (train) / 2*N_active*tokens (fwd), per device."""
    n_active = cfg.param_counts()["active"]
    if shape.kind == "train":
        f = 6.0 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        f = 2.0 * n_active * shape.global_batch * shape.seq_len
    else:
        f = 2.0 * n_active * shape.global_batch
    return f / n_devices


def accounting_cfg(cfg: ModelConfig, k: int) -> ModelConfig:
    """Unrolled k-period variant with inner chunking disabled: what the
    reference compiles to count every op once per layer."""
    period = 1 if cfg.family == "encdec" else len(layer_plan(cfg))
    # microbatch=0: one full-batch step has the same per-step totals
    over = dict(scan_layers=False, num_layers=k * period,
                attn_block_q=1 << 30, loss_chunk=1 << 30, microbatch=0)
    if cfg.family == "encdec":
        over["enc_layers"] = k
    return cfg.replace(**over)


def extrapolate(m1: dict, m2: dict, n: int) -> dict:
    """X_total = X(1 period) + (n-1) * (X(2 periods) - X(1 period))."""
    def ex(a, b):
        return max(0.0, a + (n - 1) * (b - a))
    coll = {k: ex(m1["coll"][k], m2["coll"][k]) for k in m1["coll"]}
    return {"flops": ex(m1["flops"], m2["flops"]),
            "bytes": ex(m1["bytes"], m2["bytes"]),
            "coll": coll}


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return nbytes(tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def _argument_bytes(kind: str, args, in_sh, mesh) -> int:
    """The rank's argument bytes: its blocks, and its rows of the global
    train batch (which the train step cuts itself) by their spec; a
    decode position is an int32 scalar, as the reference's."""
    if kind == "train":
        params, opt, batch = args
        return (_tensor_bytes((params, opt))
                + tree_device_bytes(in_sh[2], batch, mesh.shape))
    if kind == "decode":
        return _tensor_bytes(args[:3]) + 4
    return _tensor_bytes(args)


def _trace(cfg: ModelConfig, shape, pm) -> dict:
    """One variant's step traced as this rank of the process mesh ``pm``
    (the module docstring): its counts, memory and parameter bytes."""
    ctx = ShardCtx(pm, param_sharding=cfg.param_sharding,
                   seq_axes=decode_seq_axes(shape, pm.axis_names))
    model = build_model(cfg, device="meta", max_seq=cell_max_seq(cfg, shape),
                        mesh=ctx, expert_share=False)
    if shape.kind == "train":
        model.trainable()
    with use_shard_ctx(ctx):
        fn, args, in_sh, _ = cell_functions(model, shape, ctx)
        t0 = time.perf_counter()
        with CostCounter(args) as c:
            out = fn(*args)
        lower_s = time.perf_counter() - t0
    return {"flops": c.flops, "bytes": c.bytes, "coll": c.collectives(),
            "product_flops": c.product_flops, "lower_s": lower_s,
            "kernels": c.kernels,
            "memory_analysis": {
                "argument_size_in_bytes": _argument_bytes(
                    shape.kind, args, in_sh, pm),
                "output_size_in_bytes": _tensor_bytes(out),
                "temp_size_in_bytes": c.temp_bytes},
            "params_bytes": _tensor_bytes(model.params())}


def roofline(flops: float, n_bytes: float, wire_bytes: float,
             hw=H100_SXM) -> Dict[str, Any]:
    """The reference's roofline terms at ``hw``'s rates: compute, memory
    and collective seconds, the dominant one, the step's lower bound and
    the compute term's share of it."""
    compute_s = flops / hw.peak_flops
    memory_s = n_bytes / hw.hbm_bw
    coll_s = wire_bytes / hw.ici_bw
    bound = max(compute_s, memory_s, coll_s)
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant,
            "step_s_lower_bound": bound,
            "roofline_fraction": compute_s / bound if bound else None}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             force: bool = False, overrides=None) -> dict:
    tag = "__".join(f"{k}-{v}" for k, v in sorted((overrides or {}).items()))
    fname = f"{arch}__{shape_name}" + (f"__{tag}" if tag else "") + ".json"
    out_path = out_dir / mesh_kind / fname
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    out_path.parent.mkdir(parents=True, exist_ok=True)

    cfg = get_config(arch, **(overrides or {}))
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "overrides": overrides or {},
           "time": time.strftime("%Y-%m-%d %H:%M:%S")}
    try:
        n = len(layer_kinds(cfg)) // len(layer_plan(cfg))
        with stand_in_mesh(*production_shape(mesh_kind == "multi")) as pm:
            n_dev = pm.size
            # 1) the full-depth program: every layer, its memory
            main = _trace(cfg, shape, pm)
            # 2) the accounting variants, extrapolated over the periods
            acc = [accounting_cfg(cfg, k) for k in (1, 2)]
            m1, m2 = (_trace(a, shape, pm) for a in acc)
        tot = extrapolate(m1, m2, n)
        ex = extrapolate(*({"flops": model_flops(a, shape, n_dev),
                            "bytes": m["params_bytes"],
                            "coll": {"product_flops": m["product_flops"]}}
                           for a, m in zip(acc, (m1, m2))), n)
        mf = model_flops(cfg, shape, n_dev)
        rec.update({
            "ok": True,
            "n_devices": n_dev,
            "lower_s": main["lower_s"],
            "hlo_flops_per_dev": tot["flops"],
            "hlo_bytes_per_dev": tot["bytes"],
            "collectives": tot["coll"],
            "scanned_program": {k: main[k] for k in
                                ("flops", "bytes", "coll", "product_flops",
                                 "kernels")},
            "memory_analysis": main["memory_analysis"],
            "params_bytes_per_dev": int(main["params_bytes"]),
            "model_flops_per_dev": mf,
            "useful_flops_ratio": (mf / tot["flops"]) if tot["flops"]
            else None,
            "extrapolated": {"model_flops_per_dev": ex["flops"],
                             "params_bytes_per_dev": ex["bytes"],
                             "product_flops_per_dev":
                             ex["coll"]["product_flops"]},
            "roofline": roofline(tot["flops"], tot["bytes"],
                                 tot["coll"]["total_wire_bytes"]),
        })
    except Exception as e:  # record the failure; the sweep continues
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    out_path.write_text(json.dumps(rec, indent=2))
    status = "ok" if rec.get("ok") else "FAIL"
    dom = rec.get("roofline", {}).get("dominant", "-")
    print(f"[{status}] {mesh_kind:6s} {arch:24s} {shape_name:12s} "
          f"trace={rec.get('lower_s', 0):.1f}s dominant={dom}", flush=True)
    return rec


TABLE_HEADER = (
    "| Cell | TFLOP/dev | GB/dev | wire GB/dev: all-gather / all-reduce / "
    "reduce-scatter / all-to-all | temp GB | dominant | useful FLOPs | "
    "trace s |\n|---|---|---|---|---|---|---|---|")


def table_row(rec: dict) -> str:
    """A record as a row under ``TABLE_HEADER``: the cell, the executed
    FLOPs and bytes a device, the wire bytes a device by collective type,
    the peak of the step's temporaries, the dominant roofline term,
    ``useful_flops_ratio`` and the full-depth trace's seconds; or the
    failure."""
    over = ",".join(f"{k}={v}" for k, v in rec["overrides"].items())
    cell = " ".join(x for x in (rec["arch"], rec["shape"], rec["mesh"], over)
                    if x)
    if not rec.get("ok"):
        return f"| {cell} | failed: {rec.get('error')} |"
    coll = rec["collectives"]
    wire = " / ".join(f"{coll[k] / 1e9:,.2f}" for k in
                      ("all-gather", "all-reduce", "reduce-scatter",
                       "all-to-all"))
    temp = rec["memory_analysis"]["temp_size_in_bytes"]
    return (f"| {cell} | {rec['hlo_flops_per_dev'] / 1e12:,.2f} | "
            f"{rec['hlo_bytes_per_dev'] / 1e9:,.2f} | {wire} | "
            f"{temp / 1e9:,.2f} | {rec['roofline']['dominant']} | "
            f"{rec['useful_flops_ratio']:.4f} | {rec['lower_s']:.1f} |")


def cells_for(archs, shapes_filter=None, mesh_kinds=("single", "multi")):
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in applicable_shapes(cfg):
            if shapes_filter and shape_name not in shapes_filter:
                continue
            for mk in mesh_kinds:
                yield arch, shape_name, mk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--set", action="append", default=[],
                    help="config override k=v (e.g. moe_impl=ep)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except ValueError:
            pass
        overrides[k] = v

    archs = [args.arch] if args.arch else list(list_configs())
    shapes = [args.shape] if args.shape else None
    meshes = (args.mesh,) if args.mesh else ("single", "multi")
    out_dir = Path(args.out)

    recs = [run_cell(arch, shape_name, mk, out_dir, force=args.force,
                     overrides=overrides)
            for arch, shape_name, mk in cells_for(archs, shapes, meshes)]
    print(TABLE_HEADER)
    for rec in recs:
        print(table_row(rec))
    n_fail = sum(0 if rec.get("ok") else 1 for rec in recs)
    print(f"done; failures={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
