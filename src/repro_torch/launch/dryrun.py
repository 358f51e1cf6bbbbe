"""Dry run: every (arch x shape x mesh) cell's per-device accounting on the
logical production meshes, with no device work.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh single

The port of the JAX package's ``launch/dryrun.py``.  Each cell's step
function, abstract (``meta``) arguments and sharding specs come from
``launch.steps.cell_functions`` over ``launch.mesh.make_production_mesh``
(16 x 16 positions, or 2 x 16 x 16).  A record holds what has a meaning
without a compiler: ``n_devices``, ``params_bytes_per_dev`` (the
parameters' bytes per position under their specs),
``model_flops_per_dev`` (6 N_active T for training, 2 N_active T
otherwise), ``roofline.compute_s`` (those FLOPs at the H100's bf16 peak,
``config.H100_SXM``), the same two counts summed from the one- and
two-period accounting variants (``accounting_cfg``, ``extrapolate``), and
``ok``, with ``error`` and ``traceback`` on failure.  The reference also
lowers and compiles each cell on 512 placeholder devices and reads its
HLO (FLOPs, bytes, collectives, memory analysis, compile times); PyTorch
has no such artifact, so those keys are absent (ROADMAP §3).

Results are written to ``results/dryrun/<mesh>/<arch>__<shape>.json``
(existing cells are skipped unless ``--force``), so a sweep is restartable.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict

from repro_torch.config import (H100_SXM, SHAPES, ModelConfig,
                                applicable_shapes, get_config, list_configs)
from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import cell_functions
from repro_torch.models.model import build_model


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
    from repro_torch.models.transformer import layer_plan
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


def _count(cfg: ModelConfig, shape, ctx: ShardCtx) -> dict:
    """One variant's model FLOPs and parameter bytes per device."""
    model = build_model(cfg, device="meta")
    with use_shard_ctx(ctx):
        fn, args, in_sh, out_sh = cell_functions(model, shape, ctx)
    n_dev = ctx.mesh.size
    return {"flops": model_flops(cfg, shape, n_dev),
            "bytes": tree_device_bytes(in_sh[0], args[0], ctx.mesh.shape),
            "coll": {}}


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
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        ctx = ShardCtx(mesh, param_sharding=cfg.param_sharding)
        main = _count(cfg, shape, ctx)
        # the accounting variants, extrapolated over the periods
        from repro_torch.models.transformer import layer_kinds, layer_plan
        n = len(layer_kinds(cfg)) // len(layer_plan(cfg))
        tot = extrapolate(_count(accounting_cfg(cfg, 1), shape, ctx),
                          _count(accounting_cfg(cfg, 2), shape, ctx), n)
        compute_s = main["flops"] / H100_SXM.peak_flops
        rec.update({
            "ok": True,
            "n_devices": mesh.size,
            "params_bytes_per_dev": int(main["bytes"]),
            "model_flops_per_dev": main["flops"],
            "extrapolated": {"model_flops_per_dev": tot["flops"],
                             "params_bytes_per_dev": tot["bytes"]},
            "roofline": {"compute_s": compute_s},
        })
    except Exception as e:  # record the failure; the sweep continues
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    out_path.write_text(json.dumps(rec, indent=2))
    status = "ok" if rec.get("ok") else "FAIL"
    print(f"[{status}] {mesh_kind:6s} {arch:24s} {shape_name:12s} "
          f"params/dev={rec.get('params_bytes_per_dev', 0)} "
          f"compute_s={rec.get('roofline', {}).get('compute_s', 0):.4g}",
          flush=True)
    return rec


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

    n_fail = 0
    for arch, shape_name, mk in cells_for(archs, shapes, meshes):
        rec = run_cell(arch, shape_name, mk, out_dir, force=args.force,
                       overrides=overrides)
        n_fail += 0 if rec.get("ok") else 1
    print(f"done; failures={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
