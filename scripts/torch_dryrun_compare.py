"""The port's traced dry run beside the JAX package's compiled one, at the
tiny (2, 2) train cells.

    PYTHONPATH=src python scripts/torch_dryrun_compare.py

Two cells of 8 x 128 tokens over a ("data", "model") mesh of (2, 2): the
tiny float32 Llama-3 and the tiny float32 Qwen1.5-MoE under its
``PERF_PRESETS`` entry (``moe_impl="ep"``, ``remat=False``; two
microbatches, since the preset's 16 do not split 8 rows).  The reference
compiles each (``repro.launch.dryrun._compile_cell``, the full program and
the one- and two-period accounting variants) in a subprocess that sees 4
host devices; the port traces each as rank 0 of a 4-rank stand-in world
(``repro_torch.launch.dryrun._trace``).  Prints, for the full program and
the extrapolation, each count of the port, the reference's and their
ratio (port / reference); the reference's output bytes also less its
output tuple's entries (``TUPLE_ENTRY`` bytes a leaf), which eager
PyTorch does not have.  Then each rank's executed FLOPs of the full
program over rank 0's (the dry run's rank; the global norm sums each
block on one rank only).  CPU only: no device time is measured.
"""
import json
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MESH = (2, 2)
AXES = ("data", "model")
SEQ, BATCH = 128, 8
# the bytes of a leaf's entry in the tuple XLA returns a program's outputs
# in: its output_size_in_bytes counts them
TUPLE_ENTRY = 8
# name -> (arch, overrides of the tiny config, beside dtype="float32")
CELLS = {
    "dense": ("llama3-8b", {}),
    "ep": ("qwen2-moe-a2.7b", {"preset": True, "microbatch": 2}),
}

_REFERENCE = """
import json, sys
import numpy as np, jax
# the devices first: importing the dry run appends a 512-device flag
assert jax.device_count() == 4
from jax.sharding import Mesh
from repro.config import ShapeConfig
from repro.configs import PERF_PRESETS
from repro.distributed.sharding import ShardCtx
from repro.launch import dryrun as D
from repro.models.transformer import n_periods
from repro.testing import tiny_config
cells, out = json.loads(sys.argv[1]), {}
accounting = json.loads(sys.argv[3])
shape = ShapeConfig("t", {seq}, {batch}, "train")
mesh = Mesh(np.array(jax.devices()).reshape({mesh}), {axes})
for name, (arch, over) in cells.items():
    over = dict(over)
    if over.pop("preset", False):
        over = dict(PERF_PRESETS[arch], **over)
    cfg = tiny_config(arch, dtype="float32", **over)
    ctx = ShardCtx(mesh, param_sharding=cfg.param_sharding)
    out[name] = dict(main=D._compile_cell(cfg, shape, ctx, want_mem=True))
    with D.use_shard_ctx(ctx), ctx.mesh:
        fn, args, _, _ = D.cell_functions(D.build_model(cfg), shape, ctx)
        out[name]["main"]["output_leaves"] = len(
            jax.tree_util.tree_leaves(jax.eval_shape(fn, *args)))
    if name in accounting:
        m1, m2 = (D._compile_cell(D.accounting_cfg(cfg, k), shape, ctx,
                                  want_mem=False) for k in (1, 2))
        out[name]["tot"] = D.extrapolate(m1, m2, n_periods(cfg))
json.dump(out, open(sys.argv[2], "w"))
"""


def config(name: str):
    """The port's configuration of cell ``name``."""
    from repro_torch.configs import PERF_PRESETS
    from repro_torch.testing import tiny_config
    arch, over = CELLS[name]
    over = dict(over)
    if over.pop("preset", False):
        over = dict(PERF_PRESETS[arch], **over)
    return tiny_config(arch, dtype="float32", **over)


def start_reference(out_path: Path, cells=tuple(CELLS),
                    accounting=tuple(CELLS)) -> subprocess.Popen:
    """The reference's compiles of ``cells`` in a subprocess at 4 host
    devices, written as JSON to ``out_path`` (``read_reference``): each
    cell's full program, and its accounting variants' extrapolation
    (``tot``) for the cells of ``accounting``, and the number of leaves
    of each full program's output (``output_leaves``)."""
    code = textwrap.dedent(_REFERENCE).replace("{seq}", str(SEQ)) \
        .replace("{batch}", str(BATCH)).replace("{mesh}", repr(MESH)) \
        .replace("{axes}", repr(AXES))
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    return subprocess.Popen(
        [sys.executable, "-c", code, json.dumps({c: CELLS[c] for c in cells}),
         str(out_path), json.dumps(list(accounting))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def read_reference(proc: subprocess.Popen, out_path: Path,
                   timeout: float = 300.0) -> dict:
    _, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the reference's compile failed: {err[-3000:]}")
    return json.loads(Path(out_path).read_text())


def port(name: str, rank: int = 0) -> dict:
    """The port's full trace and extrapolation of cell ``name`` as
    ``rank`` of the (2, 2) stand-in world."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import stand_in_mesh
    from repro_torch.models.transformer import layer_kinds, layer_plan
    cfg = config(name)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    with stand_in_mesh(MESH, AXES, rank) as pm:
        main = D._trace(cfg, shape, pm)
        m1, m2 = (D._trace(D.accounting_cfg(cfg, k), shape, pm)
                  for k in (1, 2))
    n = len(layer_kinds(cfg)) // len(layer_plan(cfg))
    return dict(main=main, tot=D.extrapolate(m1, m2, n))


def rank_flops(name: str) -> list:
    """The full program's executed FLOPs of cell ``name`` at each rank
    of the (2, 2) stand-in world."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import stand_in_mesh
    cfg, shape, out = config(name), ShapeConfig("t", SEQ, BATCH, "train"), []
    for rank in range(MESH[0] * MESH[1]):
        with stand_in_mesh(MESH, AXES, rank) as pm:
            out.append(D._trace(cfg, shape, pm)["flops"])
    return out


def rows(got: dict, want: dict):
    """(what, port, reference) of every count side by side."""
    out = []
    for part in ("main", "tot"):
        g, w = got[part], want[part]
        out += [(f"{part} flops", g["flops"], w["flops"]),
                (f"{part} bytes", g["bytes"], w["bytes"])]
        out += [(f"{part} {k}", g["coll"][k], w["coll"][k])
                for k in w["coll"]]
    mem = want["main"]["memory_analysis"]
    out += [(f"main {k}", got["main"]["memory_analysis"][k], mem[k])
            for k in ("argument_size_in_bytes", "output_size_in_bytes",
                      "temp_size_in_bytes")]
    out.append(("main output_size_in_bytes less tuple entries",
                got["main"]["memory_analysis"]["output_size_in_bytes"],
                mem["output_size_in_bytes"]
                - TUPLE_ENTRY * want["main"]["output_leaves"]))
    out.append(("main params_bytes_per_dev", got["main"]["params_bytes"],
                want["main"]["params_bytes_per_dev"]))
    return out


def main() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "reference.json"
        proc = start_reference(path)
        got = {name: port(name) for name in CELLS}
        want = read_reference(proc, path)
    for name in CELLS:
        print(f"## {name}: {CELLS[name][0]} (2, 2), 8 x 128 tokens, float32")
        print("| count | port | reference | port / reference |")
        print("|---|---|---|---|")
        for what, g, w in rows(got[name], want[name]):
            ratio = f"{g / w:.4f}" if w else ("-" if not g else "inf")
            print(f"| {what} | {g:.0f} | {w:.0f} | {ratio} |")
        flops = rank_flops(name)
        print(f"full-program FLOPs by rank {flops}, over rank 0's "
              f"{[f'{f / flops[0]:.6f}' for f in flops]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
