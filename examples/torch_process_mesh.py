"""The port over a process mesh: one process a position, under torchrun.

    torchrun --nproc-per-node 4 examples/torch_process_mesh.py --device cpu
    torchrun --nproc-per-node 4 examples/torch_process_mesh.py  # 4 cards

Every rank joins the world (``init_process_mesh`` reads torchrun's
environment), runs the tiny MoE's expert-parallel prefill over a
``(data, model)`` mesh of the world's size, holding only its share of the
experts, and then ``run_sim`` with the slot arena split one shard a rank
(``RefreshConfig(mesh_shards=world)`` over the world's group).  Every rank prints its logits'
checksum and the schedule's; the ranks of a data shard print the same
logits, and every rank the same schedule.  On one card, several ranks
need ``--backend gloo`` (NCCL refuses two ranks on one card).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or none for this rank's card")
    ap.add_argument("--backend", default=None,
                    help="gloo to put several ranks on one card")
    ap.add_argument("--data", type=int, default=1,
                    help="positions of the data axis (it must divide the "
                         "world)")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist
    from repro_torch.apps.suite import T_IN, T_OUT, build_knowledge_base
    from repro_torch.apps.workload import make_workload
    from repro_torch.core.refresh_config import RefreshConfig
    from repro_torch.distributed.sharding import ShardCtx, use_shard_ctx
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.models.model import build_model
    from repro_torch.serving.simulator import SimConfig, run_sim
    from repro_torch.testing import tiny_config

    world = int(os.environ["WORLD_SIZE"])
    mesh = init_process_mesh((args.data, world // args.data),
                             ("data", "model"), backend=args.backend,
                             device=args.device)
    cfg = tiny_config("qwen2-moe-a2.7b", dtype="float32", moe_impl="ep")
    model = build_model(cfg, mesh.device, mesh=mesh).init(
        torch.Generator(device=mesh.device).manual_seed(0))
    tokens = torch.randint(1, cfg.vocab_size, (2 * args.data, 16),
                           generator=torch.Generator().manual_seed(1))
    d = ShardCtx(mesh).data_shard
    with use_shard_ctx(ShardCtx(mesh)):
        _, logits = model.prefill(tokens[2 * d:2 * d + 2])
    res = run_sim(build_knowledge_base(n_trials=40, seed=3),
                  make_workload(12, 60.0, seed=29, t_in=T_IN, t_out=T_OUT),
                  SimConfig(refresh=RefreshConfig(mesh_shards=world),
                            device=str(mesh.device), mc_walkers=32,
                            process_group=dist.group.WORLD))
    print(f"rank {mesh.rank} {mesh.coords}: logits sum "
          f"{float(logits.double().sum()):.6f}; completion order "
          f"{res.completion_order[:4]}...; mean ACT {res.mean_act():.6f}",
          flush=True)


if __name__ == "__main__":
    main()
