"""Training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --tiny \\
      --steps 100 [--ckpt DIR] [--fail-at-step 40] [--device cpu]

The port of the JAX package's ``launch/train.py``, with its flags and
``--device`` (``cuda`` by default).  ``--tiny`` (the default) swaps the
full config for the reduced same-family config; ``--full`` trains the
registered config (``--layers`` cuts its depth).  ``--fail-at-step``
injects a failure to exercise the checkpoint/restart path end to end.
Checkpoints go to ``--ckpt``, or to ``repro_torch_ckpt`` in the temporary
directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.config import TrainConfig, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.testing import tiny_config
from repro_torch.training.train_loop import run_training_with_restarts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M model: 512 x 8L)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = tiny_config(args.arch) if args.tiny else get_config(args.arch)
    over = {}
    if args.d_model:
        over.update(d_model=args.d_model, d_ff=4 * args.d_model)
    if args.layers:
        over.update(num_layers=args.layers)
    if over:
        cfg = cfg.replace(**over)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       checkpoint_every=args.ckpt_every,
                       grad_compression=args.grad_compression)
    dcfg = DataConfig(vocab_size=min(cfg.vocab_size, 256),
                      seq_len=args.seq, global_batch=args.batch)
    injector = FailureInjector(args.fail_at_step)
    ckpt = args.ckpt or os.path.join(tempfile.gettempdir(),
                                     "repro_torch_ckpt")
    report = run_training_with_restarts(
        cfg, tcfg, dcfg, total_steps=args.steps, ckpt_dir=ckpt,
        injector=injector, device=args.device)
    print(f"[train] done: {report.steps_run} steps, restarts="
          f"{report.restarts}, first loss {report.losses[0]:.3f} -> last "
          f"{report.losses[-1]:.3f}, {report.wall_s:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
