"""Training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \\
      --reduced --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt \\
      --device cpu

``--device`` defaults to ``cuda``.  ``--mesh`` (``local`` or
``production``) is parsed and has no effect, as in the reference's
launcher, which never reads it: the production mesh
(``launch.mesh.make_production_mesh``) is the dry run's
(``launch.dryrun``), which can be traced but not run.
``--distributed`` initializes
``torch.distributed`` from the environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) for the run and destroys
the group after it.  Checkpoints shard by
leaf; the data pipeline is deterministic by (seed, step), so restarts
replay exactly.
"""
from __future__ import annotations

import argparse

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.runtime.train_loop import Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", choices=["local", "production"],
                    default="local")
    ap.add_argument("--distributed", action="store_true",
                    help="initialize torch.distributed from the "
                         "environment")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace) -> Trainer:
    """The driver's ``Trainer`` for parsed ``args`` (its model, schedule,
    data and checkpoints), not yet resumed or run."""
    cfg = get_config(args.arch, reduced=args.reduced)
    tc = TrainConfig(lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(1, args.steps // 10),
                     microbatches=args.microbatches)
    return Trainer(cfg, tc, batch=args.batch, seq=args.seq,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   device=args.device)


def main(argv=None) -> Trainer:
    """Run the driver; returns the trainer after its last save."""
    args = parse_args(argv)
    if not args.distributed:
        return _train(args)
    import torch.distributed as dist
    dist.init_process_group()
    try:
        return _train(args)
    finally:
        dist.destroy_process_group()


def _train(args) -> Trainer:
    trainer = make_trainer(args)
    if args.resume and trainer.maybe_resume():
        print(f"resumed from step {trainer.step}")

    hist = trainer.run(args.steps)
    for h in hist[:3] + hist[-3:]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"{h['dt'] * 1e3:8.1f} ms")
    if trainer.straggler.n_events:
        print(f"straggler events: {trainer.straggler.events}")
    trainer.save()
    return trainer


if __name__ == "__main__":
    main()
