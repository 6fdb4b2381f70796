"""Distributed training on the PyTorch/CUDA port: a fault-tolerant loop with
checkpoint/restart.

Trains a reduced-config LM with the production sharding rules (FSDP × TP)
when launched under ``torchrun`` — a ``(1, world)`` ("data", "model") mesh,
NCCL on the cards, gloo with ``--device cpu`` — or unsharded on one
process, checkpoints periodically, and demonstrates crash recovery by
construction: re-running the same command resumes from the last
checkpoint.

Run:  PYTHONPATH=src python examples/torch/train_distributed.py \
          [--arch granite_20b] [--steps 30] [--ckpt DIR] [--device cpu]
      PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch/train_distributed.py

``main`` returns the figures it prints.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs.registry import smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import world_mesh
from repro_torch.launch.train import TrainLoop, synthetic_batches
from repro_torch.train import checkpoint as ckpt


def describe_mesh(mesh) -> str:
    if mesh is None:
        return "none (one process)"
    return str(dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))


def train(cfg, mesh, device, *, ckpt_dir: str, steps: int, batch: int, seq: int,
          microbatches: int) -> tuple[TrainLoop, dict]:
    """Build the loop (restoring the latest checkpoint in ``ckpt_dir``),
    fast-forward the data stream past the restored steps, run ``steps``
    more; the loop and its last step's metrics."""
    loop = TrainLoop(cfg, mesh=mesh, device=device, ckpt_dir=ckpt_dir, ckpt_every=10,
                     microbatches=microbatches)
    batches = synthetic_batches(cfg, batch, seq)
    # fast-forward the data stream on resume (deterministic replay)
    for _ in range(loop.start_step):
        next(batches)
    return loop, loop.run(batches, steps=steps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite_20b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "pegasus_ckpt"))
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_config(args.arch)
    mesh = world_mesh(args.device)
    try:
        print(f"mesh: {describe_mesh(mesh)}, arch={args.arch} (smoke), "
              f"microbatches={args.microbatches}")
        prev = ckpt.latest_step(args.ckpt)
        if prev is not None:
            print(f"found checkpoint at step {prev} — resuming (crash recovery)")
        loop, metrics = train(cfg, mesh, device, ckpt_dir=args.ckpt, steps=args.steps,
                              batch=args.batch, seq=args.seq,
                              microbatches=args.microbatches)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    step, loss = int(metrics["step"]), float(metrics["loss"])
    median_s = float(np.median(loop.step_times))
    print(f"finished at step {step}: loss={loss:.4f} median step time {median_s:.3f}s")
    steps_saved = ckpt.latest_steps(args.ckpt)
    print(f"checkpoints: {steps_saved}")
    return dict(mesh=describe_mesh(mesh), resumed_from=prev, step=step, loss=loss,
                median_step_s=median_s, checkpoints=steps_saved)


if __name__ == "__main__":
    main()
