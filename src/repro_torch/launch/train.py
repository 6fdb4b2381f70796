"""Training entry point (port of ``repro.launch.train``): the AdamW train step
with microbatch accumulation, optional bf16 gradient compression, a training
loop with async checkpointing and crash recovery, and the synthetic token
stream.

The reference jit-compiles its step over a device mesh and donates params
and optimizer state; here the step runs eagerly and writes the new values
into the same parameter tensors (the same arithmetic). On a mesh
(``TrainLoop(cfg, mesh=...)``) the parameters and Adam's m and v are
DTensors placed by :func:`repro_torch.launch.mesh.param_specs` (ZeRO-3),
the batch by ``batch_specs``, and each gradient is reduce-scattered to its
parameter's placements before the update.

CLI (small model; add ``--device cpu`` off the card; under ``torchrun``
it trains on a ``(1, world)`` mesh, as the reference's ``(1, n_dev)``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_vl_2b --smoke \\
      --steps 20 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2_vl_2b --smoke --steps 20
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ArchConfig, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    batch_specs, distribute, distribute_params, mesh_device, named, param_specs,
    replicate_unit_dims, world_mesh,
)
from repro_torch.models.layers import Params
from repro_torch.models.sharding import implicit, is_dtensor, mesh_dims
from repro_torch.models.transformer import init_model, lm_loss
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (
    AdamWState, adamw_init, adamw_update, cosine_schedule,
)

__all__ = ["loss_and_grads", "make_train_step", "train_state_shardings", "TrainLoop",
           "synthetic_batches", "main"]


def loss_and_grads(cfg: ArchConfig, params: Params, batch: dict, *,
                   remat_policy: str = "nothing",
                   microbatches: int = 1) -> tuple[torch.Tensor, dict]:
    """``lm_loss`` and its gradient with respect to every parameter, as a
    dict under the parameter names (zeros where a parameter does not reach
    the loss). ``microbatches`` > 1 sums the loss and gradients over equal
    batch slices, one after another, and divides both by the count:
    activation memory drops by the factor, compute is unchanged."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    named = dict(params.named_parameters())
    leaves = list(named.values())
    if not all(p.requires_grad for p in leaves):
        raise ValueError("the parameters take no gradients: call params.requires_grad_(True)")

    def one(mb: dict) -> tuple[torch.Tensor, list]:
        with torch.enable_grad(), implicit(leaves[0]):
            loss = lm_loss(cfg, params, mb, remat_policy=remat_policy)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    if microbatches == 1:
        loss, grads = one(batch)
    else:
        rows = {v.shape[0] for v in batch.values()}
        if len(rows) != 1 or next(iter(rows)) % microbatches:
            raise ValueError(f"batch rows {sorted(rows)} do not split into "
                             f"{microbatches} microbatches")
        loss, grads = 0.0, None
        for i in range(microbatches):
            l, g = one({k: _microbatch(v, i, microbatches) for k, v in batch.items()})
            loss = loss + l
            g = [gi.to(torch.float32) for gi in g]
            grads = g if grads is None else [acc + gi for acc, gi in zip(grads, g)]
        loss = loss / microbatches
        grads = [g / microbatches for g in grads]
    return loss, dict(zip(named, grads))


def _microbatch(v: torch.Tensor, i: int, count: int) -> torch.Tensor:
    """The ``i``-th of ``count`` equal row slices of a batch tensor. A
    DTensor sharded over its rows gives the ``i``-th slice of each shard
    (no rows move between ranks): other rows than the plain slice, with
    the same mean over all microbatches."""
    if is_dtensor(v) and mesh_dims(v, 0):
        from torch.distributed.tensor import DTensor

        local = v.to_local()
        n = local.shape[0] // count
        if n * count != local.shape[0]:
            raise ValueError(f"batch shard of {local.shape[0]} rows does not split into "
                             f"{count} microbatches")
        return DTensor.from_local(local[i * n:(i + 1) * n], v.device_mesh, v.placements,
                                  run_check=False)
    n = v.shape[0] // count
    return v[i * n:(i + 1) * n]


def make_train_step(
    cfg: ArchConfig,
    *,
    lr_fn=None,
    remat_policy: str = "nothing",
    microbatches: int = 1,
    grad_compression: str = "none",   # none | bf16
    weight_decay: float = 0.1,
):
    """Build the ``(params, opt, batch) → (params, opt, metrics)`` step.

    ``params`` is the model (:class:`Params`; its parameters are switched to
    take gradients), ``opt`` an :class:`AdamWState` over its
    ``named_parameters()``. The new values are written into the same
    parameter tensors. ``grad_compression="bf16"`` rounds the gradients
    through bf16 before the update. ``metrics`` holds ``loss``,
    ``grad_norm`` (before clipping) and ``step``.
    """
    if grad_compression not in ("none", "bf16"):
        raise ValueError(f"grad_compression must be 'none' or 'bf16', got {grad_compression!r}")
    lr_fn = lr_fn or cosine_schedule(3e-4, 200, 10_000)

    def train_step(params: Params, opt: AdamWState, batch: dict):
        params.requires_grad_(True)
        loss, grads = loss_and_grads(cfg, params, batch, remat_policy=remat_policy,
                                     microbatches=microbatches)
        named = dict(params.named_parameters())
        # on a mesh a gradient comes back with pending sums (Partial over
        # the batch axes): reduce-scatter it to its parameter's placements,
        # where m and v live, before the norm and the update
        grads = {k: g.redistribute(named[k].device_mesh, named[k].placements)
                 if is_dtensor(g) else g for k, g in grads.items()}
        if grad_compression == "bf16":
            grads = {k: g.to(torch.bfloat16).to(torch.float32) for k, g in grads.items()}
        with implicit(loss):
            new, opt, gnorm = adamw_update(named, grads, opt, lr=lr_fn(opt.step),
                                           weight_decay=weight_decay)
            with torch.no_grad():
                for k, p in named.items():
                    p.copy_(new[k])
        return params, opt, {"loss": _whole(loss), "grad_norm": _whole(gnorm),
                             "step": opt.step}

    return train_step


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's pending sums reduced)."""
    return t.full_tensor() if is_dtensor(t) else t


def train_state_shardings(cfg: ArchConfig, params: Params, mesh):
    """Param and optimizer shardings: m and v take the params' placements
    (ZeRO-3); the step counter stays a plain tensor (``None``)."""
    psh = named(mesh, param_specs(cfg, params, mesh))
    return psh, AdamWState(step=None, m=psh, v=psh)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TrainLoop:
    """Fault-tolerant training loop: restore-if-present, periodic async
    checkpointing, simple straggler mitigation via step-time watchdog.

    The model is drawn from a generator seeded ``seed`` on ``device``
    (other numbers than the reference's ``PRNGKey(seed)``). With ``mesh``
    (a ``DeviceMesh`` with "data" and "model" axes; ``device`` is then the
    mesh's) every rank calls the loop with the same batches: the params
    and Adam's m and v are DTensors placed by :func:`train_state_shardings`,
    each batch by ``batch_specs``, and a checkpoint restores onto this
    mesh whatever mesh saved it. A second :meth:`run` continues the step
    count.
    """

    def __init__(self, cfg: ArchConfig, *, mesh=None, device: str | torch.device = "cuda",
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 microbatches: int = 1, remat_policy: str = "nothing",
                 grad_compression: str = "none", dtype=torch.float32, seed: int = 0):
        self.cfg, self.mesh = cfg, mesh
        self.device = mesh_device(mesh) if mesh is not None else resolve_device(device)
        self.ckpt_dir, self.ckpt_every = ckpt_dir, ckpt_every
        self.params = init_model(cfg, seed, dtype=dtype, device=self.device)
        self.param_sh = self.opt_sh = None
        if mesh is not None:
            self.param_sh, self.opt_sh = train_state_shardings(cfg, self.params, mesh)
            distribute_params(self.params, self.param_sh)
        self.params.requires_grad_(True)
        self.opt = adamw_init(dict(self.params.named_parameters()))
        self.start_step = 0
        self.checkpointer = (
            ckpt_lib.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        )
        if ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
            (self.params, self.opt), self.start_step = ckpt_lib.restore(
                ckpt_dir, (self.params, self.opt),
                shardings=None if mesh is None else (self.param_sh, self.opt_sh))

        self._step = make_train_step(cfg, microbatches=microbatches,
                                     remat_policy=remat_policy,
                                     grad_compression=grad_compression)
        self.step_times: list[float] = []

    def _place(self, host: dict) -> dict:
        if self.mesh is None:
            return {k: torch.as_tensor(v, device=self.device) for k, v in host.items()}
        rows = next(iter(host.values())).shape[0]
        sh = named(self.mesh, batch_specs(self.cfg, host, self.mesh, batch_size=rows))
        return {k: distribute(torch.as_tensor(v), replicate_unit_dims(sh[k]))
                for k, v in host.items()}

    def run(self, batches, steps: int):
        it = iter(batches)
        metrics = None
        for i in range(self.start_step, self.start_step + steps):
            host = next(it)
            t0 = time.perf_counter()
            batch = self._place(host)
            self.params, self.opt, metrics = self._step(self.params, self.opt, batch)
            _sync(self.device)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            # straggler watchdog: a step ≫ median indicates a slow/failing
            # worker; at scale this triggers checkpoint-and-reschedule.
            med = float(np.median(self.step_times[-20:]))
            if len(self.step_times) > 5 and dt > 5 * med:
                print(f"[watchdog] step {i} took {dt:.2f}s (median {med:.2f}s) — "
                      "straggler suspected; checkpointing")
                if self.checkpointer:
                    self.checkpointer.save(i + 1, (self.params, self.opt))
            if self.checkpointer and (i + 1) % self.ckpt_every == 0:
                self.checkpointer.save(i + 1, (self.params, self.opt))
        self.start_step += steps
        if self.checkpointer:
            self.checkpointer.save(self.start_step, (self.params, self.opt))
            self.checkpointer.wait()
        return metrics


def synthetic_batches(cfg: ArchConfig, batch_size: int, seq: int, seed: int = 0):
    """Synthetic LM token stream: the reference's numpy draws in the same
    order, as CPU tensors (``tokens``/``labels``; ``embeds`` for stub
    frontends; ``dec_tokens`` cut to ``max_decoder_len`` for enc-dec)."""
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, cfg.vocab_size, size=(batch_size, seq + 1), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend_stub and not cfg.encoder_layers:
            batch = {
                "embeds": rng.normal(size=(batch_size, seq, cfg.d_model)).astype(np.float32),
                "labels": batch["labels"],
            }
        elif cfg.encoder_layers:
            dl = min(seq, cfg.max_decoder_len)
            batch = {
                "embeds": rng.normal(size=(batch_size, seq, cfg.d_model)).astype(np.float32),
                "dec_tokens": toks[:, :dl],
                "labels": toks[:, 1:dl + 1],
            }
        yield {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in batch.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = world_mesh(args.device)
    loop = TrainLoop(cfg, mesh=mesh, device=args.device, ckpt_dir=args.ckpt_dir,
                     microbatches=args.microbatches)
    metrics = {k: float(v) for k, v in loop.run(
        synthetic_batches(cfg, args.batch, args.seq), args.steps).items()}
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
