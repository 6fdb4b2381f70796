"""Rank bodies for the spawned gloo tests of ``tests/test_torch_mesh.py``
(kept apart from the test module so that spawned ranks import torch and
the port only, not JAX).

Every rank builds the same unsharded models (seeded) beside the meshed
ones; rank 0 writes what it measured to ``out.json`` for the test process
to hold against the limits.
"""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

DECODE_STEPS = 4
BATCH = 4
# the architecture trained in microbatches on the mesh as well
MICROBATCH_ARCH = "qwen2_vl_2b"


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _serve(cfg, mesh, prompts):
    """Logits of DECODE_STEPS greedy steps through Server's params and
    caches, then Server.generate's tokens from the same prompts."""
    from repro_torch.launch.mesh import distribute
    from repro_torch.launch.serve import Server
    from repro_torch.models.sharding import replicate
    from repro_torch.models.transformer import decode_step

    srv = Server(cfg, mesh=mesh, device="cpu", kv_len=16, batch_size=BATCH)
    toks = torch.as_tensor(prompts)
    if mesh is not None:
        toks = distribute(toks, srv._tok_sh)
    logits = []
    with torch.no_grad():
        for t in range(DECODE_STEPS):
            lg, srv.state = decode_step(cfg, srv.params, srv.state, toks, t)
            logits.append(_whole(lg).numpy())
            nxt = torch.argmax(replicate(lg), -1).to(torch.int32)[:, None]
            toks = nxt if mesh is None else nxt.redistribute(mesh, srv._tok_sh.placements)
    return np.stack(logits), srv.generate(prompts, max_new=DECODE_STEPS)


def _train(cfg, mesh, microbatches: int = 1):
    """(the loss of TrainLoop's first step, Adam's m after it, which is
    (1 - b1) times the clipped gradient, and what one AdamW step at a
    constant lr of 3e-4 from a fresh optimizer moved each parameter), each
    step over ``microbatches`` row slices."""
    from repro_torch.launch.train import TrainLoop, make_train_step, synthetic_batches
    from repro_torch.train.optimizer import adamw_init

    loop = TrainLoop(cfg, mesh=mesh, device="cpu", microbatches=microbatches)
    batches = synthetic_batches(cfg, BATCH, 16, seed=1)
    loss = float(loop.run(batches, 1)["loss"])
    m = {k: _whole(v).numpy() for k, v in loop.opt.m.items()}
    named = dict(loop.params.named_parameters())
    before = {k: _whole(p).detach().clone() for k, p in named.items()}
    step = make_train_step(cfg, lr_fn=lambda s: torch.tensor(3e-4),
                           microbatches=microbatches)
    step(loop.params, adamw_init(named), loop._place(next(batches)))
    moved = {k: (_whole(p).detach() - before[k]).numpy()
             for k, p in loop.params.named_parameters()}
    return loss, m, moved


def _train_parity(cfg, mesh, microbatches: int = 1) -> dict:
    loss_p, m_p, moved_p = _train(cfg, None, microbatches)
    loss_m, m_m, moved_m = _train(cfg, mesh, microbatches)
    return {"loss_err": abs(loss_m - loss_p),
            "grad_rel": {k: rel(m_m[k], m_p[k]) for k in m_p},
            "moved_rel": {k: rel(moved_m[k], moved_p[k]) for k in moved_p},
            "moved_any": float(max(np.abs(v).max() for v in moved_p.values()))}


def parity_rank(rank: int, world: int, tmp: str, archs: list) -> None:
    """Server decode and one train step of every arch on a (2, 2) mesh
    against the unsharded port; MICROBATCH_ARCH's train steps also in two
    microbatches, each a row of every "data" shard (``microbatches.json``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import smoke_config

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        out = {}
        for arch in archs:
            cfg = smoke_config(arch)
            prompts = np.random.default_rng(0).integers(
                0, cfg.vocab_size, size=(BATCH, 1)).astype(np.int32)
            lp, tp = _serve(cfg, None, prompts)
            lm, tm = _serve(cfg, mesh, prompts)
            top2 = np.sort(lp, -1)[..., -2:]
            clear = (top2[..., 1] - top2[..., 0]) > 1e-5          # [steps, B]
            step_toks = [(np.argmax(lm, -1) == np.argmax(lp, -1)) | ~clear]
            gen_clear = np.concatenate([np.ones((BATCH, 1), bool), clear.T], axis=1)
            out[arch] = {
                "logits_rel": rel(lm, lp),
                "tokens_ok": bool(np.all(step_toks)) and bool(np.all((tm == tp) | ~gen_clear)),
                **_train_parity(cfg, mesh),
            }
        micro = _train_parity(smoke_config(MICROBATCH_ARCH), mesh, microbatches=2)
        if rank == 0:
            with open(os.path.join(tmp, "out.json"), "w") as f:
                json.dump(out, f)
            with open(os.path.join(tmp, "microbatches.json"), "w") as f:
                json.dump(micro, f)
    finally:
        dist.destroy_process_group()


def restore_rank(rank: int, world: int, tmp: str, arch: str, src: str, dst: str) -> None:
    """Elastic restore: the checkpoint in ``src`` (saved on another mesh)
    restored onto a (2, 2) TrainLoop, held bit-equal to the files, then
    saved again into ``dst``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.train import TrainLoop
    from repro_torch.train import checkpoint as ckpt_lib

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store2"), world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        cfg = smoke_config(arch)
        loop = TrainLoop(cfg, mesh=mesh, device="cpu", ckpt_dir=src)
        plain = TrainLoop(cfg, device="cpu")
        (files, opt), step = ckpt_lib.restore(src, (plain.params, plain.opt), device="cpu")
        equal = all(torch.equal(_whole(p).detach(), q.detach())
                    for p, q in zip(loop.params.parameters(), files.parameters()))
        equal &= all(torch.equal(_whole(loop.opt.m[k]), opt.m[k]) and
                     torch.equal(_whole(loop.opt.v[k]), opt.v[k]) for k in opt.m)
        placed = all(hasattr(p, "placements") for p in loop.params.parameters())
        ckpt_lib.save(dst, step, (loop.params, loop.opt))
        if rank == 0:
            with open(os.path.join(tmp, "restore.json"), "w") as f:
                json.dump({"start_step": loop.start_step, "equal": bool(equal),
                           "placed": placed}, f)
    finally:
        dist.destroy_process_group()
