"""Dry-run of every (arch × shape × mesh) cell without hardware (port of
``repro.launch.dryrun``).

Proves the distribution config is coherent: each cell's train, prefill or
decode step runs on DTensors over a FAKE process group of 256 ranks (512
with ``--multi-pod``) whose local shards live on the ``meta`` device:
shapes, shardings and collectives are real, no tensor is allocated and no
card is touched. The run stands for rank 0. :class:`~repro_torch.launch.comm_analysis.LocalOpCounter`
reads what that rank computes, moves and holds: FLOPs of its local
products, collective bytes by kind and mesh axis, and peak live bytes. In
place of the reference's compile time it reports the trace seconds.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_vl_2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --json out.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_config, smoke_config
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.train.optimizer import adamw_init

from .comm_analysis import LocalOpCounter
from .mesh import (
    P, batch_specs, decode_state_specs, distribute, distribute_params, named, param_specs,
    production_mesh_shape,
)
from .roofline import analytic_cell, roofline_terms
from .serve import make_prefill_step, make_serve_step
from .specs import input_specs, param_shapes, skip_reason
from .train import make_train_step

__all__ = ["dryrun_cell", "fake_mesh", "unsharded_flops", "main"]


@contextlib.contextmanager
def fake_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` over a fake process group (rank 0 of
    prod(shape)), destroyed on exit; refuses to run inside another group."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the dry-run "
                           "makes its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _knobs(*, seq_parallel_attn, layer_seq_shard, decode_feature_shard):
    old = (attn_mod.SEQ_PARALLEL_ATTN, tf_mod.LAYER_SEQ_SHARD, tf_mod.DECODE_FEATURE_SHARD)
    attn_mod.SEQ_PARALLEL_ATTN = seq_parallel_attn
    tf_mod.LAYER_SEQ_SHARD = layer_seq_shard
    tf_mod.DECODE_FEATURE_SHARD = decode_feature_shard
    try:
        yield
    finally:
        attn_mod.SEQ_PARALLEL_ATTN, tf_mod.LAYER_SEQ_SHARD, tf_mod.DECODE_FEATURE_SHARD = old


def _count_step(cfg, shape_name: str, mesh, *, remat_policy: str = "nothing",
                microbatches: int = 1, prefill_last_only: bool = False,
                cache_seq_shard: bool = False, decode_replicated_batch: bool = False) -> dict:
    """Run the cell's step once on meta tensors (DTensors on ``mesh``, plain
    without one) under a :class:`LocalOpCounter`; its report."""
    seq, gb, kind = SHAPES[shape_name]

    def place(t, spec):
        return t if mesh is None else distribute(t, named(mesh, spec))

    params = param_shapes(cfg)
    if mesh is not None:
        distribute_params(params, named(mesh, param_specs(cfg, params, mesh)))
    specs = input_specs(cfg, shape_name)
    if kind in ("train", "prefill"):
        bsp = batch_specs(cfg, specs, mesh, batch_size=gb) if mesh is not None else {}
        batch = {k: place(v, bsp.get(k)) for k, v in specs.items()}
        if kind == "train":
            params.requires_grad_(True)
            opt = adamw_init(dict(params.named_parameters()))
            step = make_train_step(cfg, remat_policy=remat_policy, microbatches=microbatches)
            args, held = (params, opt, batch), (list(params.parameters()), opt, batch)
        else:
            step = make_prefill_step(cfg, last_only=prefill_last_only)
            args, held = (params, batch), (list(params.parameters()), batch)
    else:
        state = specs["state"]
        if mesh is not None:
            ssp = decode_state_specs(cfg, state, mesh, batch_size=gb,
                                     cache_seq_shard=cache_seq_shard)
            state = {k: place(v, ssp[k]) for k, v in state.items()}
        tok_spec = (P(None, None) if decode_replicated_batch or mesh is None else
                    batch_specs(cfg, {"tokens": specs["tokens"]}, mesh, batch_size=gb)["tokens"])
        tokens = place(specs["tokens"], tok_spec)
        enc = None
        if "enc_out" in specs:
            enc = place(specs["enc_out"], P(None, None, None))
        step = make_serve_step(cfg)
        args = (params, state, tokens, specs["pos"], enc)
        held = (list(params.parameters()), state, tokens, [] if enc is None else enc)
    with LocalOpCounter(mesh, held=held) as counter:
        step(*args)
    return counter.report()


def unsharded_flops(arch: str, shape_name: str, *, smoke: bool = False,
                    remat_policy: str = "nothing", microbatches: int = 1) -> int:
    """FLOPs of the cell's step on one device, no mesh: what the sharded
    ranks' FLOPs add up to, or more where ranks repeat work."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    return _count_step(cfg, shape_name, None, remat_policy=remat_policy,
                       microbatches=microbatches)["flops"]


def dryrun_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    mesh_shape: tuple[int, ...] | None = None,
    smoke: bool = False,
    remat_policy: str = "nothing",
    microbatches: int = 1,
    seq_parallel_attn: bool = False,
    layer_seq_shard: bool = False,
    cache_seq_shard: bool = False,
    decode_replicated_batch: bool = False,
    decode_feature_shard: bool = False,
    prefill_last_only: bool = False,
    optimized: bool = False,
    extra_tags: dict | None = None,
) -> dict:
    """Run one cell on the fake mesh; return its roofline artifacts.

    ``mesh_shape`` replaces the production mesh (axes ("data", "model"),
    or ("pod", "data", "model") for three dims); ``smoke`` takes the
    arch's smoke config at the cell's shapes. ``optimized=True`` applies
    the reference's per-kind winning configuration:
      train   → microbatches=8
      prefill → last-token head + seq-parallel attention + SP layer boundaries
      decode  → split-KV cache sharding + feature-sharded decode activations
    """
    cfg = smoke_config(arch) if smoke else get_config(arch)
    reason = skip_reason(cfg, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    seq, gb, kind = SHAPES[shape_name]
    if optimized:
        if kind == "train":
            microbatches = max(microbatches, 8)
        elif kind == "prefill":
            prefill_last_only = seq_parallel_attn = layer_seq_shard = True
        else:
            cache_seq_shard = decode_feature_shard = True
    if mesh_shape is None:
        m = production_mesh_shape(multi_pod=multi_pod)
        shape, names = m.shape, m.mesh_dim_names
    else:
        shape = tuple(mesh_shape)
        names = ("pod", "data", "model")[-len(shape):]

    t0 = time.perf_counter()
    with _knobs(seq_parallel_attn=seq_parallel_attn, layer_seq_shard=layer_seq_shard,
                decode_feature_shard=decode_feature_shard), \
            fake_mesh(shape, names) as mesh:
        counts = _count_step(cfg, shape_name, mesh, remat_policy=remat_policy,
                             microbatches=microbatches, prefill_last_only=prefill_last_only,
                             cache_seq_shard=cache_seq_shard,
                             decode_replicated_batch=decode_replicated_batch)
    trace_s = time.perf_counter() - t0

    analytic = analytic_cell(cfg, shape_name, remat=remat_policy)
    terms = roofline_terms(cfg, shape_name, counts["collective_total"],
                           collective_by_axis=counts["collective_by_axis"],
                           remat=remat_policy)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in shape),
        "ranks": int(torch.tensor(shape).prod()),
        "kind": kind,
        "trace_s": round(trace_s, 3),
        "flops": float(counts["flops"]),
        "analytic_flops": float(analytic["flops_per_device"]),
        "collective_bytes": counts["collective_bytes"],
        "collective_by_axis": counts["collective_by_axis"],
        "collective_total": int(counts["collective_total"]),
        "memory": {"held_bytes": int(counts["held_bytes"]),
                   "peak_bytes": int(counts["peak_bytes"])},
        "roofline": {k: terms[k] for k in ("compute_s", "memory_s", "collective_s",
                                            "dominant", "bound_step_s")},
    }
    if smoke:
        result["smoke"] = True
    if extra_tags:
        result.update(extra_tags)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--json", default=None, help="append results to this file")
    ap.add_argument("--seq-parallel-attn", action="store_true")
    ap.add_argument("--layer-seq-shard", action="store_true")
    ap.add_argument("--cache-seq-shard", action="store_true")
    ap.add_argument("--decode-replicated-batch", action="store_true")
    ap.add_argument("--decode-feature-shard", action="store_true")
    ap.add_argument("--prefill-last-only", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="the reference's per-kind winning flags")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    results = []
    fail = 0
    for arch, shape in cells:
        try:
            r = dryrun_cell(arch, shape, multi_pod=args.multi_pod,
                            remat_policy=args.remat,
                            microbatches=args.microbatches,
                            seq_parallel_attn=args.seq_parallel_attn,
                            layer_seq_shard=args.layer_seq_shard,
                            cache_seq_shard=args.cache_seq_shard,
                            decode_replicated_batch=args.decode_replicated_batch,
                            decode_feature_shard=args.decode_feature_shard,
                            prefill_last_only=args.prefill_last_only,
                            optimized=args.optimized)
        except Exception as e:  # noqa: BLE001 — report, continue, fail at end
            r = {"arch": arch, "shape": shape, "error": f"{type(e).__name__}: {e}"}
            fail += 1
        tag = "SKIP" if "skipped" in r else "FAIL" if "error" in r else "ok"
        summary = r.get("skipped") or r.get("error") or (
            f"trace={r['trace_s']}s flops={r['flops']:.3e} "
            f"(analytic {r['analytic_flops']:.3e}) coll={r['collective_total']:.3e}B "
            f"peak={r['memory']['peak_bytes'] / 2**30:.1f}GiB")
        print(f"[{tag}] {arch:<20} {shape:<12} {summary}", flush=True)
        results.append(r)

    if args.json:
        existing = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                existing = json.load(f)
        with open(args.json, "w") as f:
            json.dump(existing + results, f, indent=1)
    sys.exit(1 if fail else 0)


if __name__ == "__main__":
    main()
