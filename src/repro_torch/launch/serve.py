"""Serving entry point of the port: ``PegasusServer`` over one compiled plan, and
the ``--pegasus`` demo (port of the Pegasus half of
``repro.launch.serve``).

``PegasusServer`` compiles its plan once (int32 features, LUTs, int8 LUT +
scales on the GPU) and serves request lists: requests are coalesced,
chunked along the bucket ladder (full chunks are exact buckets, the tail
pads minimally) and the outputs split back per request.

Run the demo on the GPU::

    PYTHONPATH=src python -m repro_torch.launch.serve --pegasus --backend kernel_q8
"""

from __future__ import annotations

import argparse
import time
import warnings

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine import bucket_chunks, build_plan

from .request import InferRequest, InferResult

__all__ = ["PegasusServer", "InferRequest", "InferResult", "main"]


def _as_requests(requests) -> tuple[list, bool]:
    """Normalize a ``serve()`` argument into ``(list[InferRequest], typed)``.

    :class:`InferRequest` items pass through; legacy items (bare arrays or
    input tuples) are wrapped and the caller warns. Mixing the two shapes is
    a ``TypeError``."""
    items = list(requests)
    if not items:
        return [], True
    n_typed = sum(isinstance(r, InferRequest) for r in items)
    if n_typed == len(items):
        return items, True
    if n_typed:
        raise TypeError(
            "serve() got a mix of InferRequest and legacy-shaped items — "
            "pass one or the other, not both")
    return [InferRequest("", tuple(r) if isinstance(r, (tuple, list)) else r)
            for r in items], False


def _coalesce(requests, device: torch.device) -> tuple[list, list[int], int]:
    """Per-input concatenations on ``device`` + per-request sizes."""
    sizes = [int(np.shape(r[0])[0]) for r in requests]
    cat = [torch.cat([torch.as_tensor(r[i], device=device) for r in requests])
           for i in range(len(requests[0]))]
    return cat, sizes, sum(sizes)


def _split(out: torch.Tensor, sizes: list[int]) -> list[np.ndarray]:
    """Cut a coalesced output back into per-request numpy arrays."""
    host = out.cpu().numpy()
    return np.split(host, np.cumsum(sizes)[:-1], axis=0)


class PegasusServer:
    """Batched multi-request server over ONE compiled ExecutionPlan.

    Every request input carries a leading batch dim (axis 0 = flows).
    Serving counters change only after a call succeeds.
    """

    def __init__(self, model, *, backend: str = "onehot",
                 max_batch: int | None = None, fuse: bool = True,
                 device: str | torch.device = "cuda"):
        t0 = time.perf_counter()
        self.plan = build_plan(model, backend=backend, fuse=fuse, device=device)
        self.plan_build_ms = (time.perf_counter() - t0) * 1e3
        self.backend = backend
        self.max_batch = max(self.plan.buckets) if max_batch is None else max_batch
        self.requests_served = 0
        self.batches_run = 0
        self.flows_served = 0

    def stats(self) -> dict:
        """Serving counters + the plan's build and dispatch stats."""
        return {
            "backend": self.backend,
            "serving": {
                "requests_served": self.requests_served,
                "batches_run": self.batches_run,
                "flows_served": self.flows_served,
                "batches_dispatched": self.batches_run,
            },
            "engine": {
                "plan_build_ms": self.plan_build_ms,
                "num_banks": self.plan.num_banks,
                "table_bytes": self.plan.table_bytes(),
                **self.plan.compile_stats(),
            },
        }

    def infer(self, *inputs, backend: str | None = None) -> torch.Tensor:
        """One already-batched call through the plan (one request)."""
        y = self.plan(*inputs, backend=backend)
        self.batches_run += 1
        self.requests_served += 1
        self.flows_served += int(np.shape(inputs[0])[0])
        return y

    def serve(self, requests, *, backend: str | None = None) -> list:
        """Serve a list of :class:`InferRequest` → list of
        :class:`InferResult` (request order; outputs as numpy arrays). A
        list of bare arrays / input tuples still works, returning the raw
        outputs, with a ``DeprecationWarning``."""
        reqs, typed = _as_requests(requests)
        if not reqs:
            return []
        if not typed:
            warnings.warn(
                "PegasusServer.serve(list of arrays) is deprecated; pass a "
                "list of InferRequest", DeprecationWarning, stacklevel=2)
        cat, sizes, total = _coalesce([r.inputs for r in reqs], self.plan.device)
        chunks, start = [], 0
        for size in bucket_chunks(total, self.plan.buckets, self.max_batch):
            chunks.append(self.plan(*(c[start : start + size] for c in cat),
                                    backend=backend))
            start += size
        out = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
        split = _split(out, sizes)
        self.batches_run += len(chunks)
        self.requests_served += len(sizes)
        self.flows_served += total
        if not typed:
            return split
        return [InferResult(r.model, o, n) for r, o, n in zip(reqs, split, sizes)]


def _pegasus_demo(args) -> None:
    """--pegasus: train MLP-B on synthetic traffic, compile one plan and
    serve request batches on the chosen backend."""
    from repro_torch.data.synthetic_traffic import make_dataset
    from repro_torch.nets.mlp import pegasusify_mlp, train_mlp

    device = resolve_device(args.device)
    ds = make_dataset("peerrush", flows_per_class=120)
    mlp = train_mlp(ds.train["stats"], ds.train["label"], ds.num_classes,
                    steps=120, device=device)
    banks = pegasusify_mlp(mlp, ds.train["stats"].astype(np.float32), refine_steps=0)
    server = PegasusServer(banks, backend=args.backend, fuse=not args.no_fuse,
                           device=device)
    st0 = server.plan.compile_stats()
    print(f"plan compiled in {server.plan_build_ms:.1f} ms "
          f"({server.plan.num_banks} banks, {st0['fused_groups']} fused "
          f"groups covering {st0['fused_banks']} banks, backend={args.backend}, "
          f"device={device})")
    x = ds.test["stats"].astype(np.float32)
    requests = [InferRequest("mlp", x[i : i + args.batch])
                for i in range(0, min(len(x), 8 * args.batch), args.batch)]
    server.serve(requests)  # warm-up: first use of each bucket
    t0 = time.perf_counter()
    results = server.serve(requests)
    dt = time.perf_counter() - t0
    flows = sum(r.flows for r in results)
    print(f"served {len(requests)} requests ({flows} flows) in {dt * 1e3:.1f} ms "
          f"→ {flows / dt:.0f} flows/s on backend={args.backend}")
    st = server.stats()["engine"]
    print(f"dispatch: {st['traces']} first uses, {st['bucket_hits']} bucket "
          f"hits over {st['jit_calls']} calls; buckets={st['buckets']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pegasus", action="store_true",
                    help="serve a pegasusified MLP-B via the execution engine")
    ap.add_argument("--backend", default="onehot",
                    choices=["gather", "onehot", "kernel", "kernel_q8"],
                    help="engine backend bound to the serving plan")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable cross-bank primitive fusion")
    ap.add_argument("--batch", type=int, default=4, help="flows per request")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if not args.pegasus:
        ap.error("only --pegasus is ported; the LM server comes with a later slice")
    _pegasus_demo(args)


if __name__ == "__main__":
    main()
