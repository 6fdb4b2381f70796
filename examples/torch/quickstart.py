"""Quickstart (PyTorch/CUDA port): the paper's pipeline end to end on one GPU.

1. Train a dense MLP-B on synthetic traffic (stats features).
2. Lower it to Pegasus form: fuzzy trees + fused LUT banks (+ backprop refine).
3. Compile to the Tofino-2 MAT emulator; run packets through integer tables.
4. Compare accuracies + print the Table-6-style resource report.
5. Serve the model through the typed request API — an ``InferRequest``
   carrying a deadline and a priority, answered by an ``InferResult`` —
   across the host's CUDA devices (up to 4, one stream each).

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Each stage is a function whose sizes are keyword arguments with the
reference script's values (``examples/quickstart.py``) as defaults;
``main`` returns the figures it prints.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.data.synthetic_traffic import make_dataset
from repro_torch.dataplane.compile import compile_model
from repro_torch.device import resolve_device
from repro_torch.launch.serve import InferRequest, MultiModelServer
from repro_torch.nets.common import macro_f1
from repro_torch.nets.mlp import mlp_apply, pegasus_mlp_apply, pegasusify_mlp, train_mlp


def dense_teacher(device, *, flows_per_class: int = 600, steps: int = 400):
    """Stage 1: the dataset, the trained MLP-B and its test macro-F1."""
    print("== 1. data + dense teacher ==")
    ds = make_dataset("peerrush", flows_per_class=flows_per_class)
    stats, y = ds.train["stats"], ds.train["label"]
    mlp = train_mlp(stats, y, ds.num_classes, steps=steps, device=device)
    with torch.no_grad():
        logits = mlp_apply(mlp, torch.as_tensor(ds.test["stats"], device=device))
    f1 = macro_f1(logits.argmax(-1).cpu().numpy(), ds.test["label"], ds.num_classes)
    print(f"dense MLP-B macro-F1: {f1:.4f}")
    return ds, mlp, f1


def lower(mlp, calib: np.ndarray, *, refine_steps: int = 60, depth: int = 6):
    """Stage 2a: the four fused Pegasus banks, refined on the teacher's device."""
    print("== 2. pegasusify (Partition → fuzzy Map → SumReduce) ==")
    return pegasusify_mlp(mlp, calib.astype(np.float32), depth=depth,
                          refine_steps=refine_steps)


def pegasus_predictions(banks, ds, device, f1_dense: float) -> tuple[np.ndarray, float]:
    """Stage 2b: the banks' test predictions (``gather``) and macro-F1."""
    x = torch.as_tensor(ds.test["stats"], dtype=torch.float32, device=device)
    pred = pegasus_mlp_apply(banks, x, device=device).argmax(-1).cpu().numpy()
    f1 = macro_f1(pred, ds.test["label"], ds.num_classes)
    print(f"pegasus MLP-B macro-F1: {f1:.4f}  (delta {f1_dense - f1:+.4f})")
    return pred, f1


def switch_pipeline(banks, ds, peg_pred: np.ndarray, device, *,
                    stateful_bits_per_flow: int = 80, packets: int = 32):
    """Stage 3: the MAT pipeline, run on ``packets`` test flows on
    ``device``; its argmax agreement with the float tables."""
    print("== 3. compile to the MAT pipeline (integer tables) ==")
    pipe = compile_model(banks, stateful_bits_per_flow=stateful_bits_per_flow)
    out = pipe.run_batch(ds.test["stats"][:packets].astype(np.float32), device=device)
    agree = float((out.argmax(-1).cpu().numpy() == peg_pred[:packets]).mean())
    print(f"integer pipeline agrees with float tables on {agree:.0%} of packets")
    return pipe, agree


def resource_report(pipe) -> tuple[str, list[str]]:
    """Stage 4: the Table 6 row and the violated constraints."""
    print("== 4. switch resource report (Table 6 columns) ==")
    rep = pipe.report()
    print(f"{'model':<14} {'bits/flow':>6} {'SRAM':>7} {'TCAM':>8} {'Bus':>8}")
    row, violations = rep.table6_row("MLP-B"), rep.validate()
    print(row)
    print("constraint violations:", violations or "none — deployable")
    return row, violations


def serve(banks, ds, device, *, request_sizes: tuple = (48, 17)) -> dict:
    """Stage 5: ``MultiModelServer`` over up to 4 CUDA devices (one stream
    each; inline on one card or the CPU) answering a high-priority request
    with a deadline and a low-priority one."""
    print("== 5. serve it (typed request API, per-device streams) ==")
    ndev = min(torch.cuda.device_count(), 4) if device.type == "cuda" else 0
    server = MultiModelServer({"mlp": banks}, devices=ndev if ndev > 1 else None,
                              device=device)
    try:
        x = torch.as_tensor(ds.test["stats"], dtype=torch.float32, device=device)
        hi, lo = request_sizes
        reqs = [InferRequest("mlp", x[:hi], deadline_ms=5000.0, priority="high"),
                InferRequest("mlp", x[hi:hi + lo], priority="low")]
        results = server.serve(reqs)
        for req, res in zip(reqs, results):
            wait = (f"{res.queue_wait_ms:.2f}" if res.queue_wait_ms
                    is not None else "n/a")
            print(f"  {req.priority:6s} request: {res.flows:3d} flows → "
                  f"{tuple(res.output.shape)} (queue wait {wait} ms)")
        dev = server.stats()["devices"]
        flows = [d["dispatched_flows"] for d in dev["per_device"]]
        print(f"  {dev['count']} device stream(s)"
              f"{f', flows per stream {flows}' if flows else ''}")
    finally:
        server.close()
    return dict(outputs=[np.asarray(r.output) for r in results],
                flows=[r.flows for r in results], streams=dev["count"],
                flows_per_stream=flows)


def main(argv=None, *, flows_per_class: int = 600, steps: int = 400,
         refine_steps: int = 60, depth: int = 6, request_sizes: tuple = (48, 17)) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds, mlp, f1_dense = dense_teacher(device, flows_per_class=flows_per_class, steps=steps)
    banks = lower(mlp, ds.train["stats"], refine_steps=refine_steps, depth=depth)
    peg_pred, f1_peg = pegasus_predictions(banks, ds, device, f1_dense)
    pipe, agree = switch_pipeline(banks, ds, peg_pred, device)
    row, violations = resource_report(pipe)
    served = serve(banks, ds, device, request_sizes=request_sizes)
    return dict(f1_dense=f1_dense, f1_pegasus=f1_peg, agreement=agree, table6_row=row,
                violations=violations, served=served)


if __name__ == "__main__":
    main()
