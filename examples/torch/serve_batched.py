"""Multi-model ASYNC serving demo on the PyTorch/CUDA port: many Pegasus
models behind ONE server.

The paper's pitch is a *shared* dataplane — one switch serving many traffic
classes and models at once. This demo is the host-side analog on a GPU: an
MLP classifier (high priority), an RNN classifier and an AutoEncoder
anomaly scorer (low priority) are trained on synthetic traffic, compiled
into ExecutionPlans, and registered under names in one
``AsyncMultiModelServer``. A mixed burst of :class:`InferRequest`s is
submitted from the caller's thread as futures; the background drain loop
coalesces same-model requests into bucket-aligned micro-batches and
schedules the models by weighted fair queueing (deficit round-robin — the
4x-weighted MLP gets 4x the flow share and dispatches first each round).
Every request also carries a per-request ``priority``: "high" requests
jump ahead of "normal"/"low" ones *within* their model's queue, on top of
the cross-model WFQ share. The wrap-up prints the consolidated nested
``stats()`` — serving counters, compile-cache state, queue-wait
percentiles, and (with ``--devices``) the per-device stream utilization.

``--backend kernel`` runs MLP-B and the AE as fused bank stacks (one
``fuzzy_lut_stack`` launch per batch) and RNN-B's banks one launch each
(``fuzzy_lut``); ``kernel_q8`` runs their int8 counterparts. On the card
every plan call replays a CUDA graph.

With ``--deadline-ms B`` every request carries an end-to-end latency
budget: requests the scheduler predicts (or observes) missing it are shed
— async futures fail with ``DeadlineExceededError`` and the client counts
them instead of crashing; the sync flavor reads the per-model shed tally
off ``server.last_shed`` after ``drain()``. The wrap-up then also prints
the per-model SLO counters (admitted/rejected/shed/goodput — see
docs/SERVING.md for the field reference).

With ``--devices K`` the server feeds K per-device executor streams, one
CUDA stream on each of the first K cards (chunks placed on the
least-loaded stream).

Run:  PYTHONPATH=src python examples/torch/serve_batched.py [--backend kernel]
      add --sync for the synchronous submit+drain flavor
      add --deadline-ms 150 for the deadline-bearing client
      add --devices 4 for multi-device serving (four cards)
      add --device cpu to run off the card (kernels as their plain versions)

``build_models`` and ``serve`` take their sizes as keyword arguments with
the reference script's values (``examples/serve_batched.py``) as defaults;
``main`` returns the figures it prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data.synthetic_traffic import make_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.serve import (
    AsyncMultiModelServer, DeadlineExceededError, InferRequest,
    MultiModelServer,
)
from repro_torch.nets.autoencoder import anomaly_features, pegasusify_ae, train_autoencoder
from repro_torch.nets.mlp import pegasusify_mlp, train_mlp
from repro_torch.nets.rnn import pegasusify_rnn, train_rnn

# per-REQUEST priority (queue-jump within a model's own queue) — layered on
# top of the per-MODEL WFQ weight set at add_model time
REQUEST_PRIORITY = {"mlp-stats": "high", "rnn-seq": "normal",
                    "ae-anomaly": "low"}
# per-MODEL WFQ priority: the inline classifier 4x, the background anomaly
# sweep 0.25x
MODEL_PRIORITY = {"mlp-stats": "high", "rnn-seq": None, "ae-anomaly": "low"}
# rows of each request in one burst, one request per model at each size
BURST_SIZES = (48, 17, 80)


def build_models(device, *, steps: int = 120, flows_per_class: int = 200):
    """The dataset and the three pegasusified models, by serving name."""
    ds = make_dataset("peerrush", flows_per_class=flows_per_class)  # test split: 90 flows
    flat = ds.train["seq"].reshape(len(ds.train["label"]), -1)

    print(f"== training 3 teachers (steps={steps}) ==")
    mlp = train_mlp(ds.train["stats"], ds.train["label"], ds.num_classes,
                    steps=steps, device=device)
    rnn = train_rnn(ds.train["seq"], ds.train["label"], ds.num_classes,
                    steps=steps, device=device)
    ae = train_autoencoder(flat, steps=steps, device=device)
    models = {
        "mlp-stats": pegasusify_mlp(mlp, ds.train["stats"].astype(np.float32),
                                    refine_steps=0),
        "rnn-seq": pegasusify_rnn(rnn, ds.train["seq"], depth=4),
        "ae-anomaly": pegasusify_ae(ae, flat.astype(np.float32)),
    }
    return ds, models


def serve(models: dict, ds, device, *, backend: str = "onehot", sync: bool = False,
          devices=None, deadline_ms: float | None = None, rounds: int = 3) -> dict:
    """Register the models behind one server and time ``rounds`` bursts
    after a warm-up burst. Returns the figures printed, the last burst's
    outputs by model (numpy, in submit order) and the whole schedule log."""
    print(f"== compiling + registering (backend={backend}"
          f"{f', devices={devices}' if devices else ''}) ==")
    cls = MultiModelServer if sync else AsyncMultiModelServer
    server = cls(backend=backend, devices=devices, device=device)
    try:
        return _serve(server, models, ds, sync=sync, deadline_ms=deadline_ms,
                      rounds=rounds)
    finally:
        if not sync and server.running:
            server.stop(drain=False)
        server.close()


def _serve(server, models, ds, *, sync, deadline_ms, rounds) -> dict:
    t0 = time.perf_counter()
    for name, model in models.items():
        server.add_model(name, model, priority=MODEL_PRIORITY[name])
    compile_ms = (time.perf_counter() - t0) * 1e3
    sched = server.stats()["scheduler"]["models"]
    print(f"3 plans compiled in {compile_ms:.0f} ms: "
          f"{server.models()} (weights "
          f"{ {n: c['weight'] for n, c in sched.items()} })")

    # a mixed burst: three models × assorted request sizes, every request a
    # typed InferRequest carrying its own deadline + priority; inputs are
    # tensors on the server's device
    dev = server.device
    x_stats = torch.as_tensor(ds.test["stats"], dtype=torch.float32, device=dev)
    x_seq = torch.as_tensor(ds.test["seq"], device=dev)
    x_feat = anomaly_features(
        ds.test["seq"].reshape(len(ds.test["label"]), -1)).to(dev)
    inputs = (("mlp-stats", x_stats), ("rnn-seq", x_seq), ("ae-anomaly", x_feat))
    flows = sum(int(x[:s].shape[0]) for s in BURST_SIZES for _, x in inputs)

    shed = {"count": 0}           # deadline sheds seen by this client

    def submit_burst():
        futs = []
        for s in BURST_SIZES:
            for name, x in inputs:
                req = InferRequest(name, x[:s], deadline_ms=deadline_ms,
                                   priority=REQUEST_PRIORITY[name])
                try:
                    futs.append((name, server.submit(req)))
                except DeadlineExceededError:
                    # admission control: the backlog already predicts a
                    # miss, so the submit is refused before queueing
                    shed["count"] += 1
        return futs

    if sync:
        def burst():
            submit_burst()
            out = server.drain()
            # sync submits carry no future; drain() tallies their sheds
            shed["count"] += sum(server.last_shed.values())
            return out
    else:
        server.start()            # background drain loop: always-on serving

        def burst():
            futs = submit_burst()           # thread-safe, returns futures
            by_model: dict = {}
            for name, f in futs:
                try:
                    # typed submits resolve to InferResult (output + flows
                    # + measured queue_wait_ms)
                    res = f.result(timeout=600)
                    by_model.setdefault(name, []).append(res.output)
                except DeadlineExceededError:
                    shed["count"] += 1      # served late is worthless: skip
            return by_model

    burst()  # warmup: builds each (model, bucket) path (a CUDA graph on the card)
    server.reset_latency_stats()
    t0 = time.perf_counter()
    log_before = server.batches_dispatched
    for _ in range(rounds):
        out = burst()
    dt = (time.perf_counter() - t0) / rounds
    per_burst = (server.batches_dispatched - log_before) // rounds
    mode = "sync drain" if sync else "async loop"
    print(f"\nserved {len(BURST_SIZES) * 3} requests ({flows} flows) per burst in "
          f"{dt * 1e3:.1f} ms via {mode} → {flows / dt:.0f} flows/s aggregate")
    if deadline_ms is not None:
        print(f"deadline budget {deadline_ms:.0f} ms: {shed['count']} "
              f"request(s) shed across all rounds — handled by the client, "
              f"served work stayed within budget")
    schedule = list(server.schedule_log)
    print(f"schedule (WFQ deficit round-robin, {per_burst} micro-batches/"
          f"burst): {schedule[-per_burst:] if per_burst else []}")
    for name, outs in out.items():
        print(f"  {name:11s} → {len(outs)} outputs, shapes "
              f"{[tuple(o.shape) for o in outs]}")
    if not sync:
        server.stop()

    # consolidated nested stats: serving / engine / scheduler / slo / devices
    print("\nper-model serving stats:")
    st = server.stats()
    for name, s in st["serving"]["models"].items():
        em = st["engine"]["models"][name]
        lat = st["scheduler"]["latency"].get(name, {}).get("queue_wait_ms", {})
        wait = (f"p50_wait={lat['p50']:.2f} ms p99={lat['p99']:.2f} ms"
                if lat else "")
        print(f"  {name:11s} requests={s['requests_served']:3d} "
              f"batches={s['batches_run']:3d} flows={s['flows_served']:5d} "
              f"traces={em['traces']} bucket_hits={em['bucket_hits']} "
              f"build={em['plan_build_ms']:.0f} ms "
              f"tables={em['table_bytes'] / 1024:.0f} KiB {wait}")
        slo = st["slo"]["models"].get(name)
        if deadline_ms is not None and slo:
            print(f"  {'':11s}   slo: admitted={slo['admitted']} "
                  f"rejected={slo['rejected']} shed={slo['shed']} "
                  f"goodput_flows={slo['goodput_flows']} "
                  f"late_flows={slo['late_flows']} "
                  f"max_wait={slo['max_wait_ms']:.1f} ms")
    print(f"registry: {st['engine']['cache']}")
    print(f"scheduler: {st['scheduler']['models']}")
    devs = st["devices"]
    print(f"devices: {devs['count']} stream(s)")
    for d in devs["per_device"]:
        print(f"  {d['device']:16s} chunks={d['dispatched_chunks']:4d} "
              f"flows={d['dispatched_flows']:6d} "
              f"util={d['utilization']:.0%} pending={d['pending_flows']}")
    return dict(
        mode=mode, compile_ms=compile_ms, flows_per_burst=flows, burst_ms=dt * 1e3,
        flows_per_s=flows / dt, batches_per_burst=per_burst, shed=shed["count"],
        schedule_log=schedule,
        outputs={name: [np.asarray(o) for o in outs] for name, outs in out.items()},
        models={name: {k: s[k] for k in ("requests_served", "batches_run", "flows_served")}
                for name, s in st["serving"]["models"].items()},
        fallback_batches={name: h["fallback_batches"]
                          for name, h in st["health"]["models"].items()},
        drain_errors={name: repr(e) for name, e in server.last_drain_errors.items()},
        streams=devs["count"])


def main(argv=None, *, flows_per_class: int = 200) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="onehot",
                    choices=["gather", "onehot", "kernel", "kernel_q8"])
    ap.add_argument("--steps", type=int, default=120, help="teacher train steps")
    ap.add_argument("--rounds", type=int, default=3, help="timed burst rounds")
    ap.add_argument("--sync", action="store_true",
                    help="use the synchronous submit+drain path instead of "
                         "the async background loop")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="attach this latency budget (ms) to every request; "
                         "requests that cannot make it are shed with "
                         "DeadlineExceededError instead of served late")
    ap.add_argument("--devices", type=int, default=None,
                    help="serve through this many per-device executor "
                         "streams, one on each of the first K cards")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds, models = build_models(device, steps=args.steps, flows_per_class=flows_per_class)
    return serve(models, ds, device, backend=args.backend, sync=args.sync,
                 devices=args.devices, deadline_ms=args.deadline_ms,
                 rounds=args.rounds)


if __name__ == "__main__":
    main()
