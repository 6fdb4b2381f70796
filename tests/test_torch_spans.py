"""The span recorder (``repro_torch.spans``) and the serving counters beside
it, on the CPU through ``AsyncMultiModelServer``: off, serving records
nothing and answers as it does on; on, spans nest on their thread and agree
with the server's counters; ``h2d_pageable_bytes`` and
``compile_stats()["rows"]`` count what was copied and padded; a full
recorder drops and counts. One case needs the card (the graph replay's
spans). Imports no JAX."""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.data.synthetic_traffic import make_dataset
from repro_torch.engine import bucket_batch, build_plan
from repro_torch.launch.request import InferRequest
from repro_torch.launch.serve import AsyncMultiModelServer, _pageable_nbytes
from repro_torch.nets.mlp import pegasusify_mlp, train_mlp

SIZES = (1, 3, 8, 20, 64, 70, 130)
SERVER_KW = dict(backend="kernel", max_batch=64)


@pytest.fixture(scope="module")
def mlp():
    """A small pegasusified MLP-B on the CPU and its flow statistics."""
    ds = make_dataset("peerrush", flows_per_class=48, seed=3)
    x = ds.train["stats"]
    teacher = train_mlp(x, ds.train["label"], ds.num_classes, steps=5, device="cpu")
    banks = pegasusify_mlp(teacher, x.astype(np.float32), depth=3, refine_steps=0)
    return banks, np.ascontiguousarray(np.concatenate([x] * 4))


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off."""
    assert spans.RECORDER is None
    yield
    if spans.RECORDER is not None:
        spans.disable()


def _requests(x, n=40, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = int(rng.choice(SIZES))
        off = int(rng.integers(0, len(x) - size))
        out.append(x[off:off + size])
    return out


def _serve(banks, reqs, *, recorder: bool, senders: int = 2):
    """Serve ``reqs`` from ``senders`` threads; returns the outputs, the
    serving counters' change and the records (None when off)."""
    with AsyncMultiModelServer(device="cpu", **SERVER_KW) as srv:
        srv.add_model("mlp", banks)
        srv.submit(InferRequest("mlp", reqs[0])).result(timeout=60)   # first use
        s0 = srv.stats()["serving"]
        if recorder:
            spans.enable()
        futs = [None] * len(reqs)

        def send(k):
            for i in range(k, len(reqs), senders):
                futs[i] = srv.submit(InferRequest("mlp", reqs[i]))

        threads = [threading.Thread(target=send, args=(k,)) for k in range(senders)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        outs = [f.result(timeout=60).output for f in futs]
        s1 = srv.stats()["serving"]
    recs = spans.disable() if recorder else None     # the drain thread has stopped
    delta = {k: s1[k] - s0[k] for k in ("requests_served", "flows_served",
                                        "batches_dispatched", "h2d_pageable_bytes")}
    return outs, delta, recs


def test_off_records_nothing_and_answers_as_on(mlp):
    banks, x = mlp
    reqs = _requests(x)
    off, _, _ = _serve(banks, reqs, recorder=False)
    assert spans.RECORDER is None
    spans.enable()
    assert len(spans.disable()) == 0
    on, _, recs = _serve(banks, reqs, recorder=True)
    assert len(recs) > 0
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


def _name(recs, i):
    return recs.names[recs.name[i]]


def test_spans_nest_and_agree_with_the_counters(mlp):
    banks, x = mlp
    reqs = _requests(x, seed=1)
    _, delta, recs = _serve(banks, reqs, recorder=True)
    assert recs.dropped == 0
    want_parent = {"scheduler.pull": "server.round", "server.coalesce": "server.round",
                   "plan.call": "server.round", "scheduler.queue": "server.round",
                   "server.copy_back": "server.round", "server.resolve": "server.round"}
    for i in range(len(recs)):
        name, p = _name(recs, i), recs.parent[i]
        assert recs.end[i] >= recs.start[i], name
        if name in want_parent:
            assert p >= 0 and _name(recs, p) == want_parent[name], (name, p)
        if p < 0:
            continue
        assert recs.thread[i] == recs.thread[p], name
        if name == "scheduler.queue":
            # submit to dispatch: it ends inside the round that dispatched it
            assert recs.start[p] <= recs.end[i] <= recs.end[p]
            assert recs.start[i] <= recs.end[i]
        else:
            assert recs.start[p] <= recs.start[i] and recs.end[i] <= recs.end[p], name
    assert len(recs.of("plan.call")) == delta["batches_dispatched"]
    assert len(recs.of("scheduler.queue")) == delta["requests_served"] == len(reqs)
    assert len(recs.of("server.round")) == len(recs.of("scheduler.pull"))
    # the drain thread records every span; the senders record none
    assert len(set(recs.thread)) == 1


def test_h2d_pageable_bytes_counts_what_coalesce_copies(mlp, monkeypatch):
    banks, x = mlp
    reqs = _requests(x, n=12, seed=2)
    _, delta, _ = _serve(banks, reqs, recorder=False)
    assert delta["h2d_pageable_bytes"] == sum(r.nbytes for r in reqs)
    assert delta["h2d_pageable_bytes"] == delta["flows_served"] * x.shape[1] * x.itemsize
    tensors = [torch.as_tensor(r) for r in reqs]
    _, delta, _ = _serve(banks, tensors, recorder=False)
    assert delta["h2d_pageable_bytes"] == sum(r.nbytes for r in reqs)
    # pinned host memory is not pageable (this machine may have no pinned memory)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
    _, delta, _ = _serve(banks, tensors, recorder=False)
    assert delta["h2d_pageable_bytes"] == 0 and delta["flows_served"] > 0


def test_pageable_nbytes():
    a = np.zeros((5, 16), np.uint8)
    assert _pageable_nbytes(a) == 80 and _pageable_nbytes(a.tolist()) == 80 * 8
    assert _pageable_nbytes(torch.zeros(5, 3)) == 60
    assert _pageable_nbytes(torch.zeros(0, 3)) == 0


def test_compile_stats_rows_are_requested_and_dispatched_rows(mlp):
    banks, x = mlp
    plan = build_plan(banks, backend="kernel", device="cpu")
    want: dict = {}
    for n in (3, 8, 70, 200, 5, 4096, 4097):
        plan(np.resize(x, (n, x.shape[1])))
        row = want.setdefault(f"kernel@{bucket_batch(n)}", [0, 0])
        row[0] += n
        row[1] += bucket_batch(n)
    assert plan.compile_stats()["rows"] == want
    assert set(plan.compile_stats()["pad_waste"]) == set(want)


def test_served_rows_add_up_to_the_flows(mlp):
    banks, x = mlp
    reqs = _requests(x, seed=4)
    with AsyncMultiModelServer(device="cpu", **SERVER_KW) as srv:
        plan = srv.add_model("mlp", banks)
        for f in [srv.submit(InferRequest("mlp", r)) for r in reqs]:
            f.result(timeout=60)
        rows = plan.compile_stats()["rows"]
        st = srv.stats()["serving"]
    assert sum(r[0] for r in rows.values()) == st["flows_served"]
    calls = 0
    for key, (req, disp) in rows.items():
        bucket = int(key.split("@")[1])
        assert disp % bucket == 0 and req <= disp, key
        calls += disp // bucket
    assert calls == st["batches_dispatched"]


def test_a_full_recorder_drops_and_counts(mlp):
    rec = spans.Recorder(capacity=3)
    rec.add(spans.SERVER_COALESCE, 3.0, 3.5)
    rec.add(spans.SERVER_ROUND, 2.0, 4.0)
    rec.add_all(spans.SCHEDULER_QUEUE, [0.5, 1.0], 2.5)   # the second is dropped
    rec.add(spans.SERVER_ROUND, 1.0, 6.0)                 # dropped
    recs = rec.records()
    assert len(recs) == 3 and recs.dropped == 2
    assert list(recs.parent) == [1, -1, 1] and list(recs.end) == [3.5, 4.0, 2.5]
    # through the server: serving goes on, the rest is counted
    banks, x = mlp
    reqs = _requests(x, n=30, seed=5)
    spans.RECORDER = spans.Recorder(capacity=16)
    try:
        with AsyncMultiModelServer(device="cpu", **SERVER_KW) as srv:
            srv.add_model("mlp", banks)
            outs = [f.result(timeout=60) for f in
                    [srv.submit(InferRequest("mlp", r)) for r in reqs]]
    finally:
        recs = spans.disable()
    assert len(outs) == len(reqs)
    assert len(recs) == 16 and recs.dropped > 30


def test_appends_from_many_threads_lose_nothing():
    """Eight threads record nested spans at a short switch interval: every
    span gets its own slot, and its parent is on its own thread."""
    rec = spans.Recorder(capacity=1 << 16)
    n = 1000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(8)

        def work(j):
            start.wait(timeout=60)            # all eight alive at once
            for k in range(n):
                t = 4.0 * (k + j * n)         # each thread's own stretch of time
                rec.add(spans.SERVER_COALESCE, t + 1, t + 2)
                rec.add(spans.PLAN_CALL, t + 1.5, t + 1.75)
                rec.add(spans.SERVER_ROUND, t, t + 3)

        threads = [threading.Thread(target=work, args=(j,)) for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    recs = rec.records()
    assert len(recs) == 8 * n * 3 and recs.dropped == 0
    rounds, outer, calls = (recs.of(k) for k in ("server.round", "server.coalesce", "plan.call"))
    assert len(rounds) == len(outer) == len(calls) == 8 * n
    assert (recs.parent[rounds] == -1).all()
    for kids, up in ((outer, spans.SERVER_ROUND), (calls, spans.SERVER_COALESCE)):
        p = recs.parent[kids]
        assert (recs.name[p] == up).all() and (recs.thread[p] == recs.thread[kids]).all()
        assert (recs.start[p] <= recs.start[kids]).all() and (recs.end[kids] <= recs.end[p]).all()


def test_enable_twice_and_disable_off_raise():
    spans.enable(8)
    with pytest.raises(RuntimeError, match="on already"):
        spans.enable(8)
    spans.disable()
    with pytest.raises(RuntimeError, match="off"):
        spans.disable()
    with pytest.raises(ValueError):
        spans.Recorder(0)


@pytest.mark.cuda
def test_graph_replays_on_the_card_record_as_on_the_cpu(mlp):
    """On the card each plan call replays a CUDA graph, and the copy back
    waits for the device: the spans still nest in their rounds and count
    one ``plan.call`` a chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    banks, x = mlp
    reqs = _requests(x, seed=6)
    with AsyncMultiModelServer(device="cuda", **SERVER_KW) as srv:
        plan = srv.add_model("mlp", banks)
        for b in plan.buckets:                      # capture every bucket first
            srv.submit(InferRequest("mlp", np.resize(x, (b, x.shape[1])))).result(timeout=300)
        s0 = srv.stats()["serving"]
        spans.enable()
        outs = [f.result(timeout=60) for f in
                [srv.submit(InferRequest("mlp", r)) for r in reqs]]
        s1 = srv.stats()["serving"]
    recs = spans.disable()
    assert len(outs) == len(reqs)
    calls = recs.of("plan.call")
    assert len(calls) == s1["batches_dispatched"] - s0["batches_dispatched"] > 0
    # host requests cross through the pinned stage: none of it is pageable
    assert s1["h2d_pageable_bytes"] - s0["h2d_pageable_bytes"] == 0
    assert s1["h2d_staged_bytes"] - s0["h2d_staged_bytes"] == sum(r.nbytes for r in reqs)
    for kids in (calls, recs.of("server.copy_back")):
        p = recs.parent[kids]
        assert (recs.name[p] == spans.SERVER_ROUND).all()
        assert (recs.start[p] <= recs.start[kids]).all() and (recs.end[kids] <= recs.end[p]).all()
