"""The readers of the program's spans and serving counters: the device-idle
attribution of ``span_reduce`` on hand-made spans, each new reader on
hand-made and on served records, and the harness's runs with and without
the program's new counter (the parent program has none)."""

from __future__ import annotations

import importlib.util
import threading
import types

import numpy as np
import pytest

from bench import span_reduce
from bench.harness import run_cell
from conftest import ROOT, SMALL
from repro_torch import spans

KW = dict(t_start=0.0, device="cpu", overrides=SMALL, check_flows=20_000, warm_s=0.3)
NEW = ("server_us_per_kflow", "plan_us_per_kflow", "queue_wait_p95_ms.bulk", "pad_share",
       "h2d_pageable_bytes_per_flow", "idle_serving_share.bulk")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name.replace('.', '_')}", ROOT / "bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _hand_made():
    """Two rounds of the drain thread, the wait between them, and a plan
    call on another thread, with stamps in seconds."""
    rec = spans.Recorder(64)
    S = spans
    rec.add(S.SCHEDULER_PULL, 0.0, 1.0)
    rec.add(S.SCHEDULER_QUEUE, -5.0, 1.0)
    rec.add(S.SERVER_COALESCE, 1.0, 2.0)
    rec.add(S.PLAN_CALL, 2.0, 3.5)
    rec.add(S.SERVER_COPY_BACK, 4.0, 7.0)
    rec.add(S.SERVER_RESOLVE, 8.0, 9.0)
    rec.add(S.SERVER_ROUND, 0.0, 10.0)
    rec.add(S.SERVER_WAIT, 10.0, 12.0)
    rec.add(S.SCHEDULER_PULL, 12.0, 12.5)
    rec.add(S.SERVER_ROUND, 12.0, 15.0)
    other = threading.Thread(target=lambda: rec.add(S.PLAN_CALL, 3.0, 5.0))
    other.start()
    other.join(timeout=10)
    assert not other.is_alive()
    return rec.records()


BUSY = [(0.5, 2.6), (6.0, 7.0)]


def test_idle_is_credited_to_the_innermost_drain_span():
    recs = _hand_made()
    got = span_reduce.idle_by_span(BUSY, recs, 0.0, 16.0)
    want = {"scheduler.pull": 0.5 + 0.5, "plan.call": 0.9, "server.copy_back": 2.0,
            "server.resolve": 1.0, "server.round": 0.5 + 1.0 + 1.0 + 2.5,
            "server.wait": 2.0, "outside_spans": 1.0}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), k
    idle = 16.0 - sum(e - s for s, e in BUSY)
    assert sum(got.values()) == pytest.approx(idle, abs=1e-12)
    assert list(got) == sorted(got, key=lambda k: -got[k])
    # idle while inside a round: [0, 0.5), [2.6, 6), [7, 10), [12, 15)
    assert span_reduce.idle_in_rounds_s(BUSY, recs, 0.0, 16.0) == pytest.approx(9.9)
    # a window that cuts spans: only its own idle time is credited
    part = span_reduce.idle_by_span(BUSY, recs, 5.0, 11.0)
    assert part == pytest.approx({"server.copy_back": 1.0, "server.resolve": 1.0,
                                  "server.round": 2.0, "server.wait": 1.0,
                                  "outside_spans": 0.0})


def test_no_drain_spans_leaves_all_idle_outside():
    recs = spans.Recorder(4).records()
    assert span_reduce.idle_by_span(BUSY, recs, 0.0, 10.0) == {"outside_spans": 6.9}
    assert span_reduce.idle_in_rounds_s(BUSY, recs, 0.0, 10.0) == 0.0


def test_server_self_time_leaves_out_other_layers():
    recs = _hand_made()
    # rounds 10 + 3 s, less pull 1 + 0.5 and the drain thread's plan.call 1.5
    assert span_reduce.server_self_s(recs, 0.0, 16.0) == pytest.approx(13.0 - 3.0)
    assert span_reduce.server_self_s(recs, 0.0, 11.0) == pytest.approx(10.0 - 2.5)
    assert span_reduce.server_self_s(recs, 20.0, 30.0) == 0.0


def test_readers_on_hand_made_records():
    recs = _hand_made()
    serving = ({"flows_served": 0, "h2d_pageable_bytes": 0},
               {"flows_served": 4000, "h2d_pageable_bytes": 64_000})
    ctx = types.SimpleNamespace(
        t0=0.0, upto=16.0, serving=serving, spans=recs,
        plan_rows=({"kernel@4096": [4096, 4096]},
                   {"kernel@4096": [8192, 8192], "kernel@64": [50, 64]}),
        trace={"spans": BUSY, "window": 2.0})
    assert _reader("server_us_per_kflow")(ctx) == pytest.approx(10.0e9 / 4000)
    # every thread's plan calls: the drain thread's 1.5 s and the other's 2 s
    assert _reader("plan_us_per_kflow")(ctx) == pytest.approx(3.5e9 / 4000)
    assert _reader("queue_wait_p95_ms.bulk")(ctx) == pytest.approx(6000.0)
    assert _reader("pad_share")(ctx) == pytest.approx(1 - 4146 / 4160)
    assert _reader("h2d_pageable_bytes_per_flow")(ctx) == 16.0
    # the traced sub-window [16, 18] holds no round
    assert _reader("idle_serving_share.bulk")(ctx) == 0.0
    ctx.upto = 0.0
    assert _reader("idle_serving_share.bulk")(ctx) == pytest.approx(0.5 / 2.0)   # [0, 0.5)
    bare = types.SimpleNamespace(t0=0.0, upto=16.0, serving=(
        {"flows_served": 0}, {"flows_served": 4000}), trace=None)
    assert all(_reader(name)(bare) is None for name in NEW)


def test_readers_on_served_records():
    """Records of a real serve on the CPU, read as the readers read them:
    the server's own time, the plan calls and the scheduler's spans make up
    the rounds."""
    from repro_torch.launch.request import InferRequest
    from repro_torch.launch.serve import AsyncMultiModelServer

    from bench.harness import Cell

    cell = Cell.of("mlp-b", "bulk", overrides=SMALL)
    flows = cell.model.flows(cell.config, 7)
    import torch

    drawn = cell.model.draw(cell.config, tuple(torch.as_tensor(a) for a in flows), 7)
    x = flows[0]
    with AsyncMultiModelServer(backend="kernel", device="cpu") as srv:
        plan = srv.add_model("m", cell.model.program_model(cell.config, drawn))
        srv.submit(InferRequest("m", (x[:5],))).result(timeout=60)
        s0, rows0 = srv.stats()["serving"], plan.compile_stats()["rows"]
        t0 = __import__("time").perf_counter()
        spans.enable()
        try:
            for f in [srv.submit(InferRequest("m", (x[i:i + 1 + 4 * i],))) for i in range(60)]:
                f.result(timeout=60)
            s1, rows1 = srv.stats()["serving"], plan.compile_stats()["rows"]
        finally:
            srv.stop()
            recs = spans.disable()
    t1 = __import__("time").perf_counter()
    ctx = types.SimpleNamespace(t0=t0, upto=t1, serving=(s0, s1), spans=recs,
                                plan_rows=(rows0, rows1), trace=None)
    flows_served = s1["flows_served"] - s0["flows_served"]
    assert flows_served == sum(1 + 4 * i for i in range(60))
    server, plan_t = _reader("server_us_per_kflow")(ctx), _reader("plan_us_per_kflow")(ctx)
    assert server > 0 and plan_t > 0
    rounds = span_reduce.named(recs, "server.round")
    whole = float((recs.end[rounds] - recs.start[rounds]).sum()) * 1e9 / flows_served
    others = span_reduce.named(recs, "scheduler.pull")
    inside = others & rounds[span_reduce._roots(recs)]
    sched = float((recs.end[inside] - recs.start[inside]).sum()) * 1e9 / flows_served
    assert server + plan_t + sched == pytest.approx(whole, rel=1e-9)
    assert _reader("queue_wait_p95_ms.bulk")(ctx) >= 0
    assert 0 <= _reader("pad_share")(ctx) < 1
    assert _reader("h2d_pageable_bytes_per_flow")(ctx) == 16.0
    assert _reader("idle_serving_share.bulk")(ctx) is None     # no device trace


@pytest.mark.parametrize("workload, per_flow", [("mlp-b.bulk", 16.0), ("cnn-l.bulk", 496.0)])
def test_a_traced_run_reads_the_pageable_bytes(workload, per_flow):
    r = run_cell(workload, 2**31 + 11, 1.0, True, **KW)
    assert r["correct"]
    assert r["metrics"]["h2d_pageable_bytes_per_flow"]["value"] == per_flow
    assert r["metrics"]["h2d_pageable_bytes_per_flow"]["unit"] == "B/flow"
    # on the CPU no device trace: the span readers have nothing to read
    assert set(r["metrics"]) == {"flows_per_batch.bulk", "launches_per_kflow",
                                 "h2d_pageable_bytes_per_flow"}


def test_a_program_without_the_counter_reads_as_before(monkeypatch):
    """The parent program keeps no ``h2d_pageable_bytes``: the traced run
    reports every metric it reported before and no new one, and the
    untraced run keeps its keys."""
    from repro_torch.launch.serve import MultiModelServer

    stats = MultiModelServer.stats

    def older(self):
        st = stats(self)
        del st["serving"]["h2d_pageable_bytes"]
        return st

    monkeypatch.setattr(MultiModelServer, "stats", older)
    r = run_cell("mlp-b.bulk", 2**31 + 12, 1.0, True, **KW)
    assert r["correct"]
    assert set(r["metrics"]) == {"flows_per_batch.bulk", "launches_per_kflow"}
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "check",
                       "detail"]
    r0 = run_cell("mlp-b.bulk", 2**31 + 12, 1.0, False, **KW)
    assert set(r0["metrics"]) == {"flows_per_s", "setup_s"}
    assert list(r0) == list(r)


@pytest.mark.cuda
def test_a_traced_run_on_the_card_keeps_its_breakdown(card):
    r = run_cell("mlp-b.bulk", 2**31 + 13, 3.0, True, t_start=0.0, device="cuda",
                 warm_s=0.5)
    assert r["correct"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["metrics"]["h2d_pageable_bytes_per_flow"]["value"] == 16.0
    assert np.isfinite(r["metrics"]["idle_share.bulk"]["value"])
