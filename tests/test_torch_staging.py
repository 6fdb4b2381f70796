"""The pinned stage of the serving path (``launch/serve.py`` ``PinnedStage``):
on the CPU, its packing against ``np.concatenate`` and ``torch.cat`` on a
plain host buffer, zero padding rows, slot reuse behind a stub event, the
CPU and stream pool paths of ``_coalesce`` left as they were, and every
caller off the direct path given a fresh tensor by ``plan(*inputs)``; on
the card, served outputs bit-equal to the unstaged path and to the plan,
two models in one round, a buffer that grows, the byte counters, and the
direct path (each chunk copied once each way between the stage's slots
and the graph's static buffers): padded rows, slots held and handed back,
a failing chunk, and ``chunks_direct``. Imports no JAX."""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import importlib.util
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic_traffic import make_dataset
from repro_torch.engine import bucket_batch, bucket_chunks, build_plan
from repro_torch.engine.plan import ExecutionPlan
from repro_torch.launch.request import InferRequest
from repro_torch.launch.serve import (
    AsyncMultiModelServer, MultiModelServer, PegasusServer, PinnedStage, _coalesce,
)
from repro_torch.nets.mlp import pegasusify_mlp, train_mlp

CUDA = torch.device("cuda")


class StubEvent:
    """Stands in for ``torch.cuda.Event``: done until recorded, then not
    done until the test says so."""

    def __init__(self):
        self.done = True
        self.records = 0

    def record(self, stream):
        self.done = False
        self.records += 1

    def query(self):
        return self.done


def _stage():
    return PinnedStage(pin=False, event=StubEvent)



def _rng_rows(rng, n, shape, dtype):
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal((n, *shape)).astype(dtype)
    return rng.integers(0, 256, (n, *shape)).astype(dtype)


PACK_CASES = {
    "uint8, 1-row requests": [[(1, (8, 2), np.uint8), (37, (8, 2), np.uint8),
                               (1, (8, 2), np.uint8), (4096, (8, 2), np.uint8)]],
    "float32": [[(5, (16,), np.float32), (1, (16,), np.float32), (300, (16,), np.float32)]],
    "two inputs of other trailing shapes": [
        [(3, (8, 2), np.uint8), (1, (8, 2), np.uint8), (70, (8, 2), np.uint8)],
        [(3, (8, 60), np.uint8), (1, (8, 60), np.uint8), (70, (8, 60), np.uint8)]],
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_equals_concatenate(case):
    rng = np.random.default_rng(0)
    cols = [[_rng_rows(rng, n, shape, dt) for n, shape, dt in col] for col in PACK_CASES[case]]
    slot = _stage().take(CUDA)
    views = slot.pack(cols)
    assert len(views) == len(cols)
    for v, col, buf in zip(views, cols, slot.bufs):
        want = np.concatenate(col)
        assert v.dtype == torch.from_numpy(want).dtype and not v.is_pinned()
        assert v.data_ptr() == buf.data_ptr()
        np.testing.assert_array_equal(v.numpy(), want)


def test_pack_takes_cpu_tensors_and_lists_as_torch_cat_does():
    """A CPU tensor and a list among numpy requests; a list of ints comes out
    as ``torch.cat`` makes it (int64, the other rows promoted), and requests
    that differ in dtype are promoted as ``torch.cat`` promotes them."""
    rng = np.random.default_rng(1)
    a = _rng_rows(rng, 4, (3,), np.float32)
    t = torch.as_tensor(_rng_rows(rng, 2, (3,), np.float32))
    rows = [[1.5, 2.0, -3.0]]
    cols = [[a, t, rows], [a.astype(np.uint8), t.to(torch.uint8), [[1, 2, 3]]],
            [a.astype(np.uint8), t.to(torch.int8), a[:1]]]
    slot = _stage().take(CUDA)
    views = slot.pack(cols)
    for v, col, buf in zip(views, cols, slot.bufs):
        want = torch.cat([torch.as_tensor(x) for x in col])
        assert v.dtype == want.dtype and v.shape == want.shape
        assert torch.equal(v, want) and v.data_ptr() == buf.data_ptr()
    assert views[0].dtype == torch.float32
    assert views[1].dtype == torch.int64
    assert views[2].dtype == torch.float32
    np.testing.assert_array_equal(views[0].numpy(), np.concatenate([a, t.numpy(), rows]))


@pytest.mark.parametrize("shapes", [((2, 3), (2, 4)), ((2, 3), (2,)), ((2, 8, 2), (1, 2, 8))])
def test_pack_raises_as_torch_cat(shapes):
    cols = [[np.zeros(s, np.float32) for s in shapes]]
    with pytest.raises(RuntimeError) as want:
        torch.cat([torch.as_tensor(x) for x in cols[0]])
    with pytest.raises(RuntimeError) as got:
        _stage().take(CUDA).pack(cols)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_pads_with_zero_rows(case):
    """Packed to more rows than the requests hold, each view carries the
    requests' rows and then zero rows, also where an earlier pack left
    other bytes in the buffer."""
    rng = np.random.default_rng(3)
    cols = [[_rng_rows(rng, n, shape, dt) for n, shape, dt in col] for col in PACK_CASES[case]]
    slot = _stage().take(CUDA)
    total = sum(len(x) for x in cols[0])
    slot.pack([[np.full((total + 40, *c[0].shape[1:]), 7, c[0].dtype)] for c in cols])
    for views in (slot.pack(cols, total + 40),
                  slot.pack([[torch.as_tensor(x) for x in col] for col in cols], total + 40)):
        for v, col, buf in zip(views, cols, slot.bufs):
            assert v.shape[0] == total + 40 and v.data_ptr() == buf.data_ptr()
            np.testing.assert_array_equal(v[:total].numpy(), np.concatenate(col))
            assert not v[total:].any()


def test_buffers_grow_by_doubling_and_never_shrink():
    slot = _stage().take(CUDA)
    small = [np.ones((10, 16), np.uint8)]
    slot.pack([small])
    assert slot.bufs[0].numel() == 160
    views = slot.pack([[np.full((100, 16), 7, np.uint8), np.full((30, 16), 9, np.uint8)]])
    assert slot.bufs[0].numel() == 160 * 16 >= 130 * 16
    assert (views[0][:100] == 7).all() and (views[0][100:] == 9).all()
    slot.pack([small])
    assert slot.bufs[0].numel() == 160 * 16
    # a second input position gets a buffer of its own
    views = slot.pack([small, [np.full((10, 4), 2.5, np.float32)]])
    assert [b.numel() for b in slot.bufs] == [160 * 16, 160]
    assert (views[1] == 2.5).all() and views[1].data_ptr() == slot.bufs[1].data_ptr()


def test_a_slot_is_reused_only_once_its_copies_completed():
    stage = _stage()
    a = stage.take(CUDA)
    b = stage.take(CUDA)                        # a is held: a new slot
    assert b is not a
    stage.release(a, stream=None)
    assert a.event.records == 1 and not a.event.query()
    c = stage.take(CUDA)                        # a's copies are in flight
    assert c is not a and c is not b
    a.event.done = True
    assert stage.take(CUDA) is a
    stage.release(b, stream=None)
    stage.release(c, stream=None)
    b.event.done = c.event.done = True
    # a slot of another device is not handed out for this one
    other = stage.take(torch.device("cuda", 1))
    assert other not in (a, b, c)
    assert stage.take(CUDA) is b
    assert len(stage._slots) == 4


def test_no_slot_is_held_twice_under_contention():
    """More threads than cores take and release slots with a short switch
    interval: a slot handed to two holders at once would show as a second
    owner."""
    stage = _stage()
    owner: dict = {}
    clashes = []

    def work(k):
        for _ in range(300):
            s = stage.take(CUDA)
            if owner.setdefault(id(s), k) != k:
                clashes.append(k)
            del owner[id(s)]
            stage.release(s, stream=None)
            s.event.done = True

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not clashes
    assert 1 <= len(stage._slots) <= 16


def test_coalesce_off_the_card_copies_as_before():
    """A CPU plan and the stream pool (device None) take nothing from the
    stage: the same concatenations and the same pageable byte count."""
    rng = np.random.default_rng(2)
    reqs = [(_rng_rows(rng, n, (8, 2), np.uint8), _rng_rows(rng, n, (8, 60), np.uint8))
            for n in (1, 5, 40)]
    stage = _stage()
    cat, sizes, total, chunks, pageable, staged, slot = _coalesce(
        reqs, torch.device("cpu"), stage, hold=True)
    assert (sizes, total, chunks, staged, slot) == ([1, 5, 40], 46, [32, 14], 0, None)
    assert pageable == sum(x.nbytes for r in reqs for x in r)
    for c, i in zip(cat, range(2)):
        assert isinstance(c, torch.Tensor)
        np.testing.assert_array_equal(c.numpy(), np.concatenate([r[i] for r in reqs]))
    cat, sizes, total, chunks, pageable, staged, slot = _coalesce(reqs, None, stage)
    assert (pageable, staged, slot) == (0, 0, None)
    assert all(isinstance(c, np.ndarray) for c in cat)
    for c, i in zip(cat, range(2)):
        np.testing.assert_array_equal(c, np.concatenate([r[i] for r in reqs]))
    assert stage._slots == []


@pytest.fixture(scope="module")
def mlp_cpu():
    ds = make_dataset("peerrush", flows_per_class=48, seed=4)
    x = ds.train["stats"]
    teacher = train_mlp(x, ds.train["label"], ds.num_classes, steps=5, device="cpu")
    banks = pegasusify_mlp(teacher, x.astype(np.float32), depth=3, refine_steps=0)
    return banks, np.ascontiguousarray(np.concatenate([x] * 4))


def _sizes_reqs(x, sizes, offset=0):
    out, at = [], offset
    for n in sizes:
        out.append(np.ascontiguousarray(x[at % (len(x) - n):][:n]))
        at += 7 * n + 1
    return out


@pytest.mark.parametrize("pool", [False, True])
def test_the_cpu_serving_path_answers_and_counts_as_before(mlp_cpu, pool):
    """On a CPU plan the outputs equal the plan's on the concatenated
    requests, ``h2d_pageable_bytes`` counts every request's bytes as
    before (0 on the stream pool, which copies on its workers), no chunk
    is counted direct, and the stage stays empty."""
    banks, x = mlp_cpu
    reqs = _sizes_reqs(x, (1, 3, 64, 70, 1, 130))
    kw = dict(devices=["cpu", "cpu"]) if pool else {}
    srv = MultiModelServer(backend="kernel", device="cpu", max_batch=64, **kw)
    try:
        plan = srv.add_model("m", banks)
        s0 = srv.stats()["serving"]
        outs = srv.serve([InferRequest("m", r) for r in reqs])
        s1 = srv.stats()["serving"]
    finally:
        srv.close()
    want = plan(np.concatenate(reqs)).numpy()
    np.testing.assert_array_equal(np.concatenate([o.output for o in outs]), want)
    assert s1["h2d_pageable_bytes"] - s0["h2d_pageable_bytes"] == (
        0 if pool else sum(r.nbytes for r in reqs))
    assert s1["h2d_staged_bytes"] == s0["h2d_staged_bytes"] == 0
    assert s1["batches_dispatched"] > s0["batches_dispatched"]
    assert s1["chunks_direct"] == s0["chunks_direct"] == 0
    assert srv._stage._slots == srv._back._slots == []
    peg = PegasusServer(banks, backend="kernel", device="cpu", max_batch=64)
    got = peg.serve([InferRequest("", r) for r in reqs])
    np.testing.assert_array_equal(np.concatenate([o.output for o in got]), want)
    assert peg._stage._slots == []


class _CallLog:
    """Every output ``ExecutionPlan.__call__`` returns, kept alive; a call
    of ``call_into`` fails the test."""

    def __init__(self, monkeypatch):
        self.outs: list = []
        call = ExecutionPlan.__call__

        def logged(plan, *a, **kw):
            y = call(plan, *a, **kw)
            self.outs.append(y)
            return y

        def refused(plan, *a, **kw):
            raise AssertionError("call_into is the direct path's")

        monkeypatch.setattr(ExecutionPlan, "__call__", logged)
        monkeypatch.setattr(ExecutionPlan, "call_into", refused)

    def fresh(self) -> bool:
        """Each output is a tensor of its own: no two share memory."""
        ptrs = [y.untyped_storage().data_ptr() for y in self.outs]
        return len(self.outs) > 1 and len(set(ptrs)) == len(ptrs)


OFF_PATH = ["infer", "pool", "sharded", "jit=False", "serve"]


def _off_path(where, banks, reqs, dev):
    """Serve ``reqs`` one way that keeps to ``plan(*inputs)``; returns the
    outputs in request order, and the server's direct chunks (None where
    it keeps no count)."""
    kw = dict(backend="kernel", max_batch=64)
    if where in ("sharded", "jit=False"):
        srv = PegasusServer(banks, device=dev, devices=(dev, dev) if where == "sharded" else None,
                            **kw)
        got = srv.serve([InferRequest("", r) for r in reqs], jit=where != "jit=False")
        return [o.output for o in got], None
    srv = MultiModelServer(device=dev, devices=[dev, dev] if where == "pool" else None, **kw)
    try:
        srv.add_model("m", banks)
        if where == "infer":
            outs = [srv.infer(InferRequest("m", r)).output.cpu().numpy() for r in reqs]
        else:
            outs = [o.output for o in srv.serve([InferRequest("m", r) for r in reqs])]
        return outs, srv.stats()["serving"]["chunks_direct"]
    finally:
        srv.close()


@pytest.mark.parametrize("where", OFF_PATH)
def test_off_the_direct_path_each_plan_call_returns_a_fresh_tensor(mlp_cpu, where, monkeypatch):
    """``infer()``, the stream pool, a sharded plan, ``jit=False`` and a
    CPU plan keep ``plan(*inputs)``: each call returns a tensor of its
    own, ``call_into`` is never called, and the answers are the plan's."""
    banks, x = mlp_cpu
    reqs = _sizes_reqs(x, (1, 3, 64, 70, 130))
    want = build_plan(banks, backend="kernel", device="cpu")(np.concatenate(reqs)).numpy()
    log = _CallLog(monkeypatch)
    outs, direct = _off_path(where, banks, reqs, "cpu")
    np.testing.assert_array_equal(np.concatenate(outs), want)
    assert log.fresh() and direct in (None, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

_MODELS: dict = {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return CUDA


def _model(family):
    """MLP-B (one input), the RNN or CNN-L (sequence and payload bytes),
    trained a few steps on the card and pegasusified at tiny depth, with
    host inputs; built once."""
    if family not in _MODELS:
        root = pathlib.Path(__file__).resolve().parents[1]
        spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        ds = make_dataset("peerrush", flows_per_class=100)
        if family == "mlp":
            stats = ds.train["stats"].astype(np.float32)
            m = train_mlp(stats, ds.train["label"], 3, steps=30, device=CUDA)
            model = pegasusify_mlp(m, stats, depth=4, refine_steps=0)
            inputs = (ds.test["stats"],)
        else:
            model, _, inputs, _ = smoke._pegasusified(family, ds, CUDA, steps=30, tiny=True)
        _MODELS[family] = (model, tuple(np.ascontiguousarray(a) for a in inputs))
    return _MODELS[family]


def _requests(inputs, sizes, shift=0):
    """Requests of ``sizes`` rows, tiled from the test inputs."""
    n = len(inputs[0])
    out, at = [], shift
    for b in sizes:
        idx = (np.arange(b) + at) % n
        out.append(tuple(np.ascontiguousarray(a[idx]) for a in inputs))
        at += b
    return out


SIZES = (1, 37, 4096, 1, 700, 2500, 64)


def _serve(srv, name, reqs, on_card=False):
    s0 = srv.stats()["serving"]
    if on_card:
        reqs = [tuple(torch.as_tensor(a, device=CUDA) for a in r) for r in reqs]
    outs = srv.serve([InferRequest(name, r) for r in reqs])
    s1 = srv.stats()["serving"]
    delta = {k: s1[k] - s0[k] for k in ("h2d_pageable_bytes", "h2d_staged_bytes")}
    return [o.output for o in outs], delta


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mlp", "cnn_l"])
def test_staged_outputs_equal_the_unstaged_path_on_the_card(card, family):
    """Host requests go through the stage; the same requests held on the
    card are concatenated there, as before the stage: bit-equal outputs,
    each also equal to the plan on its own rows. Only the staged bytes
    are counted, and none as pageable."""
    model, inputs = _model(family)
    reqs = _requests(inputs, SIZES)
    srv = MultiModelServer(backend="kernel", device=CUDA)
    plan = srv.add_model(family, model)
    _serve(srv, family, reqs)                            # capture every bucket used
    staged, delta = _serve(srv, family, reqs)
    assert delta == {"h2d_pageable_bytes": 0,
                     "h2d_staged_bytes": sum(a.nbytes for r in reqs for a in r)}
    unstaged, delta = _serve(srv, family, reqs, on_card=True)
    assert delta == {"h2d_pageable_bytes": 0, "h2d_staged_bytes": 0}
    for s, u, r in zip(staged, unstaged, reqs):
        np.testing.assert_array_equal(s, u)
        np.testing.assert_array_equal(
            s, plan(*(torch.as_tensor(a, device=CUDA) for a in r)).cpu().numpy())
    peg = PegasusServer(model, backend="kernel", device=CUDA)
    got = peg.serve([InferRequest("", r) for r in reqs])
    for s, o in zip(staged, got):
        np.testing.assert_array_equal(s, o.output)
    assert len(peg._stage._slots) == 1
    assert all(b.is_pinned() for b in peg._stage._slots[0].bufs)


@pytest.mark.cuda
def test_two_models_in_one_round_take_a_slot_each(card):
    """A round that holds both models begins both groups before finishing
    either: the second group takes the first one's slot only if its copies
    have completed, else a slot of its own, and both answer as when served
    alone."""
    models = {f: _model(f) for f in ("mlp", "cnn_l")}
    reqs = {f: _requests(inp, (300, 1, 1200), shift=5) for f, (_, inp) in models.items()}
    alone = {}
    for f, (m, _) in models.items():
        one = MultiModelServer(backend="kernel", device=CUDA)
        one.add_model(f, m)
        alone[f] = _serve(one, f, reqs[f])[0]
    srv = MultiModelServer(backend="kernel", device=CUDA)
    for f, (m, _) in models.items():
        srv.add_model(f, m)
    for f in models:                                    # first use, apart
        _serve(srv, f, reqs[f])
    taken = []
    take = srv._stage.take
    srv._stage.take = lambda device: taken.append(take(device)) or taken[-1]
    mixed = [InferRequest(f, r) for i in range(3) for f in models for r in reqs[f][i:i + 1]]
    outs = srv.serve(mixed)
    assert len(taken) == 2 and 1 <= len(srv._stage._slots) <= 2
    got = {f: [o.output for o in outs if o.model == f] for f in models}
    for f in models:
        for a, b in zip(got[f], alone[f]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_a_round_larger_than_the_buffer_grows_it(card):
    """A small round sizes the buffers; a round of many times the bytes
    grows them by doubling and is served as the unstaged path serves it;
    the async server stages as the sync one does."""
    model, inputs = _model("cnn_l")
    srv = MultiModelServer(backend="kernel", device=CUDA)
    srv.add_model("c", model)
    small = _requests(inputs, (3, 5))
    _serve(srv, "c", small)
    first = [b.numel() for b in srv._stage._slots[0].bufs]
    big = _requests(inputs, (4096, 4096, 3000, 1), shift=11)
    _serve(srv, "c", big)                               # capture its buckets
    staged, delta = _serve(srv, "c", big)
    grown = [b.numel() for b in srv._stage._slots[0].bufs]
    # a round holds up to a quantum of flows: at least one 4,096-flow request
    least = [max(r[i].nbytes for r in big) for i in range(2)]
    for f, g, n in zip(first, grown, least):
        assert g >= n and g % f == 0 and (g // f) & (g // f - 1) == 0
    need = [sum(r[i].nbytes for r in big) for i in range(2)]
    assert delta["h2d_staged_bytes"] == sum(need) and delta["h2d_pageable_bytes"] == 0
    unstaged, _ = _serve(srv, "c", big, on_card=True)
    for a, b in zip(staged, unstaged):
        np.testing.assert_array_equal(a, b)
    with AsyncMultiModelServer(backend="kernel", device=CUDA) as asrv:
        asrv.add_model("c", model)
        s0 = asrv.stats()["serving"]
        outs = [asrv.submit(InferRequest("c", r)).result(timeout=300).output for r in big]
        s1 = asrv.stats()["serving"]
    assert s1["h2d_staged_bytes"] - s0["h2d_staged_bytes"] == sum(need)
    assert s1["h2d_pageable_bytes"] == s0["h2d_pageable_bytes"]
    for a, b in zip(outs, unstaged):
        np.testing.assert_array_equal(a, b)


# the direct path: each group's requests, one group a round
DIRECT_CASES = {
    "three full chunks and a padded tail": [(4096, 1, 4095, 2000, 2096, 1000)],
    "one padded chunk": [(3, 997)],
    "two rounds begun two deep": [(4096, 3, 997), (500, 500)],
}
PADDED = 1000                       # each case's last chunk: 1,000 rows of a 1,024 bucket
HOLD_CYCLES = 400_000_000           # a few hundred ms of the stream held


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DIRECT_CASES))
@pytest.mark.parametrize("family", ["mlp", "rnn", "cnn_l"])
def test_each_chunk_crosses_the_plan_boundary_once_each_way(card, family, case):
    """Groups begun while the stream is held, so that every copy is still
    in flight when the host looks: the answers are the plan's on each
    request, bit for bit; the static inputs' padded rows read zero though
    a full chunk filled them before; an input slot whose copies are in
    flight is released but not handed out again; every chunk is counted
    direct; and a group whose last chunk raises leaves neither slot busy,
    its requests served on the retry."""
    model, inputs = _model(family)
    groups = [_requests(inputs, sizes, shift=17 * i) for i, sizes in enumerate(DIRECT_CASES[case])]
    srv = MultiModelServer(backend="kernel", device=CUDA, quantum=16384)
    plan = srv.add_model(family, model)
    for reqs in groups:                                 # capture every bucket used
        _serve(srv, family, reqs)
    assert bucket_batch(PADDED) == 1024
    _serve(srv, family, _requests(inputs, (1024,), shift=5))     # fill the padded rows
    static = [g for k, g in plan._graphs.items() if k[1] == 1024]
    assert len(static) == 1
    torch.cuda.synchronize()
    assert any(buf[PADDED:].any() for buf in static[0].inputs)
    taken = []
    take = srv._stage.take
    srv._stage.take = lambda device: taken.append(take(device)) or taken[-1]
    s0 = srv.stats()["serving"]
    torch.cuda._sleep(HOLD_CYCLES)
    begun = []
    for reqs in groups:
        for r in reqs:
            srv.submit(InferRequest(family, r))
        (name, pulled), = srv._sched.pull_round(16384)
        begun.append(srv._begin_group(name, pulled, None))
        assert begun[-1].error is None
    # released with their copies still queued behind the held stream
    assert len({id(s) for s in taken}) == len(taken) == len(groups)
    assert not any(s.busy or s.event.query() for s in taken)
    other = take(CUDA)
    assert all(other is not s for s in taken)
    srv._stage._hand_back(other)
    got = [srv._finish_group(g) for g in begun]
    torch.cuda.synchronize()            # before any plan call below replays the graph
    assert not any(buf[PADDED:].any() for buf in static[0].inputs)
    s1 = srv.stats()["serving"]
    chunks = sum(len(bucket_chunks(sum(sizes))) for sizes in DIRECT_CASES[case])
    assert s1["chunks_direct"] - s0["chunks_direct"] == chunks
    assert s1["batches_dispatched"] - s0["batches_dispatched"] == chunks
    for outs, reqs in zip(got, groups):
        for o, r in zip(outs, reqs):
            want = plan(*(torch.as_tensor(a, device=CUDA) for a in r)).cpu().numpy()
            np.testing.assert_array_equal(o, want)
    assert not any(s.busy for s in srv._stage._slots + srv._back._slots)

    # the last chunk of the first group raises before its plan call
    n_chunks, calls = len(bucket_chunks(sum(DIRECT_CASES[case][0]))), [0]
    call_into = plan.call_into

    def failing(*a, **kw):
        calls[0] += 1
        if calls[0] == n_chunks:
            raise RuntimeError("a failing chunk")
        return call_into(*a, **kw)

    plan.call_into = failing
    for r in groups[0]:
        srv.submit(InferRequest(family, r))
    (name, pulled), = srv._sched.pull_round(16384)
    g = srv._begin_group(name, pulled, None)
    assert isinstance(g.error, RuntimeError)
    assert not any(s.busy for s in srv._stage._slots + srv._back._slots)
    srv._finish_group(g)                                # back in the queue
    del plan.call_into
    outs = srv.drain()[family]
    for o, r in zip(outs, groups[0]):
        np.testing.assert_array_equal(
            o, plan(*(torch.as_tensor(a, device=CUDA) for a in r)).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("where", [w for w in OFF_PATH if w != "serve"])
def test_off_the_direct_path_on_the_card_each_plan_call_returns_a_fresh_tensor(
        card, where, monkeypatch):
    """On the card too, ``infer()``, the stream pool, a sharded plan and
    ``jit=False`` keep ``plan(*inputs)`` and its fresh tensor a call."""
    model, inputs = _model("mlp")
    reqs = [r[0] for r in _requests(inputs, (1, 3, 64, 70, 130))]
    want = build_plan(model, backend="kernel", device=CUDA)(
        torch.as_tensor(np.concatenate(reqs), device=CUDA)).cpu().numpy()
    log = _CallLog(monkeypatch)
    outs, direct = _off_path(where, model, reqs, CUDA)
    np.testing.assert_array_equal(np.concatenate(outs), want)
    assert log.fresh() and direct in (None, 0)
