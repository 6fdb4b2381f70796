"""The port on the card: each CUDA kernel against its plain PyTorch version,
and a plan that must go through the kernels. Every test here is marked
``cuda`` and skips without an NVIDIA GPU; this file imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import numpy as np
import pytest
import torch

from repro_torch.kernels.fuzzy_lut import _lib, kernel as K, quantized as Q

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bank(rng, t, k, v, depth, n, dev):
    i = 2**depth - 1
    thr = rng.normal(size=(k, i)).astype(np.float32)
    thr[rng.random(size=thr.shape) < 0.1] = np.inf
    arrays = (rng.normal(size=(t, k, v)), rng.integers(0, v, size=(k, i)), thr,
              rng.normal(size=(k, i + 1, n)))
    dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
    return [torch.as_tensor(np.asarray(a), dtype=d, device=dev) for a, d in zip(arrays, dtypes)]


@pytest.mark.parametrize("shape", [(4096, 16, 2, 6, 32), (1000, 13, 4, 5, 70), (1, 3, 2, 1, 1)])
def test_bank_kernels_match_plain(dev, shape):
    x, f, th, lut = _bank(np.random.default_rng(sum(shape)), *shape, dev)
    y, lv = K.fuzzy_lut(x, f, th, lut, return_leaves=True)
    wy, wl = K.fuzzy_lut_plain(x, f, th, lut)
    assert torch.equal(lv.long(), wl)
    assert torch.equal(y, wy)
    q, s = Q.quantize_lut_int8(lut)
    y, lv = Q.fuzzy_lut_q8(x, f, th, q, s, return_leaves=True)
    wy, wl = Q.fuzzy_lut_q8_plain(x, f, th, q, s)
    assert torch.equal(lv.long(), wl)
    torch.testing.assert_close(y, wy, rtol=TOL, atol=TOL)


def test_stack_kernels_match_plain(dev):
    rng = np.random.default_rng(5)
    t, ks, v, depth, nmax, n_out = 777, (6, 4, 9), 3, 4, 27, 5
    nl, kmax, c = len(ks), max(ks), 2**depth
    feats = np.zeros((nl, kmax, c - 1), np.int32)
    thr = np.full((nl, kmax, c - 1), np.inf, np.float32)
    lut = np.zeros((nl, kmax, c, nmax), np.float32)
    bias = np.zeros((nl, nmax), np.float32)
    for l, k in enumerate(ks):
        n = n_out if l == nl - 1 else ks[l + 1] * v
        feats[l, :k] = rng.integers(0, v, size=(k, c - 1))
        thr[l, :k] = rng.normal(size=(k, c - 1))
        lut[l, :k, :, :n] = rng.normal(size=(k, c, n)) * 0.3
        bias[l, :n] = rng.normal(size=n) * 0.1
    x = rng.normal(size=(t, ks[0], v)).astype(np.float32)
    x, f, th, lt, b = (torch.as_tensor(a, device=dev) for a in (x, feats, thr, lut, bias))
    y, lv = K.fuzzy_lut_stack(x, f, th, lt, b, ks=ks, n_out=n_out, return_leaves=True)
    wy, wl = K.fuzzy_lut_stack_plain(x, f, th, lt, b, ks, n_out)
    assert torch.equal(lv.long(), wl)
    assert torch.equal(y, wy)
    q, s = Q.quantize_lut_int8(lt.reshape(nl * kmax, c, nmax))
    q, s = q.reshape(lt.shape).contiguous(), s.reshape(nl, kmax).contiguous()
    y = Q.fuzzy_lut_stack_q8(x, f, th, q, s, b, ks=ks, n_out=n_out)
    torch.testing.assert_close(y, Q.fuzzy_lut_stack_q8_plain(x, f, th, q, s, b, ks, n_out)[0],
                               rtol=TOL, atol=TOL)


def test_plan_goes_through_the_kernels(dev):
    """A fused and an unfused plan on the card: kernel output equals the
    gather backend, and only the expected kernel was launched."""
    from repro_torch.core.amm import init_pegasus_linear
    from repro_torch.engine import build_plan

    rng = np.random.default_rng(0)
    calib = (rng.normal(size=(400, 8)) * 3).astype(np.float32)
    banks, d = [], 8
    for n in (8, 8, 3):
        w = rng.normal(size=(d, n)).astype(np.float32)
        banks.append(init_pegasus_linear(w, rng.normal(size=n), calib, group_size=2,
                                         depth=4, lut_bits=None, device=dev))
        calib = calib @ w
        d = n
    x = (rng.normal(size=(300, 8)) * 3).astype(np.float32)
    for fuse, name in ((True, "fuzzy_lut_stack"), (False, "fuzzy_lut")):
        plan = build_plan(banks, fuse=fuse, device=dev)
        ref = plan(x, backend="gather")
        _lib.reset_launches()
        out = plan(x, backend="kernel")
        torch.cuda.synchronize()
        assert _lib.LAUNCHES[name] == (1 if fuse else 3)
        assert sum(_lib.LAUNCHES.values()) == _lib.LAUNCHES[name]
        assert torch.equal(out, ref)


def _stack(rng, t, ks, v, depth, nmax, n_out, dev):
    nl, kmax, c = len(ks), max(ks), 2**depth
    feats = np.zeros((nl, kmax, c - 1), np.int32)
    thr = np.full((nl, kmax, c - 1), np.inf, np.float32)
    lut = np.zeros((nl, kmax, c, nmax), np.float32)
    bias = np.zeros((nl, nmax), np.float32)
    for l, k in enumerate(ks):
        n = n_out if l == nl - 1 else ks[l + 1] * v
        feats[l, :k] = rng.integers(0, v, size=(k, c - 1))
        thr[l, :k] = rng.normal(size=(k, c - 1))
        lut[l, :k, :, :n] = rng.normal(size=(k, c, n)) * 0.3
        bias[l, :n] = rng.normal(size=n) * 0.1
    x = rng.normal(size=(t, ks[0], v)).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (x, feats, thr, lut, bias)]


def _offset_view(t):
    """``t``'s values in a tensor whose address is 1 element past a 16-byte
    boundary: no bulk copy can stage it, so the int8 kernel copies its trees
    and scales cooperatively and reads its LUT through L1."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


# t, k, v, depth, n: MLP-B's widest bank, ragged, T=1, a bank wider than a
# ring slot (column tiles), and one whose LUT and trees exceed a slot (read
# through L1)
Q8_BANKS = [(4096, 16, 2, 6, 32), (1000, 13, 4, 5, 70), (1, 3, 2, 1, 1),
            (300, 16, 2, 6, 2048), (200, 256, 2, 6, 40)]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("shape", Q8_BANKS)
def test_q8_bank_kernel_bit_equal(dev, shape, offset):
    x, f, th, lut = _bank(np.random.default_rng(sum(shape)), *shape, dev)
    q, s = Q.quantize_lut_int8(lut)
    if offset:
        f, th, q, s = (_offset_view(a) for a in (f, th, q, s))
    before = _lib.LAUNCHES["fuzzy_lut_q8"]
    y, lv = Q.fuzzy_lut_q8(x, f, th, q, s, return_leaves=True)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["fuzzy_lut_q8"] == before + 1
    wy, wl = Q.fuzzy_lut_q8_plain(x, f, th, q, s)
    assert torch.equal(lv.long(), wl)
    assert torch.equal(y, wy)


# MLP-B, ragged, and a stack whose layers exceed a ring slot
Q8_STACKS = [dict(t=4096, ks=(8, 16, 16, 16), v=2, depth=6, nmax=32, n_out=3),
             dict(t=1000, ks=(13, 9, 5), v=4, depth=5, nmax=70, n_out=70),
             dict(t=1, ks=(3, 1), v=1, depth=1, nmax=3, n_out=1),
             dict(t=300, ks=(16, 16), v=2, depth=6, nmax=1024, n_out=1024)]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("geom", Q8_STACKS, ids=["mlp-b", "ragged", "t1", "wide"])
def test_q8_stack_kernel_bit_equal(dev, geom, offset):
    ks, n_out = geom["ks"], geom["n_out"]
    x, f, th, lt, b = _stack(np.random.default_rng(9), dev=dev, **geom)
    nl, kmax, c, nmax = lt.shape
    q, s = Q.quantize_lut_int8(lt.reshape(nl * kmax, c, nmax))
    q, s = q.reshape(lt.shape).contiguous(), s.reshape(nl, kmax).contiguous()
    if offset:
        f, th, q, s, b = (_offset_view(a) for a in (f, th, q, s, b))
    y, lv = Q.fuzzy_lut_stack_q8(x, f, th, q, s, b, ks=ks, n_out=n_out,
                                 return_leaves=True)
    wy, wl = Q.fuzzy_lut_stack_q8_plain(x, f, th, q, s, b, ks, n_out)
    assert torch.equal(lv.long(), wl)
    assert torch.equal(y, wy)


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("shape", Q8_BANKS)
def test_f32_bank_kernel_bit_equal(dev, shape, offset):
    """The f32 bank at the shapes the int8 one faces: row in registers
    (K*v <= 32) or read from global memory, leaves by shuffle or in shared
    memory (K=256), trees node-major in shared memory."""
    x, f, th, lut = _bank(np.random.default_rng(sum(shape)), *shape, dev)
    if offset:
        f, th, lut = (_offset_view(a) for a in (f, th, lut))
    before = _lib.LAUNCHES["fuzzy_lut"]
    y, lv = K.fuzzy_lut(x, f, th, lut, return_leaves=True)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["fuzzy_lut"] == before + 1
    wy, wl = K.fuzzy_lut_plain(x, f, th, lut)
    assert torch.equal(lv.long(), wl)
    assert torch.equal(y, wy)


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("geom", Q8_STACKS, ids=["mlp-b", "ragged", "t1", "wide"])
def test_f32_stack_kernel_bit_equal(dev, geom, offset):
    ks, n_out = geom["ks"], geom["n_out"]
    x, f, th, lt, b = _stack(np.random.default_rng(9), dev=dev, **geom)
    if offset:
        f, th, lt, b = (_offset_view(a) for a in (f, th, lt, b))
    y, lv = K.fuzzy_lut_stack(x, f, th, lt, b, ks=ks, n_out=n_out, return_leaves=True)
    wy, wl = K.fuzzy_lut_stack_plain(x, f, th, lt, b, ks, n_out)
    assert torch.equal(lv.long(), wl)
    assert torch.equal(y, wy)


def test_f32_stack_kernel_reads_trees_through_l1(dev):
    """A stack whose trees do not fit beside its rows (depth 8, 200 groups
    of width 1): the descent reads the [K, I] layout through L1."""
    geom = dict(t=333, ks=(200, 120), v=1, depth=8, nmax=200, n_out=77)
    assert K.plan_f32(geom["ks"], 1, 8, 200).kpad == 0
    x, f, th, lt, b = _stack(np.random.default_rng(3), dev=dev, **geom)
    y, lv = K.fuzzy_lut_stack(x, f, th, lt, b, ks=geom["ks"], n_out=77, return_leaves=True)
    wy, wl = K.fuzzy_lut_stack_plain(x, f, th, lt, b, geom["ks"], 77)
    assert torch.equal(lv.long(), wl)
    assert torch.equal(y, wy)


# t, k, v, depth, n of every lone bank the other families launch, at the
# rows one bucket-4096 batch gives it: the RNN's x, h and out banks; the
# CNN-B and CNN-M window banks (depth 12, v=6, 6 windows per flow); the
# CNN-L encoder banks (K = 62 and 64, wider than a warp; 8 packets per flow)
FAMILY_BANKS = {"rnn-x": (4096, 2, 1, 8, 24), "rnn-h": (4096, 24, 1, 8, 24),
                "rnn-out": (4096, 24, 1, 8, 3), "cnn-b-window": (24576, 1, 6, 12, 16),
                "cnn-m-window": (24576, 1, 6, 12, 3), "cnn-l-b1": (32768, 62, 1, 8, 64),
                "cnn-l-b2": (32768, 64, 1, 8, 16)}
# the CNN-B head pair and the AE's four-layer stack (trees through L1)
FAMILY_STACKS = {"cnn-b-heads": dict(t=4096, ks=(16, 24), v=1, depth=8, nmax=24, n_out=3),
                 "ae": dict(t=4096, ks=(24, 12, 3, 12), v=1, depth=8, nmax=24, n_out=24)}


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("name", sorted(FAMILY_BANKS))
def test_family_bank_kernels_bit_equal(dev, name, offset):
    """Both per-bank kernels at a family's geometry: leaves exact, outputs
    bit-equal to the plain versions."""
    x, f, th, lut = _bank(np.random.default_rng(len(name)), *FAMILY_BANKS[name], dev)
    q, s = Q.quantize_lut_int8(lut)
    if offset:
        f, th, lut, q, s = (_offset_view(a) for a in (f, th, lut, q, s))
    for run, plain in ((lambda: K.fuzzy_lut(x, f, th, lut, return_leaves=True),
                        lambda: K.fuzzy_lut_plain(x, f, th, lut)),
                       (lambda: Q.fuzzy_lut_q8(x, f, th, q, s, return_leaves=True),
                        lambda: Q.fuzzy_lut_q8_plain(x, f, th, q, s))):
        y, lv = run()
        torch.cuda.synchronize()
        wy, wl = plain()
        assert torch.equal(lv.long(), wl), name
        assert torch.equal(y, wy), name


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("name", sorted(FAMILY_STACKS))
def test_family_stack_kernels_bit_equal(dev, name, offset):
    geom = FAMILY_STACKS[name]
    ks, n_out = geom["ks"], geom["n_out"]
    x, f, th, lt, b = _stack(np.random.default_rng(len(name)), dev=dev, **geom)
    nl, kmax, c, nmax = lt.shape
    q, s = Q.quantize_lut_int8(lt.reshape(nl * kmax, c, nmax))
    q, s = q.reshape(lt.shape).contiguous(), s.reshape(nl, kmax).contiguous()
    if offset:
        f, th, lt, b, q, s = (_offset_view(a) for a in (f, th, lt, b, q, s))
    y, lv = K.fuzzy_lut_stack(x, f, th, lt, b, ks=ks, n_out=n_out, return_leaves=True)
    wy, wl = K.fuzzy_lut_stack_plain(x, f, th, lt, b, ks, n_out)
    assert torch.equal(lv.long(), wl) and torch.equal(y, wy), name
    y, lv = Q.fuzzy_lut_stack_q8(x, f, th, q, s, b, ks=ks, n_out=n_out, return_leaves=True)
    wy, wl = Q.fuzzy_lut_stack_q8_plain(x, f, th, q, s, b, ks, n_out)
    assert torch.equal(lv.long(), wl) and torch.equal(y, wy), name


@pytest.mark.parametrize("family", ["rnn", "cnn_l"])
def test_family_served_kernel_equals_gather(dev, family):
    """An RNN and a CNN-L, trained a few steps on the card and pegasusified
    at their published widths, served through PegasusServer: ``kernel``
    equals ``gather`` bit for bit and each backend launched only its own
    per-bank kernel, as often as the family's batches need."""
    from repro_torch.data.synthetic_traffic import make_dataset
    from repro_torch.launch.serve import InferRequest, PegasusServer
    from repro_torch.nets import cnn, rnn

    ds = make_dataset("peerrush", flows_per_class=100)
    tr, te = ds.train, ds.test
    if family == "rnn":
        m = rnn.train_rnn(tr["seq"], tr["label"], 3, steps=30, device=dev)
        model, inputs, per_batch = rnn.pegasusify_rnn(m, tr["seq"], depth=8), (te["seq"],), 16
    else:
        m = cnn.train_cnn_l(tr["seq"], tr["bytes"], tr["label"], 3, steps=30, device=dev)
        model = cnn.pegasusify_cnn_l(m, tr["seq"], tr["bytes"], enc_depth=8, index_bits=8)
        inputs, per_batch = (te["seq"], te["bytes"]), 2
    reqs = [InferRequest(family, tuple(a[i : i + 7] for a in inputs) if len(inputs) > 1
                         else inputs[0][i : i + 7]) for i in range(0, len(inputs[0]), 7)]
    outs = {}
    for be, name in (("gather", None), ("kernel", "fuzzy_lut"), ("kernel_q8", "fuzzy_lut_q8")):
        server = PegasusServer(model, backend=be, device=dev)
        _lib.reset_launches()
        outs[be] = np.concatenate([r.output for r in server.serve(reqs)])
        torch.cuda.synchronize()
        want = {} if name is None else {name: per_batch * server.batches_run}
        assert {k: n for k, n in _lib.LAUNCHES.items() if n} == want, be
        assert np.isfinite(outs[be]).all() and outs[be].shape == (len(inputs[0]), 3)
    assert np.array_equal(outs["kernel"], outs["gather"])


# ---------------------------------------------------------------------------
# Whole-plan CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_FAMILIES = ["mlp", "rnn", "cnn_b", "cnn_m", "cnn_l", "ae"]
_GRAPH_MODELS: dict = {}


def _graph_model(family, dev):
    """A family trained a few steps on the card and pegasusified at tiny
    depth (``chip_smoke._pegasusified``), with its test inputs; built once."""
    if family not in _GRAPH_MODELS:
        import importlib.util
        import pathlib

        from repro_torch.data.synthetic_traffic import make_dataset
        from repro_torch.nets.mlp import pegasusify_mlp, train_mlp

        root = pathlib.Path(__file__).resolve().parents[1]
        spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        ds = make_dataset("peerrush", flows_per_class=100)
        if family == "mlp":
            stats = ds.train["stats"].astype(np.float32)
            m = train_mlp(stats, ds.train["label"], 3, steps=30, device=dev)
            model = pegasusify_mlp(m, stats, depth=4, refine_steps=0)
            inputs = (ds.test["stats"].astype(np.float32),)
        else:
            model, _, inputs, _ = smoke._pegasusified(family, ds, dev, steps=30, tiny=True)
        _GRAPH_MODELS[family] = (model, inputs)
    return _GRAPH_MODELS[family]


def _rows(inputs, b, shift=0):
    """``b`` rows of the inputs, tiled, starting ``shift`` rows in."""
    n = len(inputs[0])
    idx = (np.arange(b) + shift) % n
    return tuple(np.ascontiguousarray(a[idx]) for a in inputs)


@pytest.mark.parametrize("backend", ["kernel", "kernel_q8"])
@pytest.mark.parametrize("family", GRAPH_FAMILIES)
def test_graph_replay_equals_eager(dev, family, backend):
    """At buckets 8, 1024 and 4096: the first call (eager warm-up, then the
    capture) and the replays equal ``jit=False`` bit for bit; a replay
    launches what the eager forward launches; a warm bucket adds no trace;
    each call returns a fresh tensor that a later replay leaves alone."""
    from repro_torch.engine import build_plan

    model, inputs = _graph_model(family, dev)
    plan = build_plan(model, device=dev)
    for b in (8, 1024, 4096):
        x1, x2 = _rows(inputs, b), _rows(inputs, b, shift=5)
        _lib.reset_launches()
        want1 = plan(*x1, backend=backend, jit=False)
        torch.cuda.synchronize()
        eager = dict(_lib.LAUNCHES)
        want2 = plan(*x2, backend=backend, jit=False)
        first = plan(*x1, backend=backend)
        traces = plan.trace_count
        _lib.reset_launches()
        y1 = plan(*x1, backend=backend)
        torch.cuda.synchronize()
        assert dict(_lib.LAUNCHES) == eager and sum(eager.values()) > 0, (b, eager)
        y2 = plan(*x2, backend=backend)
        torch.cuda.synchronize()
        assert plan.trace_count == traces, b
        assert torch.equal(first, want1) and torch.equal(y1, want1), b
        assert torch.equal(y2, want2), b
    assert {bk for _, bk in plan.compiled_buckets} == {8, 1024, 4096}


def test_graph_replay_on_two_streams(dev):
    """Two threads replaying one plan, each on its own stream (a graph
    each), give what one thread gives."""
    import threading

    from repro_torch.engine import build_plan

    model, inputs = _graph_model("rnn", dev)
    plan = build_plan(model, device=dev)
    xs = [_rows(inputs, 1024, shift=s) for s in range(6)]
    want = [plan(*x, backend="kernel").cpu() for x in xs]
    got: dict = {}

    def work(tag):
        with torch.cuda.stream(torch.cuda.Stream(device=dev)):
            for rep in range(4):
                for i, x in enumerate(xs):
                    got[(tag, rep, i)] = plan(*x, backend="kernel").cpu()

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 2 * 4 * len(xs)
    for (_, _, i), y in got.items():
        assert torch.equal(y, want[i]), i


@pytest.mark.parametrize("family", ["mlp", "rnn", "cnn_b"])
def test_graph_replays_of_one_pool_do_not_interleave(dev, family):
    """Two threads on the default stream and one on a stream of its own
    call one plan at buckets 8, 1024 and 4096 in different orders, from
    cold (so captures run while other graphs replay). The graphs of one
    stream share a memory pool, where a later graph's output may lie in an
    earlier graph's intermediates: every output must still equal
    ``jit=False``."""
    import threading

    from repro_torch.engine import build_plan

    model, inputs = _graph_model(family, dev)
    plan = build_plan(model, device=dev)
    xs = {b: [_rows(inputs, b, shift=s) for s in range(3)] for b in (8, 1024, 4096)}
    want = {(b, i): plan(*x, backend="kernel", jit=False).cpu()
            for b, bx in xs.items() for i, x in enumerate(bx)}
    got: dict = {}
    orders = {0: (8, 1024, 4096), 1: (4096, 1024, 8), 2: (1024, 8, 4096)}

    def work(tag):
        stream = (torch.cuda.Stream(device=dev) if tag == 2
                  else torch.cuda.default_stream(dev))
        with torch.cuda.stream(stream):
            for rep in range(6):
                for b in orders[tag]:
                    for i, x in enumerate(xs[b]):
                        got[(tag, rep, b, i)] = plan(*x, backend="kernel").cpu()

    threads = [threading.Thread(target=work, args=(t,)) for t in orders]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == len(orders) * 6 * 3 * 3
    for (tag, rep, b, i), y in got.items():
        assert torch.equal(y, want[(b, i)]), (tag, rep, b, i)
    assert {bk for _, bk in plan.compiled_buckets} == {8, 1024, 4096}


# ---------------------------------------------------------------------------
# Backprop refinement on the card
# ---------------------------------------------------------------------------


def _drift_layer(device):
    """A depth-4 bank whose trees were fit on drifted data (the drift
    scenario of tests/test_core.py) and the true data's linear teacher."""
    from repro_torch.core.amm import init_pegasus_linear

    rng = np.random.default_rng(17)
    w = (rng.normal(size=(16, 8)) / 4.0).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    stale = (rng.normal(size=(1024, 16)) * 2.0 + 1.5).astype(np.float32)
    true = rng.normal(size=(1024, 16)).astype(np.float32)
    layer = init_pegasus_linear(w, b, stale, group_size=4, depth=4, lut_bits=None,
                                device=device)
    return layer, true, true @ w + b


def test_refine_on_card_matches_cpu(dev, monkeypatch):
    """``refine`` on the card against ``refine`` on the CPU, both on the CPU
    generator's minibatches: thresholds, LUT and bias within 1e-4 after 20
    steps, and the card's hard error below the unrefined one."""
    from repro_torch.core import finetune

    draw = finetune._batch_indices
    monkeypatch.setattr(finetune, "_batch_indices",
                        lambda n, size, steps, seed, device: draw(
                            n, size, steps, seed, torch.device("cpu")).to(device))
    cpu_layer, x, y = _drift_layer("cpu")
    card_layer = cpu_layer.to(dev)
    want = finetune.refine(cpu_layer, x, y, steps=20)
    got = finetune.refine(card_layer, x, y, steps=20)
    assert got.lut.device.type == "cuda" and got.bias.device.type == "cuda"
    pairs = {"thresholds": (got.trees.thresholds, want.trees.thresholds),
             "lut": (got.lut, want.lut), "bias": (got.bias, want.bias)}
    print("refine card vs CPU, max |diff| after 20 steps: " + ", ".join(
        f"{name} {float((a.cpu() - b).nan_to_num().abs().max()):.3g}"
        for name, (a, b) in pairs.items()))
    for a, b in pairs.values():
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    assert finetune.hard_mse(got, x, y) < finetune.hard_mse(card_layer, x, y)


def test_refined_mlp_kernel_equals_gather(dev):
    """MLP-B trained a few steps on the card and pegasusified with its
    default refinement at the published geometry (v=2, depth 6): fused and
    unfused ``kernel`` bit-equal to ``gather``, through the expected kernel."""
    from repro_torch.data.synthetic_traffic import make_dataset
    from repro_torch.engine import build_plan
    from repro_torch.nets import mlp

    ds = make_dataset("peerrush", flows_per_class=200)
    m = mlp.train_mlp(ds.train["stats"], ds.train["label"], 3, steps=50, device=dev)
    banks = mlp.pegasusify_mlp(m, ds.train["stats"].astype(np.float32))
    assert [b.lut.device.type for b in banks] == ["cuda"] * 4
    x = ds.test["stats"].astype(np.float32)
    for fuse, name, n in ((True, "fuzzy_lut_stack", 1), (False, "fuzzy_lut", 4)):
        plan = build_plan(banks, fuse=fuse, device=dev)
        ref = plan(x, backend="gather", jit=False)
        _lib.reset_launches()
        out = plan(x, backend="kernel", jit=False)
        torch.cuda.synchronize()
        assert {k: c for k, c in _lib.LAUNCHES.items() if c} == {name: n}
        assert torch.equal(out, ref)


def test_pegasus_linear_apply_kernel_launches(dev):
    """``pegasus_linear_apply(path="kernel")`` on a card tensor launches the
    f32 bank kernel (``kernel_q8`` the int8 one) and equals ``gather``."""
    from repro_torch.core.amm import pegasus_linear_apply

    layer, x, _ = _drift_layer(dev)
    xt = torch.as_tensor(x[:300], device=dev)
    ref = pegasus_linear_apply(layer, xt, path="gather")
    for path, name in (("kernel", "fuzzy_lut"), ("kernel_q8", "fuzzy_lut_q8")):
        _lib.reset_launches()
        out = pegasus_linear_apply(layer, xt, path=path)
        torch.cuda.synchronize()
        assert {k: c for k, c in _lib.LAUNCHES.items() if c} == {name: 1}, path
        if path == "kernel":
            assert torch.equal(out, ref)


def test_lm_width_bank_kernels_match_plain(dev):
    """A Pegasus FFN bank wider than any family's: K = 1040 groups of v=4
    (trees read through L1) and N = 1100 columns (35 warp chunks), a bf16
    LUT as the LM banks hold. Each kernel bit-equal to its plain version,
    leaves exact; the FFN-level path equals gather over the LUT upcast to
    f32."""
    import dataclasses

    from repro_torch.core.amm import PegasusLinear, pegasus_linear_apply
    from repro_torch.core.fuzzy_tree import FuzzyTree
    from repro_torch.kernels.fuzzy_lut import ops

    rng = np.random.default_rng(11)
    t, k, v, depth, n = 40, 1040, 4, 4, 1100
    x, f, th, lut = _bank(rng, t, k, v, depth, n, dev)
    trees = FuzzyTree(features=f, thresholds=th,
                      centroids=torch.zeros((k, 2**depth, v), device=dev))
    bank = PegasusLinear(trees=trees, lut=lut.to(torch.bfloat16), bias=None, group_size=v)
    xg = x.contiguous()
    for quant, kern, plain in ((False, K.fuzzy_lut, K.fuzzy_lut_plain),
                               (True, Q.fuzzy_lut_q8, Q.fuzzy_lut_q8_plain)):
        feats, thr, table, scales = ops.padded_layout(bank, quant=quant)
        args = (xg, feats, thr, table) + ((scales,) if quant else ())
        y, lv = kern(*args, return_leaves=True)
        wy, wl = plain(*args)
        assert torch.equal(lv.long(), wl)
        assert torch.equal(y, wy)
    f32 = dataclasses.replace(bank, lut=bank.lut.float())
    _lib.reset_launches()
    out = pegasus_linear_apply(bank, x.reshape(t, k * v), path="kernel")
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["fuzzy_lut"] == 1
    assert torch.equal(out, pegasus_linear_apply(f32, x.reshape(t, k * v), path="gather"))


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "hymba_1_5b", "xlstm_1_3b", "phi3_5_moe"])
def test_smoke_lm_decodes_on_cuda_like_cpu(dev, arch):
    """The smoke LM on the card against the port's own CPU run on the same
    weights: forward_train and 4 decode steps within 1e-4 (f32 sums in
    another order), and Server.generate's tokens equal."""
    import copy

    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.serve import Server
    from repro_torch.models.transformer import decode_step, forward_train, init_decode_state
    from repro_torch.models.transformer import init_model

    cfg = smoke_config(arch)
    cpu = torch.device("cpu")
    params = {"cpu": init_model(cfg, 0, dtype=torch.float32, device=cpu)}
    params["cuda"] = copy.deepcopy(params["cpu"]).to(dev)
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    outs = {}
    for name, d in (("cpu", cpu), ("cuda", dev)):
        toks = torch.as_tensor(tokens, device=d)
        with torch.no_grad():
            logits, _ = forward_train(cfg, params[name], {"tokens": toks})
            state = init_decode_state(cfg, 2, 16, dtype=torch.float32, device=d)
            steps = [decode_step(cfg, params[name], state, toks[:, t : t + 1], t)[0]
                     for t in range(4)]
        gen = Server(cfg, device=d, kv_len=16, batch_size=2,
                     params=params[name]).generate(tokens[:, :1], max_new=6)
        outs[name] = (logits.cpu(), torch.stack(steps).cpu(), gen)
    for got, want in zip(outs["cuda"][:2], outs["cpu"][:2]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(outs["cuda"][2], outs["cpu"][2])


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "phi3_5_moe", "hymba_1_5b"])
def test_smoke_lm_trains_on_cuda_like_cpu(dev, arch):
    """Two train steps of the smoke LM at a constant learning rate of 3e-4
    on the card against the port's own CPU run from the same weights and
    batches: loss and grad_norm within 1e-4 relative, m and v by relative
    L2 (1e-4, 2e-4), and per parameter the change the two steps made by
    relative L2 within 1e-2 (f32 sums in another order; Adam's first
    update g/(|g| + eps) passes on the relative error of each gradient
    element near eps, 1.4e-3 on Granite's wk at any learning rate)."""
    import copy

    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.train import make_train_step, synthetic_batches
    from repro_torch.models.transformer import init_model
    from repro_torch.train.optimizer import adamw_init

    cfg = smoke_config(arch)
    cpu = torch.device("cpu")
    base = init_model(cfg, 0, dtype=torch.float32, device=cpu)
    before = {k: p.detach().clone() for k, p in base.named_parameters()}
    runs = {}
    for name, d in (("cpu", cpu), ("cuda", dev)):
        params = copy.deepcopy(base).to(d)
        opt = adamw_init(dict(params.named_parameters()))
        step = make_train_step(cfg, lr_fn=lambda _step: 3e-4)
        batches = synthetic_batches(cfg, 2, 16, seed=1)
        metrics = []
        for _ in range(2):
            params, opt, m = step(params, opt, {k: v.to(d) for k, v in next(batches).items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[name] = (metrics, {k: p.detach().cpu() for k, p in params.named_parameters()},
                      {k: t.cpu() for k, t in opt.m.items()}, {k: t.cpu() for k, t in opt.v.items()})
    (mc, pc, m_c, v_c), (mg, pg, m_g, v_g) = runs["cpu"], runs["cuda"]
    for got, want in zip(mg, mc):
        assert got == pytest.approx(want, rel=1e-4)
    moved_c = {k: pc[k] - before[k] for k in pc}
    moved_g = {k: pg[k] - before[k] for k in pc}
    for got, want, tol in ((m_g, m_c, 1e-4), (v_g, v_c, 2e-4), (moved_g, moved_c, 1e-2)):
        for k in want:
            norm = torch.linalg.vector_norm(want[k].double())
            err = torch.linalg.vector_norm((got[k] - want[k]).double())
            assert norm > 0 and err <= tol * norm, k
