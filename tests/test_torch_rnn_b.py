"""RNN-B's unrolled window served through ``AsyncMultiModelServer``: on the
CPU, equal to a plain reference to the bit on seeded random banks, with the
server's ``graph_kernels`` counter present and 0; on the card, the kernel
nodes counted in one captured graph equal the kernels ``torch.profiler``
sees its replay launch. Imports no JAX."""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import numpy as np
import pytest
import torch

from repro_torch.core.amm import PegasusLinear
from repro_torch.core.fuzzy_tree import FuzzyTree
from repro_torch.engine import build_plan
from repro_torch.kernels.fuzzy_lut import _lib
from repro_torch.launch.request import InferRequest
from repro_torch.launch.serve import AsyncMultiModelServer
from repro_torch.nets.rnn import HIDDEN, PegasusRNN

WINDOW = 8


def _bank(gen, k, n, depth, lo, hi, bias):
    """K depth-``depth`` trees over v = 1 with thresholds in [lo, hi), a
    N(0, 1/K) table and, with ``bias``, a N(0, 0.01) bias."""
    c = 2**depth
    thr = lo + (hi - lo) * torch.rand((k, c - 1), generator=gen)
    return PegasusLinear(
        trees=FuzzyTree(torch.zeros((k, c - 1), dtype=torch.int32), thr,
                        torch.zeros((k, c, 1))),
        lut=torch.randn((k, c, n), generator=gen) / k**0.5,
        bias=torch.randn((n,), generator=gen) * 0.1 if bias else None, group_size=1)


def _rnn(seed=0, depth=4, classes=3) -> PegasusRNN:
    """RNN-B's banks at ``depth``: x-banks on the raw bytes (bias on the
    first only), h-banks on the pre-activation, an out-bank."""
    gen = torch.Generator().manual_seed(seed)
    return PegasusRNN(
        x_banks=[_bank(gen, 2, HIDDEN, depth, 0.0, 255.0, t == 0) for t in range(WINDOW)],
        h_banks=[_bank(gen, HIDDEN, HIDDEN, depth, -1.5, 1.5, True) for _ in range(WINDOW - 1)],
        out_bank=_bank(gen, HIDDEN, classes, depth, -1.5, 1.5, True), window=WINDOW)


def _leaves(p: PegasusLinear, x: torch.Tensor) -> torch.Tensor:
    """Descend each tree from the root (right iff the value exceeds the
    node's threshold): the leaf ``[rows, K]`` each row reaches."""
    k, n_int = p.trees.thresholds.shape
    node = torch.zeros((x.shape[0], k), dtype=torch.long, device=x.device)
    rows = torch.arange(k, device=x.device)
    while True:
        inner = node < n_int
        if not inner.any():
            break
        at = node.clamp(max=n_int - 1)
        val = torch.gather(x.reshape(-1, k, 1), 2,
                           p.trees.features.long()[rows, at].unsqueeze(-1)).squeeze(-1)
        node = torch.where(inner, 2 * node + 1 + (val > p.trees.thresholds[rows, at]).long(),
                           node)
    return node - n_int


def _plain_bank(p: PegasusLinear, x: torch.Tensor) -> torch.Tensor:
    """The leaves' table rows summed in ascending k, then the bias."""
    k = p.lut.shape[0]
    leaf = _leaves(p, x)
    y = torch.zeros((x.shape[0], p.lut.shape[2]), device=x.device)
    for j in range(k):
        y = y + p.lut[j, leaf[:, j]]
    return y if p.bias is None else y + p.bias


def _reference(m: PegasusRNN, seq: np.ndarray) -> torch.Tensor:
    """h_0 = X_0(x_0), h_t = X_t(x_t) + H_t(h_{t-1}), logits = O(h_7)."""
    x = torch.as_tensor(seq).to(torch.float32)
    h = _plain_bank(m.x_banks[0], x[:, 0])
    for t in range(1, WINDOW):
        h = _plain_bank(m.x_banks[t], x[:, t]) + _plain_bank(m.h_banks[t - 1], h)
    return _plain_bank(m.out_bank, h)


def test_served_on_the_cpu_equals_the_plain_reference_and_counts_no_graph_kernels():
    model = _rnn()
    seq = np.random.default_rng(0).integers(0, 256, (700, WINDOW, 2), dtype=np.uint8)
    sizes = [1, 7, 33, 64, 300, 295]
    srv = AsyncMultiModelServer(backend="kernel", device="cpu")
    srv.add_model("rnn-b", model)
    with srv:
        offs = np.cumsum([0, *sizes])
        futs = [srv.submit(InferRequest("rnn-b", seq[a:b])) for a, b in zip(offs, offs[1:])]
        got = torch.cat([torch.as_tensor(np.asarray(f.result(timeout=60).output))
                         for f in futs])
    assert torch.equal(got, _reference(model, seq))
    st = srv.stats()["serving"]
    assert st["flows_served"] == len(seq)
    assert st["graph_kernels"] == 0
    srv.close()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_replay_launches_the_kernel_nodes_its_capture_counted(card):
    """At bucket 2048, RNN-B at its published depth: the graph's kernel
    nodes equal the kernel events of one replay under ``torch.profiler``
    (copies and memsets apart), the plan counts them once a replay, and
    the replay launches the port's kernel 16 times."""
    from torch.profiler import ProfilerActivity, profile

    plan = build_plan(_rnn(depth=8), backend="kernel", device=card, audit="off")
    seq = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (2048, WINDOW, 2),
                                                            dtype=np.uint8), device=card)
    first = plan(seq)                                  # the eager run, then the capture
    assert plan.graph_kernels == 0
    (g,) = plan._graphs.values()
    assert sum(g.launches.values()) == 16
    k0, l0 = plan.graph_kernels, sum(_lib.LAUNCHES.values())
    assert torch.equal(plan(seq), first)
    assert plan.graph_kernels - k0 == g.kernels
    assert sum(_lib.LAUNCHES.values()) - l0 == 16
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [n for n in names if not n.lower().startswith(("memcpy", "memset"))]
    assert sum("fuzzy_lut" in n for n in kernels) == 16
    assert g.kernels == len(kernels) > 16
