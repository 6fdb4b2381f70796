"""CNN-B served through ``AsyncMultiModelServer``: on the CPU, equal to a
plain reference to the bit on seeded random banks at the published widths
(the window bank over 6 windows of 3 packets, the mean, the head pair fused
or not), with the server's ``bank_rows`` counter present and 0; on the card,
one replay's trace names the per-bank and the stacked f32 kernels apart, and
``bank_rows`` grows by the bucket times 6 a replay. Imports no JAX."""

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
from repro_torch.nets.cnn import PegasusCNN

WINDOW, KERNEL, POOL = 8, 3, 6
CHANNELS, HIDDEN, CLASSES = 16, 24, 3


def _bank(gen, k, v, n, depth, lo, hi, bias, relu=False):
    """K depth-``depth`` trees over v-wide groups (features drawn among the
    v, thresholds in [lo, hi)), a N(0, 1/K) table (clamped at 0 with
    ``relu``) and, with ``bias``, a N(0, 0.01) bias."""
    c = 2**depth
    lut = torch.randn((k, c, n), generator=gen) / k**0.5
    return PegasusLinear(
        trees=FuzzyTree(torch.randint(0, v, (k, c - 1), generator=gen, dtype=torch.int32),
                        lo + (hi - lo) * torch.rand((k, c - 1), generator=gen),
                        torch.zeros((k, c, v))),
        lut=lut.clamp(min=0.0) if relu else lut,
        bias=torch.randn((n,), generator=gen) * 0.1 if bias else None, group_size=v)


def _cnn_b(seed=0) -> PegasusCNN:
    """CNN-B's banks at their published geometry: the window bank (1, 6,
    4096, 16) on the raw bytes, no bias; h (16, 1, 256, 24) on the pooled
    rows and out (24, 1, 256, 3), each with a bias."""
    gen = torch.Generator().manual_seed(seed)
    return PegasusCNN(
        window_bank=_bank(gen, 1, 2 * KERNEL, CHANNELS, 12, 0.0, 255.0, False, relu=True),
        head_banks=[_bank(gen, CHANNELS, 1, HIDDEN, 8, 0.0, 1.0, True),
                    _bank(gen, HIDDEN, 1, CLASSES, 8, -1.5, 1.5, True)],
        out_bias=None, nam=False, pool_windows=POOL)


def _plain_bank(p: PegasusLinear, x: torch.Tensor) -> torch.Tensor:
    """Descend each tree from the root (right iff the value exceeds the
    node's threshold), then sum the leaves' table rows in ascending k and
    add the bias."""
    k, n_int = p.trees.thresholds.shape
    xg = x.reshape(x.shape[0], k, -1)
    node = torch.zeros((x.shape[0], k), dtype=torch.long)
    rows = torch.arange(k)
    while bool((node < n_int).any()):
        at = node.clamp(max=n_int - 1)
        val = torch.gather(xg, 2, p.trees.features.long()[rows, at].unsqueeze(-1)).squeeze(-1)
        node = torch.where(node < n_int,
                           2 * node + 1 + (val > p.trees.thresholds[rows, at]).long(), node)
    y = torch.zeros((x.shape[0], p.lut.shape[2]))
    for j in range(k):
        y = y + p.lut[j, node[:, j] - n_int]
    return y if p.bias is None else y + p.bias


def _reference(m: PegasusCNN, seq: np.ndarray) -> torch.Tensor:
    """Window p holds the (length, delay) bytes of packets p..p+2; the
    window bank's rows are averaged over the 6 windows, then h and out."""
    x = torch.as_tensor(seq).to(torch.float32)
    win = torch.stack([x[:, p:p + KERNEL].reshape(len(x), -1) for p in range(POOL)], dim=1)
    pooled = _plain_bank(m.window_bank, win.reshape(-1, 2 * KERNEL)).reshape(
        len(x), POOL, -1).mean(dim=1)
    return _plain_bank(m.head_banks[1], _plain_bank(m.head_banks[0], pooled))


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_served_on_the_cpu_equals_the_plain_reference_and_counts_no_bank_rows(seed, fuse):
    model = _cnn_b(seed)
    seq = np.random.default_rng(seed).integers(0, 256, (700, WINDOW, 2), dtype=np.uint8)
    sizes = [1, 7, 33, 64, 300, 295]
    srv = AsyncMultiModelServer(backend="kernel", device="cpu", fuse=fuse)
    plan = srv.add_model("cnn-b", model)
    assert plan.family == "cnn" and plan.fused_groups == int(fuse)
    with srv:
        offs = np.cumsum([0, *sizes])
        futs = [srv.submit(InferRequest("cnn-b", seq[a:b])) for a, b in zip(offs, offs[1:])]
        got = torch.cat([torch.as_tensor(np.asarray(f.result(timeout=60).output))
                         for f in futs])
    assert torch.equal(got, _reference(model, seq))
    st = srv.stats()["serving"]
    assert st["flows_served"] == len(seq)
    assert st["bank_rows"] == 0 and plan.bank_rows == 0
    srv.close()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_replay_names_both_f32_kernels_and_counts_the_window_rows(card):
    """At bucket 1024: the replay launches the per-bank kernel once (the
    window bank, 6 rows a flow) and the stacked kernel once (the head
    pair), which the profiler names ``fuzzy_lut_f32_bank_kernel`` and
    ``fuzzy_lut_f32_stack_kernel``; ``bank_rows`` grows by 1024 × 6 a
    replay, and the output equals the plan's gather path on the card."""
    from torch.profiler import ProfilerActivity, profile

    model = _cnn_b(3)
    plan = build_plan(model, backend="kernel", device=card, audit="off")
    seq = np.random.default_rng(3).integers(0, 256, (1000, WINDOW, 2), dtype=np.uint8)
    first = plan(torch.as_tensor(seq, device=card))    # the eager run, then the capture
    assert plan.bank_rows == 0
    (g,) = plan._graphs.values()
    assert g.launches == {"fuzzy_lut": 1, "fuzzy_lut_stack": 1}
    assert g.bank_rows == 1024 * plan.step_rows_per_flow(plan.banks[0]) == 1024 * POOL
    l0 = dict(_lib.LAUNCHES)
    again = plan(torch.as_tensor(seq, device=card))
    assert torch.equal(again, first)
    assert torch.equal(again, plan(torch.as_tensor(seq, device=card), backend="gather",
                                   jit=False))
    assert plan.bank_rows == 1024 * POOL
    assert {k: _lib.LAUNCHES[k] - l0[k] for k in ("fuzzy_lut", "fuzzy_lut_stack")} == {
        "fuzzy_lut": 1, "fuzzy_lut_stack": 1}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("fuzzy_lut_f32_bank_kernel" in n for n in names) == 1
    assert sum("fuzzy_lut_f32_stack_kernel" in n for n in names) == 1
    assert not any("fuzzy_lut_f32_kernel" in n for n in names)
