"""The port's plan memo (``repro_torch.engine.registry``), on the CPU: the
memo cases of the reference's tests/test_engine.py — memoization, rebuilds
after in-place, wrapper and aux mutation, eviction of dropped models, the
LRU bound, explicit discard and de-duplicated concurrent first calls — plus
the build options the port adds to the key (the device).
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import dataclasses
import gc
import sys
import threading
import types
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core.amm import init_pegasus_linear
from repro_torch.engine import STATS, PlanRegistry, build_plan, plan_for

CPU = "cpu"


def _fresh_banks(seed: int, n_out: int = 5) -> list:
    rng = np.random.default_rng(seed)
    return [init_pegasus_linear(
        rng.normal(size=(8, n_out)).astype(np.float32), None,
        rng.normal(size=(64, 8)).astype(np.float32), group_size=2, depth=3,
        lut_bits=None, device=CPU)]


def _x(seed: int = 0, shape=(4, 8)) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _nam_model(seed: int = 7):
    """A CNN-shaped wrapper (window bank, NAM sum) built from numpy."""
    rng = np.random.default_rng(seed)
    layer = init_pegasus_linear(
        rng.normal(size=(6, 4)).astype(np.float32), None,
        rng.normal(size=(64, 6)).astype(np.float32), group_size=2, depth=3,
        lut_bits=None, device=CPU)
    return types.SimpleNamespace(window_bank=layer, head_banks=[], nam=True,
                                 out_bias=torch.zeros(4), pool_windows=6)


def test_plan_for_memoizes():
    banks = _fresh_banks(1)
    hits = STATS.plan_cache_hits
    p1 = plan_for(banks, device=CPU)
    p2 = plan_for(banks, device=CPU)
    assert p1 is p2
    assert STATS.plan_cache_hits == hits + 1
    x = _x()
    torch.testing.assert_close(p1(x, backend="onehot"), p1(x, backend="gather"),
                               rtol=1e-4, atol=1e-4)


def test_plan_for_keys_on_build_options():
    """fuse, fuse_nmax_cap, the bucket ladder and the device are part of
    the key; an absent knob keys like its default."""
    reg = PlanRegistry()
    banks = _fresh_banks(2)
    base = reg.plan_for(banks, device=CPU)
    assert reg.plan_for(banks, device=torch.device("cpu"), fuse=True) is base
    others = [reg.plan_for(banks, device=CPU, fuse=False),
              reg.plan_for(banks, device=CPU, fuse_nmax_cap=None),
              reg.plan_for(banks, device=CPU, bucket_sizes=[8, 64])]
    assert len({id(p) for p in [base, *others]}) == 4
    assert others[2].buckets == (8, 64)
    assert len(reg) == 4


def test_plan_for_detects_inplace_mutation():
    """Reassigning a bank on the model invalidates the memo: the engine
    would otherwise keep serving the pre-mutation tables."""
    model = list(_fresh_banks(3))
    p1 = plan_for(model, device=CPU)
    y1 = p1(_x(), backend="gather")
    assert plan_for(model, device=CPU) is p1           # unchanged → memo hit
    model[-1] = dataclasses.replace(model[-1])         # a refine()-style swap
    p2 = plan_for(model, device=CPU)
    assert p2 is not p1                                # mutation → rebuilt
    torch.testing.assert_close(p2(_x(), backend="gather"), y1, rtol=1e-6, atol=1e-6)


def test_plan_for_detects_wrapper_mutation():
    """Attribute reassignment on a wrapper model (id-stable key): the memo
    notices the compiled banks no longer match the model's."""
    model = _nam_model()
    x = _x(1, (4, 8, 2))
    p1 = plan_for(model, device=CPU)
    assert plan_for(model, device=CPU) is p1
    model.window_bank = dataclasses.replace(model.window_bank)
    p2 = plan_for(model, device=CPU)
    assert p2 is not p1
    torch.testing.assert_close(p2(x, backend="gather"), p1(x, backend="gather"),
                               rtol=1e-6, atol=1e-6)


def test_plan_for_detects_aux_mutation():
    """Non-bank attributes (NAM bias, logit LUT, window) are frozen into
    the plan at build; reassigning one invalidates the memo although every
    bank is unchanged."""
    model = _nam_model()
    x = _x(2, (4, 8, 2))
    p1 = plan_for(model, device=CPU)
    y1 = p1(x, backend="gather")
    assert plan_for(model, device=CPU) is p1
    model.out_bias = torch.ones(4)                     # a recalibrated bias
    p2 = plan_for(model, device=CPU)
    assert p2 is not p1
    torch.testing.assert_close(p2(x, backend="gather"), y1 + 1.0, rtol=1e-6, atol=1e-6)


def test_plan_registry_evicts_dropped_models():
    """Dropping a model evicts its memoized plan (a strong memo would pin
    models forever, and a recycled id() could alias a stale plan)."""
    reg = PlanRegistry()
    banks = _fresh_banks(11)
    plan = reg.plan_for(banks, device=CPU)
    assert reg.plan_for(banks, device=CPU) is plan
    assert len(reg) == 1
    del banks
    gc.collect()
    assert len(reg) == 0                               # dropped model → evicted
    # a plan the caller still holds keeps working after eviction
    assert torch.isfinite(plan(_x(), backend="gather")).all()


def test_plan_is_refcount_reclaimable():
    """A plan frees on refcount drop: its forward's closure does not
    reference the plan object."""
    plan = build_plan(_fresh_banks(31), device=CPU)
    plan(_x(), backend="gather")
    ref = weakref.ref(plan)
    del plan
    assert ref() is None


def test_plan_registry_bounded_and_explicit_eviction():
    reg = PlanRegistry(max_plans=2)
    keep = [_fresh_banks(s) for s in range(3)]
    plans = [reg.plan_for(m, device=CPU) for m in keep]
    assert len(reg) == 2                               # LRU-bounded
    assert reg.plan_for(keep[0], device=CPU) is not plans[0]   # oldest evicted → rebuilt
    assert reg.discard(keep[0]) == 1                   # explicit eviction
    assert len(reg) == 1
    assert reg.cache_info() == {"entries": 1, "capacity": 2, "named": []}
    reg.clear()
    assert len(reg) == 0


def test_plan_registry_concurrent_first_call_builds_once():
    """Threads racing plan_for on one uncached model: exactly one build,
    every caller handed the same plan; a second model builds beside it."""
    reg = PlanRegistry()
    a, b = _fresh_banks(54), _fresh_banks(55)
    before = STATS.plan_builds
    n = 16
    plans = [None] * n
    barrier = threading.Barrier(n)

    def first_call(i):
        barrier.wait(timeout=30)
        plans[i] = reg.plan_for(a if i % 2 else b, device=CPU)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_call, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert STATS.plan_builds == before + 2             # no double compile
    assert all(p is plans[1] for p in plans[1::2])
    assert all(p is plans[0] for p in plans[0::2])
    assert plans[0] is not plans[1] and len(reg) == 2


def test_failed_build_releases_waiters():
    """A build that raises leaves no in-flight marker: the next call
    builds again (and raises again) instead of waiting forever."""
    reg = PlanRegistry()
    for _ in range(2):
        with pytest.raises(TypeError):
            reg.plan_for(object(), device=CPU)
    assert len(reg) == 0 and not reg._building
