"""The sharded ``build_plan(devices=)`` mode of the port against the
single-device plan (the reference's ``tests/test_sharding.py`` engine tests,
on repeated CPU devices).

A plan built with K devices splits every padded bucket into K equal row
shards, runs each on its device and concatenates the outputs: rows never
interact, so the output must be the single-device plan's, bit for bit, on
every backend, fused and unfused, at an exact bucket and a ragged batch, and
in every family. On the CPU every kernel backend runs its plain version.
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import numpy as np
import pytest
import torch

from repro_torch.analysis.zoo import build_family
from repro_torch.core.amm import init_pegasus_linear
from repro_torch.engine import BACKENDS, build_plan
from repro_torch.engine.plan import resolve_devices
from repro_torch.engine.registry import PlanRegistry

CPU4 = ("cpu",) * 4


def _banks(seed: int = 0, n_out: int = 5, n: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return [init_pegasus_linear(
        rng.normal(size=(8, 8 if i < n - 1 else n_out)).astype(np.float32), None,
        rng.normal(size=(64, 8)).astype(np.float32), group_size=2, depth=3,
        lut_bits=None, device="cpu") for i in range(n)]


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).normal(size=(32, 8)).astype(np.float32)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_parity_all_backends(x, backend, fuse):
    """devices=4 CPU devices is bit-equal to the single-device plan, at an
    exact bucket (32) and a ragged batch (17, padded), fused and unfused."""
    banks = _banks(3, n=3)
    single = build_plan(banks, fuse=fuse, device="cpu", audit="off")
    sharded = build_plan(banks, fuse=fuse, devices=CPU4, audit="off")
    assert sharded.devices == (torch.device("cpu"),) * 4
    assert (single.fused_groups > 0) == fuse and sharded.fused_groups == single.fused_groups
    for n in (32, 17):
        a = single(x[:n], backend=backend)
        b = sharded(x[:n], backend=backend)
        assert b.shape == a.shape and torch.equal(a, b), f"{backend}@{n}"
    assert torch.equal(sharded(x[:17], backend=backend, jit=False),
                       single(x[:17], backend=backend))


def _family_inputs(family: str, n: int):
    from repro_torch.data.synthetic_traffic import make_dataset

    ds = make_dataset("peerrush", flows_per_class=48)
    t = ds.test
    if family == "cnn_l":
        return (t["seq"][:n].astype(np.float32), t["bytes"][:n].astype(np.float32))
    if family == "ae":
        from repro_torch.nets.autoencoder import anomaly_features

        return (anomaly_features(t["seq"].reshape(len(t["label"]), -1)[:n].astype(np.float32)),)
    return (t["seq"][:n].astype(np.float32),)


def _cnn_m():
    from repro_torch.data.synthetic_traffic import make_dataset
    from repro_torch.nets.cnn import pegasusify_cnn, train_cnn

    ds = make_dataset("peerrush", flows_per_class=48)
    m = train_cnn(ds.train["seq"], ds.train["label"], ds.num_classes, size="M",
                  steps=5, device="cpu")
    return pegasusify_cnn(m, ds.train["seq"], depth=5)


@pytest.mark.parametrize("family", ["rnn", "cnn", "cnn_m", "cnn_l", "ae"])
def test_sharded_parity_families(family):
    """The five other families: 4 CPU shards bit-equal to one device on
    kernel and kernel_q8, at a ragged batch."""
    model = _cnn_m() if family == "cnn_m" else build_family(family, device="cpu")
    inputs = _family_inputs("cnn" if family == "cnn_m" else family, 37)
    single = build_plan(model, device="cpu", audit="off")
    sharded = build_plan(model, devices=CPU4, audit="off")
    assert sharded.compile_stats()["devices"] == 4
    for be in ("gather", "kernel", "kernel_q8"):
        a = single(*inputs, backend=be)
        b = sharded(*inputs, backend=be)
        assert torch.equal(a, b), f"{family}/{be}"


def test_sharded_bucket_divisibility_validated():
    with pytest.raises(ValueError, match="not divisible"):
        build_plan(_banks(), devices=("cpu",) * 3, bucket_sizes=(16, 32), audit="off")


def test_sharded_plan_refuses_per_call_device(x):
    plan = build_plan(_banks(), devices=("cpu",) * 2, audit="off")
    with pytest.raises(ValueError, match="sharded across a device mesh"):
        plan(x, device="cpu")


def test_sharded_plan_home_device_must_match():
    plan = build_plan(_banks(), device="cpu", audit="off")
    with pytest.raises(ValueError, match="not the plan's device"):
        plan.shard_over((torch.device("meta"),) * 2)


def test_devices_participates_in_plan_memo_key(x):
    reg = PlanRegistry()
    banks = _banks()
    p_default = reg.plan_for(banks, device="cpu")
    assert reg.plan_for(banks, device="cpu", devices=None) is p_default
    p_sharded = reg.plan_for(banks, devices=CPU4)
    assert p_sharded is not p_default
    # a list and a tuple of the same devices resolve to the same key
    assert reg.plan_for(banks, devices=["cpu"] * 4) is p_sharded
    assert reg.plan_for(banks, devices=[torch.device("cpu")] * 4, device="cpu") is p_sharded
    assert resolve_devices(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    assert p_sharded.compile_stats()["devices"] == 4
    assert p_default.compile_stats()["devices"] == 1
    assert p_sharded.audit_report.summary["devices"] == 4


def test_sharded_counts_one_trace_per_bucket(x):
    plan = build_plan(_banks(), devices=CPU4, audit="off")
    for n in (32, 30, 17):
        plan(x[:n], backend="kernel")
    st = plan.compile_stats()
    assert st["traces"] == 1 and st["jit_calls"] == 3 and st["buckets"] == [("kernel", 32)]


@pytest.mark.cuda
def test_sharded_plan_on_repeated_card_is_bit_equal(x):
    """On the card: ("cuda:0",) * 4 shards replay one graph at bucket / 4
    rows per shard; outputs bit-equal to the single-device plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    banks = _banks(3, n=3)
    for fuse in (True, False):
        single = build_plan(banks, fuse=fuse, device="cuda", audit="off")
        sharded = build_plan(banks, fuse=fuse, devices=("cuda:0",) * 4, audit="off")
        for be in ("kernel", "kernel_q8"):
            for n in (32, 17):
                assert torch.equal(single(x[:n], backend=be), sharded(x[:n], backend=be))
