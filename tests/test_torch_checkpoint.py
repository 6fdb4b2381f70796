"""The port's checkpointing (``repro_torch.train.checkpoint``): the
reference's own checkpoint tests ported, directories that restore bit-equal
across the two packages in both directions, bf16 leaves, and the
``AsyncCheckpointer`` copy made before its thread starts."""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import train as jtrain
from repro.models import transformer as jtr
from repro.train import checkpoint as jckpt
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.configs import registry as treg
from repro_torch.interop import lm_arrays_from_params
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import init_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWState, adamw_init

CPU = torch.device("cpu")


def _tree():
    return {"layer": {"w": torch.arange(6.0).reshape(2, 3)},
            "step_count": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t)
    restored, step = ckpt.restore(str(tmp_path), t)
    assert step == 5
    assert torch.equal(restored["layer"]["w"], t["layer"]["w"])
    assert restored["step_count"].dtype == torch.int32 and int(restored["step_count"]) == 7
    assert sorted(os.listdir(tmp_path / "step_5")) == ["layer::w.npy", "manifest.json",
                                                       "step_count.npy"]


def test_checkpoint_keep_last_k(tmp_path):
    t = _tree()
    for s in range(6):
        ckpt.save(str(tmp_path), s, t, keep=2)
    assert ckpt.latest_steps(str(tmp_path)) == [4, 5]
    assert sorted(p for p in os.listdir(tmp_path)) == [
        "step_4", "step_4.COMMITTED", "step_5", "step_5.COMMITTED"]


def test_checkpoint_crash_mid_save_ignored(tmp_path):
    """A partial (uncommitted) save must not be picked up."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_2")
    (tmp_path / "step_2" / "manifest.json").write_text("{broken")
    assert ckpt.latest_step(str(tmp_path)) == 1
    restored, step = ckpt.restore(str(tmp_path), t)
    assert step == 1


def test_restore_places_leaves_on_the_device_asked_for(tmp_path):
    """``device=`` takes the place of the reference's ``shardings=``: each
    leaf lands there with its target's dtype; a module restores in place."""
    t = {"w": torch.arange(16.0).reshape(4, 4)}
    ckpt.save(str(tmp_path), 0, t)
    target = {"w": torch.zeros(4, 4, dtype=torch.float64)}
    restored, _ = ckpt.restore(str(tmp_path), target, device="cpu")
    assert restored["w"].dtype == torch.float64 and restored["w"].device == CPU
    np.testing.assert_array_equal(restored["w"].numpy(), t["w"].numpy())
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), t)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ckpt.restore(str(tmp_path), t, device="cuda")


def test_async_checkpointer(tmp_path):
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    c.save(3, _tree())
    c.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    ck = ckpt.async_save(str(tmp_path), 4, _tree(), keep=1)
    ck.wait()
    assert ckpt.latest_steps(str(tmp_path)) == [4]


def test_async_checkpointer_copies_before_its_thread_starts(tmp_path, monkeypatch):
    """An in-place update right after ``save()`` returns (the next train
    step) does not reach what the background thread writes: on the CPU a
    tensor's numpy view shares its storage."""
    release = threading.Event()
    write = ckpt._write

    def held_write(*args, **kwargs):
        assert release.wait(timeout=30)
        return write(*args, **kwargs)

    monkeypatch.setattr(ckpt, "_write", held_write)
    cfg = treg.smoke_config("qwen2_vl_2b")
    params = init_model(cfg, 0, dtype=torch.float32, device=CPU)
    opt = adamw_init(dict(params.named_parameters()))
    want = {k: p.detach().clone() for k, p in params.named_parameters()}
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    c.save(1, (params, opt))
    with torch.no_grad():
        for p in params.parameters():
            p.add_(1.0)
        opt.m["embed"].add_(1.0)
    release.set()
    c.wait()
    fresh = init_model(cfg, 1, dtype=torch.float32, device=CPU)
    (got, got_opt), _ = ckpt.restore(str(tmp_path), (fresh, adamw_init(
        dict(fresh.named_parameters()))))
    for k, p in got.named_parameters():
        assert torch.equal(p, want[k]), k
    assert not got_opt.m["embed"].any()


def test_async_checkpointer_raises_a_failed_write(tmp_path, monkeypatch):
    def failing_write(*_args, **_kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", failing_write)
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    c.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        c.wait()
    c.wait()        # reported once


def test_bf16_leaves_roundtrip_and_read_the_reference_files(tmp_path):
    """bf16 is stored as its raw 16-bit words, as the reference's numpy
    writes it, and restores bit-equal from either package's files."""
    t = {"w": torch.randn(3, 5).to(torch.bfloat16), "s": torch.ones(2)}
    ckpt.save(str(tmp_path / "port"), 1, t)
    restored, _ = ckpt.restore(str(tmp_path / "port"), t)
    assert restored["w"].dtype == torch.bfloat16 and torch.equal(restored["w"], t["w"])
    ref = {"w": jnp.asarray(t["w"].float().numpy(), dtype=jnp.bfloat16),
           "s": jnp.ones(2)}
    jckpt.save(str(tmp_path / "ref"), 2, ref)
    for d, step in (("port", 1), ("ref", 2)):
        stepdir = tmp_path / d / f"step_{step}"
        raw = np.load(stepdir / "w.npy")
        assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2
        manifest = json.loads((stepdir / "manifest.json").read_text())
        assert manifest["keys"]["w"]["dtype"] == "bfloat16"
    restored, _ = ckpt.restore(str(tmp_path / "ref"), t)
    assert torch.equal(restored["w"], t["w"])


def _trained_reference(arch: str):
    jcfg = jreg.smoke_config(arch)
    jp = jtr.init_model(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jo = jadamw_init(jp)
    step = jax.jit(jtrain.make_train_step(jcfg))
    batches = jtrain.synthetic_batches(jcfg, 2, 16)
    for _ in range(2):
        jp, jo, _ = step(jp, jo, next(batches))
    return jcfg, jp, jo


def _port_state(cfg, seed: int):
    params = init_model(cfg, seed, dtype=torch.float32, device=CPU)
    return params, adamw_init(dict(params.named_parameters()))


@pytest.mark.parametrize("arch", ["whisper_large_v3", "phi3_5_moe"])
def test_reference_directory_restores_into_the_port(tmp_path, arch):
    """``(params, AdamWState)`` saved by the reference restores bit-equal
    into the port's Params and AdamWState (flat dicts under the parameter
    names), under the keys the reference's own ``_flatten`` gives."""
    _, jp, jo = _trained_reference(arch)
    jckpt.save(str(tmp_path), 2, (jp, jo))
    cfg = treg.smoke_config(arch)
    params, opt = _port_state(cfg, seed=1)
    (got, got_opt), step = ckpt.restore(str(tmp_path), (params, opt))
    assert step == 2 and got is params and isinstance(got_opt, AdamWState)
    assert got_opt.step.dtype == torch.int32 and int(got_opt.step) == 2
    for mine, theirs in ((got, jp), (got_opt.m, jo.m), (got_opt.v, jo.v)):
        want = jax.tree.map(np.asarray, theirs)
        have = lm_arrays_from_params(cfg, mine)
        assert jax.tree.structure(have) == jax.tree.structure(want)
        for h, w in zip(jax.tree.leaves(have), jax.tree.leaves(want)):
            np.testing.assert_array_equal(h, w)
    assert set(ckpt._flatten((got, got_opt))) == set(jckpt._flatten((jp, jo)))


@pytest.mark.parametrize("arch", ["whisper_large_v3", "phi3_5_moe"])
def test_port_directory_restores_into_the_reference(tmp_path, arch):
    cfg = treg.smoke_config(arch)
    loop = ttrain.TrainLoop(cfg, device="cpu", seed=3)
    loop.run(ttrain.synthetic_batches(cfg, 2, 16), steps=2)
    ckpt.save(str(tmp_path), 2, (loop.params, loop.opt))
    jcfg = jreg.smoke_config(arch)
    jp = jtr.init_model(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    (rp, ro), step = jckpt.restore(str(tmp_path), (jp, jadamw_init(jp)))
    assert step == 2 and int(ro.step) == 2
    for mine, theirs in ((loop.params, rp), (loop.opt.m, ro.m), (loop.opt.v, ro.v)):
        for h, w in zip(jax.tree.leaves(lm_arrays_from_params(cfg, mine)),
                        jax.tree.leaves(jax.tree.map(np.asarray, theirs))):
            np.testing.assert_array_equal(h, w)


def test_generic_tree_keys_cross_both_packages(tmp_path):
    """Dicts that are not parameter dicts keep their keys as they are, as the
    reference's ``_flatten`` writes them: digit keys (leaves of unequal
    shapes), dotted keys, a digit key at the top, lists and a NamedTuple.
    Each package's directory restores bit-equal into the other."""
    rng = np.random.default_rng(0)
    arrs = {"blocks": {"0": rng.normal(size=(2, 3)), "1": rng.normal(size=(4,))},
            "a.b": {"c.0": rng.normal(size=(3,))}, "0": rng.normal(size=(5,)),
            "seq": [rng.normal(size=(2,)), rng.normal(size=(1, 2))],
            "opt": AdamWState(np.array(3, np.int32), {"w": rng.normal(size=(2, 2))},
                              {"w": rng.normal(size=(2, 2))})}
    arrs = jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype != np.int32 else a,
                        arrs)
    tt = jax.tree.map(torch.from_numpy, arrs)
    jt = jax.tree.map(jnp.asarray, arrs)
    ckpt.save(str(tmp_path / "port"), 1, tt)
    jckpt.save(str(tmp_path / "ref"), 1, jt)
    assert set(ckpt._flatten(tt)) == set(jckpt._flatten(jt)) == {
        "blocks::0", "blocks::1", "a.b::c.0", "0", "seq::0", "seq::1", "opt::.step",
        "opt::.m::w", "opt::.v::w"}
    zeros_t = jax.tree.map(torch.zeros_like, tt)
    zeros_j = jax.tree.map(jnp.zeros_like, jt)
    for d in ("port", "ref"):
        got_t, _ = ckpt.restore(str(tmp_path / d), zeros_t)
        got_j, _ = jckpt.restore(str(tmp_path / d), zeros_j)
        assert isinstance(got_t["opt"], AdamWState) and isinstance(got_t["seq"], list)
        for got in (got_t, got_j):
            assert jax.tree.structure(jax.tree.map(np.asarray, got)) == \
                jax.tree.structure(arrs)
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(arrs)):
                np.testing.assert_array_equal(np.asarray(g), w)
