"""The LM stack on a mesh: the port's ``launch/mesh.py`` and ``specs.py``
against the reference's, and ``Server``, ``TrainLoop`` and elastic
``restore`` on gloo meshes against the unsharded port.

* Specs: ``param_specs``, ``batch_specs`` and ``decode_state_specs``
  (``cache_seq_shard`` both ways) equal the reference's leaf by leaf for all
  ten configs, full (meta tensors against ``jax.eval_shape``) and smoke, on
  (1, 1), (2, 4), (4, 2) and (2, 2, 2) meshes. The port keeps layers as
  modules, so a layer leaf's spec is the reference's without its leading
  ``None``.
* Four spawned gloo ranks on a (2, 2) mesh (a ``FileStore`` in ``tmp_path``,
  no TCP), every smoke architecture: ``Server`` decode logits within 1e-5
  relative L2 of the unsharded port over 4 steps, tokens identical where
  the top-2 margin exceeds that; ``TrainLoop``'s first loss within 1e-6;
  each parameter's gradient (Adam's m after that step) within 1e-5
  relative L2; each parameter's move by one AdamW step (lr 3e-4) within
  2e-2 relative L2. Adam's first update is g / (|g| + 1e-8): on the few
  elements whose gradient sits near 1e-8 it passes on the ~1e-6 relative
  noise of another summation order at full size, so a leaf's move differs
  by up to ~1e-2 (the MoE router, whose gradients cancel through the top-k
  normalisation) where its gradient agrees to ~1e-6. The gradients carry
  the check; the move shows that the update ran on every shard.
* A checkpoint saved by a ``TrainLoop`` on a (1, 1) mesh (a one-rank gloo
  group made and destroyed by a fixture) restores bit-equal onto (2, 2),
  and the (2, 2) save restores bit-equal onto (1, 1) again.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import registry as jreg
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_config, smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.train.checkpoint import split_name

import torch_mesh_ranks as ranks

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _ref_leaf(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _flat_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): tuple(s)
            for kp, s in flat}


def _padded(spec: tuple, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameter shapes per (arch, smoke), from eval_shape."""
    cache = {}

    def get(arch, smoke):
        if (arch, smoke) not in cache:
            cfg = jreg.smoke_config(arch) if smoke else jreg.get_config(arch)
            cache[(arch, smoke)] = jax.eval_shape(
                lambda: jtf.init_model(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
        return cache[(arch, smoke)]

    return get


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, smoke, ref_params):
    if jax.device_count() < 8:
        pytest.skip("needs 8 XLA host devices (tests/conftest.py sets them)")
    jp = ref_params(arch, smoke)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    tp = tspecs.param_shapes(cfg)
    assert all(p.is_meta for p in tp.parameters())
    jcfg = jreg.smoke_config(arch) if smoke else jreg.get_config(arch)
    for shape, names in MESHES:
        ref = _flat_specs(jmesh.param_specs(jcfg, jp, _jax_mesh(shape, names)))
        port = tmesh.param_specs(cfg, tp, tmesh.MeshShape(shape, names))
        seen = set()
        for name, p in tp.named_parameters():
            path, layer = split_name(name)
            key = "/".join(path)
            leaf = _ref_leaf(jp, path)
            want = _padded(ref[key], leaf.ndim)
            if layer is not None:
                assert want[0] is None
                want = want[1:]
                assert tuple(p.shape) == tuple(leaf.shape[1:]), name
            else:
                assert tuple(p.shape) == tuple(leaf.shape), name
            assert tuple(port[name]) == want, (name, shape)
            seen.add(key)
        assert seen == set(ref), set(ref) ^ seen


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_decode_state_specs_match_reference(arch, smoke):
    if jax.device_count() < 8:
        pytest.skip("needs 8 XLA host devices (tests/conftest.py sets them)")
    cfg = smoke_config(arch) if smoke else get_config(arch)
    jcfg = jreg.smoke_config(arch) if smoke else jreg.get_config(arch)
    for shape, names in MESHES:
        jm, tm = _jax_mesh(shape, names), tmesh.MeshShape(shape, names)
        for cell, (seq, gb, kind) in SHAPES.items():
            assert tspecs.skip_reason(cfg, cell) == jspecs.skip_reason(jcfg, cell)
            if kind in ("train", "prefill"):
                jb, tb = jspecs.input_specs(jcfg, cell), tspecs.input_specs(cfg, cell)
                assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                        for k, v in tb.items()} == {k: (tuple(v.shape), str(v.dtype))
                                                    for k, v in jb.items()}
                ref = _flat_specs(jmesh.batch_specs(jcfg, jb, jm, batch_size=gb))
                port = tmesh.batch_specs(cfg, tb, tm, batch_size=gb)
                assert {k: tuple(v) for k, v in port.items()} == {
                    k: _padded(v, jb[k].ndim) for k, v in ref.items()}
                continue
            jst = jspecs.decode_state_shapes(jcfg, gb, seq)
            tst = tspecs.decode_state_shapes(cfg, gb, seq)
            assert {k: tuple(v.shape) for k, v in tst.items()} == {
                k: tuple(v.shape) for k, v in jst.items()}
            assert all(v.is_meta for v in tst.values())
            for css in (False, True):
                ref = _flat_specs(jmesh.decode_state_specs(
                    jcfg, jst, jm, batch_size=gb, cache_seq_shard=css))
                port = tmesh.decode_state_specs(cfg, tst, tm, batch_size=gb,
                                                cache_seq_shard=css)
                assert {k: tuple(v) for k, v in port.items()} == {
                    k: _padded(v, jst[k].ndim) for k, v in ref.items()}, (cell, css)


def test_named_turns_specs_into_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = tmesh.MeshShape((2, 2, 2), ("pod", "data", "model"))
    spec = tmesh.P(("pod", "data"), "model")
    assert tmesh.placements(m, spec) == (Shard(0), Shard(0), Shard(1))
    assert tmesh.placements(m, tmesh.P(None, None)) == (Replicate(),) * 3
    tree = tmesh.named(m, {"a": spec, "b": [tmesh.P()]})
    assert tree["a"].placements == (Shard(0), Shard(0), Shard(1)) and tree["a"].mesh is m
    assert tree["b"][0].placements == (Replicate(),) * 3
    prod = tmesh.production_mesh_shape()
    assert prod.shape == (32, tmesh.MODEL_AXIS_SIZE) and tmesh.MODEL_AXIS_SIZE == 8
    assert tmesh.production_mesh_shape(multi_pod=True).shape == (2, 32, 8)
    assert tmesh.fsdp_axes(m) == ("pod", "data") and tmesh.fsdp_axes(prod) == ("data",)


def _spawn(fn, tmp_path, *args):
    ctx = mp.spawn(fn, args=(4, str(tmp_path), *args), nprocs=4, join=False)
    while not ctx.join(timeout=300):
        pass


def test_server_and_trainloop_on_2x2_gloo_mesh_match_unsharded(tmp_path):
    _spawn(ranks.parity_rank, tmp_path, list(ARCH_IDS))
    with open(tmp_path / "out.json") as f:
        out = json.load(f)
    with open(tmp_path / "microbatches.json") as f:
        micro = json.load(f)
    assert sorted(out) == sorted(ARCH_IDS)
    # TrainLoop(microbatches=2) on the mesh: each microbatch is a row of
    # every "data" shard, other rows than the unsharded slices, the same sums
    assert micro["loss_err"] < 1e-6, micro["loss_err"]
    assert micro["moved_any"] > 1e-4
    worst = max(micro["grad_rel"].items(), key=lambda kv: kv[1])
    assert worst[1] < 1e-5, (ranks.MICROBATCH_ARCH, worst)
    assert max(micro["moved_rel"].values()) < 2e-2
    for arch, r in out.items():
        assert r["logits_rel"] < 1e-5, (arch, r["logits_rel"])
        assert r["tokens_ok"], arch
        assert r["loss_err"] < 1e-6, (arch, r["loss_err"])
        assert r["moved_any"] > 1e-4, arch             # the step moved the weights
        worst = max(r["grad_rel"].items(), key=lambda kv: kv[1])
        assert worst[1] < 1e-5, (arch, worst)
        worst = max(r["moved_rel"].items(), key=lambda kv: kv[1])
        assert worst[1] < 2e-2, (arch, worst)
    print("worst move rel L2:", {a: max(r["moved_rel"].values()) for a, r in out.items()})


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A (1, 1) mesh over a one-rank gloo group, destroyed after the test."""
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store1"), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_checkpoint_restores_elastically_across_meshes(tmp_path, one_rank_mesh):
    from repro_torch.launch.train import TrainLoop, synthetic_batches

    arch = "qwen2_vl_2b"
    cfg = smoke_config(arch)
    src, dst = str(tmp_path / "ckpt_1x1"), str(tmp_path / "ckpt_2x2")
    loop = TrainLoop(cfg, mesh=one_rank_mesh, device="cpu", ckpt_dir=src)
    loop.run(synthetic_batches(cfg, 4, 16, seed=2), 2)     # steps 0, 1: lr > 0 at 1
    saved = {k: p.full_tensor().detach().clone() for k, p in loop.params.named_parameters()}
    m_saved = {k: v.full_tensor().clone() for k, v in loop.opt.m.items()}

    _spawn(ranks.restore_rank, tmp_path, arch, src, dst)
    with open(tmp_path / "restore.json") as f:
        r = json.load(f)
    assert r == {"start_step": 2, "equal": True, "placed": True}

    back = TrainLoop(cfg, mesh=one_rank_mesh, device="cpu", ckpt_dir=dst)
    assert back.start_step == 2
    for k, p in back.params.named_parameters():
        assert torch.equal(p.full_tensor(), saved[k]), k
    for k, v in back.opt.m.items():
        assert torch.equal(v.full_tensor(), m_saved[k]), k
    assert sorted(os.listdir(dst)) == sorted(os.listdir(src))


@pytest.mark.parametrize(("batch", "microbatches"), [(1, 1), (2, 2)])
def test_trainloop_on_a_mesh_takes_one_row_batches(one_rank_mesh, batch, microbatches):
    """A batch (or microbatch) of one row on a mesh whose data axis has size
    1: DTensor cannot reshape a sharded dim of size 1, so the loop places
    such a row replicated. Losses and gradients equal the unsharded loop's."""
    from repro_torch.launch.train import TrainLoop, synthetic_batches

    cfg = smoke_config("granite_20b")
    kw = dict(device="cpu", microbatches=microbatches)
    meshed, plain = TrainLoop(cfg, mesh=one_rank_mesh, **kw), TrainLoop(cfg, **kw)
    for _ in range(2):
        got = meshed.run(synthetic_batches(cfg, batch, 16), 1)
        want = plain.run(synthetic_batches(cfg, batch, 16), 1)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-6 * abs(float(want["loss"]))
    for k, m in meshed.opt.m.items():
        w = plain.opt.m[k]
        assert float(torch.linalg.norm(m.full_tensor() - w)) <= 1e-5 * float(torch.linalg.norm(w)) + 1e-12, k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_server_on_a_mesh_takes_one_prompt(one_rank_mesh, arch):
    """One prompt on a (1, 1) mesh: the tokens and the decode caches keep a
    batch dim of size 1, which DTensor cannot reshape while sharded, so the
    server places them replicated over mesh dims of size 1. Tokens equal the
    unsharded server's."""
    from repro_torch.launch.serve import Server

    cfg = smoke_config(arch)
    prompt = np.array([[3]], dtype=np.int32)
    kw = dict(device="cpu", kv_len=32, batch_size=1)
    got = Server(cfg, mesh=one_rank_mesh, **kw).generate(prompt, max_new=3)
    np.testing.assert_array_equal(got, Server(cfg, **kw).generate(prompt, max_new=3))
