"""The LM stack's sharding strategy on a mesh is stated by the port, not
picked by DTensor per call (``models/sharding.py`` ``dense``,
``split_tokens``, ``write_at``).

* The dry-run of Qwen2-VL-2B on the 256-rank (32, 8) production mesh: a
  rank's FLOPs for ``train_4k`` are the same at one and at two
  microbatches and within 1.3x of ``analytic_cell``'s share, and the decode
  knobs (split-KV cache, feature-sharded stream) move no more collective
  bytes than plain decode. A smaller mesh does not show the fault these
  hold: on (8, 2) DTensor's own choice gave equal FLOPs at k = 1 and 8.
  k = 8 is left to ``chip_smoke.py`` phase 11 (d) (~45 s here).
* ``dense``'s rule per mesh dim, ``split_tokens``'s layout and
  ``write_at``'s local write on a fake 8-rank (2, 4) mesh.
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import NamedSharding, distribute
from repro_torch.models import sharding

MESH = (32, 8)


def test_train_4k_rank_flops_do_not_grow_with_microbatches():
    one = dryrun.dryrun_cell("qwen2_vl_2b", "train_4k", mesh_shape=MESH, microbatches=1)
    two = dryrun.dryrun_cell("qwen2_vl_2b", "train_4k", mesh_shape=MESH, microbatches=2)
    assert one["flops"] <= 1.3 * one["analytic_flops"], one["flops"] / one["analytic_flops"]
    assert abs(two["flops"] - one["flops"]) <= 0.1 * one["flops"], (two["flops"], one["flops"])
    # the step's weights are gathered once per microbatch, the peak falls
    assert one["collective_total"] < two["collective_total"] <= 3 * one["collective_total"]
    assert two["memory"]["peak_bytes"] <= 1.1 * one["memory"]["peak_bytes"]
    assert not dist.is_initialized()


def test_decode_32k_knobs_move_no_more_than_plain_decode():
    plain = dryrun.dryrun_cell("qwen2_vl_2b", "decode_32k", mesh_shape=MESH)
    knobs = dryrun.dryrun_cell("qwen2_vl_2b", "decode_32k", mesh_shape=MESH, optimized=True)
    assert knobs["collective_total"] <= plain["collective_total"], (
        knobs["collective_total"], plain["collective_total"])
    assert knobs["flops"] <= 1.1 * plain["flops"], (knobs["flops"], plain["flops"])
    assert plain["flops"] <= 1.3 * plain["analytic_flops"]


@pytest.fixture
def mesh():
    with dryrun.fake_mesh((2, 4), ("data", "model")) as m:
        yield m


def _meta(mesh, shape, *pl):
    return distribute(torch.empty(shape, device="meta"), NamedSharding(mesh, tuple(pl)))


S0, S1, S2, R = Shard(0), Shard(1), Shard(2), Replicate()


@pytest.mark.parametrize(("x_pl", "w_pl", "stationary", "want"), [
    # tokens split on both dims: the weight gathered whole (ZeRO-3)
    ((S0, S1), (S0, S1), False, (S0, S1)),
    # decode rows on "data": the weight stays, the rows become K slices on
    # "data" (summed back onto the rows), columns on "model"
    ((S0, R), (S0, S1), True, (S0, S2)),
    # the same rows without ``stationary``: the weight gathered over "data"
    ((S0, R), (S0, S1), False, (S0, S2)),
    # a row-parallel weight [K on "model", N on "data"] under decode rows:
    # the rows gathered for the columns on "data", K contracted on "model"
    ((S0, R), (S1, S0), True, (S0, R)),
    # the feature-sharded decode stream: K contracted on "data"
    ((S2, R), (S0, S1), True, (R, S2)),
    # replicated operands stay replicated
    ((R, R), (R, R), False, (R, R)),
])
def test_dense_states_its_strategy_per_mesh_dim(mesh, x_pl, w_pl, stationary, want):
    x = _meta(mesh, (8, 16, 32), *x_pl)
    w = _meta(mesh, (32, 64), *w_pl)
    y = sharding.dense(x, w, stationary=stationary)
    assert tuple(y.placements) == want and tuple(y.shape) == (8, 16, 64)
    assert not any(p.is_partial() for p in y.placements)


@pytest.mark.parametrize(("x_pl", "w_pl"), [
    ((S0, Partial()), (S0, S1)),          # a pending sum in the input
    ((S0, S2), (S0, S1)),                 # features split where the weight splits N
])
def test_dense_raises_where_no_rule_applies(mesh, x_pl, w_pl):
    x = (_meta(mesh, (8, 16, 32), *x_pl) if not x_pl[1].is_partial() else
         DTensor.from_local(torch.empty(4, 16, 32, device="meta"), mesh, list(x_pl),
                            run_check=False))
    with pytest.raises(ValueError, match="no stated strategy"):
        sharding.dense(x, _meta(mesh, (32, 64), *w_pl))


@pytest.mark.parametrize(("seq", "want"), [(16, (S0, S1)), (6, (S0, R))])
def test_split_tokens_puts_the_sequence_on_model(mesh, seq, want):
    x = _meta(mesh, (8, seq, 32), S0, R)
    assert tuple(sharding.split_tokens(x).placements) == want


@pytest.mark.parametrize(("pos", "written"), [(1, True), (5, False)])
def test_write_at_writes_only_on_the_rank_holding_pos(mesh, pos, written):
    """Rank 0 of (2, 4) holds rows 0-1 of 4 and positions 0-1 of 8 of a
    sequence-sharded cache: it writes position 1 and leaves position 5 to
    another rank, moving no cache bytes."""
    cache = DTensor.from_local(torch.zeros(2, 2, 3), mesh, [S0, S1], run_check=False,
                               shape=(4, 8, 3), stride=(24, 3, 1))
    value = DTensor.from_local(torch.arange(12.).reshape(4, 3), mesh, [R, R],
                               run_check=False)
    sharding.write_at(cache, pos, value)
    local = cache.to_local()
    if written:
        assert torch.equal(local[:, pos], torch.arange(6.).reshape(2, 3))
        local[:, pos] = 0
    assert not local.any()
