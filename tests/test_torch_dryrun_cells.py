"""Every smoke architecture × shape of the LM stack dry-runs on a fake
8-rank (2, 4) mesh (``repro_torch.launch.dryrun``): ``long_500k`` is skipped
exactly where the reference skips it; the ranks' FLOPs add up to at least
the unsharded step's; every train cell moves collective bytes, its
gradients reduce-scattered (ZeRO-3); no process group or model knob is left
behind.
"""

import pytest
import torch.distributed as dist

from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro_torch.configs.registry import ARCH_IDS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf_mod

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_every_smoke_cell_on_a_fake_8_rank_mesh(arch, shape):
    knobs = (attn_mod.SEQ_PARALLEL_ATTN, tf_mod.LAYER_SEQ_SHARD, tf_mod.DECODE_FEATURE_SHARD)
    r = dryrun.dryrun_cell(arch, shape, mesh_shape=(2, 4), smoke=True)
    assert not dist.is_initialized()
    assert (attn_mod.SEQ_PARALLEL_ATTN, tf_mod.LAYER_SEQ_SHARD,
            tf_mod.DECODE_FEATURE_SHARD) == knobs
    skip = jspecs.skip_reason(jreg.smoke_config(arch), shape)
    if skip is not None:
        assert r == {"arch": arch, "shape": shape, "skipped": skip}
        return
    assert "skipped" not in r and r["mesh"] == "2x4" and r["ranks"] == 8
    assert r["flops"] * 8 >= dryrun.unsharded_flops(arch, shape, smoke=True)
    assert r["memory"]["peak_bytes"] >= r["memory"]["held_bytes"] > 0
    if SHAPES[shape][2] == "train":
        assert r["collective_total"] > 0
        assert r["collective_bytes"]["reduce-scatter"] > 0       # ZeRO-3 gradients
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                  "bound_step_s"}
