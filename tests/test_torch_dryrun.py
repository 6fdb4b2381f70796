"""The port's dry-run, roofline, report and collective accounting
(``launch/{dryrun,roofline,report,comm_analysis}.py``).

* ``analytic_cell``'s FLOP and byte fields equal the reference's for every
  (arch, shape): the formulas are the reference's, priced on 256 chips.
* ``comm_analysis.LocalOpCounter`` on hand-built DTensor redistributions
  and a product whose collective bytes and local FLOPs are known.
* The ``--optimized`` knobs, a (2, 2, 2) mesh with "pod", the CLI (the
  smoke architectures' cells are ``tests/test_torch_dryrun_cells.py``).
* The report's tables from a fixed JSON.
"""

import torch_threads  # noqa: F401  (this worker's share of the cores)

import json

import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jreg
from repro.launch import roofline as jroof
from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.comm_analysis import LocalOpCounter, collective_kind
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf_mod

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_cell_matches_reference(arch, shape):
    for remat in ("nothing", "dots", "none"):
        for lut in (False, True):
            ref = jroof.analytic_cell(jreg.get_config(arch), shape, remat=remat,
                                      lut_serving=lut)
            port = roofline.analytic_cell(get_config(arch), shape, remat=remat,
                                          lut_serving=lut)
            assert port == ref, (remat, lut)


def test_roofline_is_priced_for_the_h100():
    hw = roofline.H100
    assert (hw.peak_flops, hw.f32_flops, hw.hbm_bw, hw.chips) == (989e12, 67e12, 3.35e12, 256)
    assert (hw.nvlink_bw, hw.ib_bw, hw.hbm_bytes) == (450e9, 50e9, 80 * 2**30)
    assert hw.axis_bw("model") == 450e9 and hw.axis_bw("data") == hw.axis_bw("pod") == 50e9
    cfg = get_config("qwen2_vl_2b")
    a = roofline.analytic_cell(cfg, "train_4k")
    t = roofline.roofline_terms(cfg, "train_4k", 0,
                                collective_by_axis={"model": {"all-gather": 450e6},
                                                    "data": {"reduce-scatter": 50e6}})
    assert t["compute_s"] == a["flops_per_device"] / 989e12
    assert t["collective_s"] == pytest.approx(1e-3 + 1e-3)
    # without the axes every byte crosses InfiniBand
    assert roofline.roofline_terms(cfg, "train_4k", 50e6)["collective_s"] == pytest.approx(1e-3)


def test_comm_analysis_counts_a_hand_built_product():
    """x [32, 1024] f32 batch-sharded on "data" (2) times w [1024, 4096]
    sharded (data, model=4): gathering x over "data" moves 32·1024·4 B,
    reducing a [32, 1024] partial over "model" moves the same, and the local
    product [32, 1024] x [1024, 1024] is 2·32·1024·1024 FLOPs."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import NamedSharding, distribute

    with dryrun.fake_mesh((2, 4), ("data", "model")) as mesh:
        def dt(shape, pl):
            return distribute(torch.empty(shape, device="meta"), NamedSharding(mesh, tuple(pl)))

        x = dt((32, 1024), [Shard(0), Replicate()])
        w = dt((1024, 4096), [Replicate(), Shard(1)])
        p = DTensor.from_local(torch.empty(32, 1024, device="meta"), mesh,
                               [Replicate(), Partial()], run_check=False)
        with LocalOpCounter(mesh, held=(x, w, p)) as c:
            xr = x.redistribute(mesh, [Replicate(), Replicate()])
            y = xr @ w
            pr = p.redistribute(mesh, [Replicate(), Replicate()])
        r = c.report()
    assert y.placements == (Replicate(), Shard(1)) and pr.placements == (Replicate(),) * 2
    assert r["collective_by_axis"] == {"data": {"all-gather": 32 * 1024 * 4},
                                       "model": {"all-reduce": 32 * 1024 * 4}}
    assert r["collective_total"] == 2 * 32 * 1024 * 4 and r["collective_calls"] == 2
    assert r["flops"] == 2 * 32 * 1024 * 1024
    assert r["held_bytes"] == (16 * 1024 + 1024 * 1024 + 32 * 1024) * 4
    assert r["peak_bytes"] >= r["held_bytes"] + 32 * 1024 * 4 + 32 * 1024 * 4
    assert collective_kind(torch.ops.aten.mm.default) is None
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_dryrun_optimized_knobs(shape):
    """--optimized turns on each kind's knobs (microbatches 8; seq-parallel
    attention, SP layer boundaries and the last-token head; split-KV cache
    and feature-sharded decode) and leaves them off afterwards."""
    r = dryrun.dryrun_cell("deepseek_coder_33b", shape, mesh_shape=(2, 4), smoke=True,
                           optimized=True)
    plain = dryrun.dryrun_cell("deepseek_coder_33b", shape, mesh_shape=(2, 4), smoke=True)
    assert r["mesh"] == "2x4" and r["collective_total"] > 0
    assert r["collective_by_axis"] != plain["collective_by_axis"]
    assert (attn_mod.SEQ_PARALLEL_ATTN, tf_mod.LAYER_SEQ_SHARD,
            tf_mod.DECODE_FEATURE_SHARD) == (False, False, False)


def test_dryrun_on_a_pod_mesh():
    """A (2, 2, 2) mesh with "pod": the fsdp axes are ("pod", "data"), and
    collectives cross all three axes."""
    r = dryrun.dryrun_cell("qwen2_vl_2b", "train_4k", mesh_shape=(2, 2, 2), smoke=True)
    assert r["mesh"] == "2x2x2" and set(r["collective_by_axis"]) == {"pod", "data", "model"}


def test_dryrun_cli_writes_json(tmp_path, capsys):
    out = tmp_path / "dr.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "xlstm_1_3b", "--shape", "long_500k", "--json", str(out)])
    assert e.value.code == 0
    rows = json.loads(out.read_text())
    assert rows[0]["arch"] == "xlstm_1_3b" and rows[0]["mesh"] == "32x8"
    assert rows[0]["ranks"] == 256 and rows[0]["flops"] > 0
    assert "[ok] xlstm_1_3b" in capsys.readouterr().out


def _fixed_results() -> list:
    ok = {"arch": "qwen2_vl_2b", "shape": "train_4k", "trace_s": 9.1, "flops": 6.3e13,
          "collective_total": 9.3e9, "memory": {"peak_bytes": 10 * 2**30},
          "collective_by_axis": {"data": {"all-gather": 4.65e9}, "model": {"all-reduce": 4.65e9}}}
    return [ok,
            {"arch": "qwen2_vl_2b", "shape": "long_500k", "skipped": "full attention: 524k"},
            {"arch": "xlstm_1_3b", "shape": "decode_32k", "error": "RuntimeError: boom"}]


def test_report_tables_from_fixed_json(tmp_path):
    path = tmp_path / "single.json"
    path.write_text(json.dumps(_fixed_results()))
    results = report.load_results(str(path))
    table = report.dryrun_table(results, report.SINGLE_LABEL)
    assert table[0] == f"### Mesh {report.SINGLE_LABEL}" and "H100" in table[0]
    assert table[4] == "| qwen2_vl_2b | train_4k | 9.1 | 6.30e+13 | 9.30e+09 | 10.0 GiB | ok |"
    assert table[5].startswith("| qwen2_vl_2b | long_500k | — |") and "SKIP" in table[5]
    assert table[6].endswith("| **FAIL** RuntimeError: boom |")
    rows = report.roofline_table(results)
    cfg = get_config("qwen2_vl_2b")
    t = roofline.roofline_terms(cfg, "train_4k", 9.3e9,
                                collective_by_axis=_fixed_results()[0]["collective_by_axis"])
    assert rows[2:] == [roofline.format_row("qwen2_vl_2b", "train_4k", t)]
    notes = report.narrative(results)
    assert notes[-1].startswith(f"- **qwen2_vl_2b × train_4k** ({t['dominant']}-bound)")
    out = tmp_path / "r.md"
    report.main(["--single", str(path), "--multi", str(path), "--out", str(out)])
    text = out.read_text()
    assert report.MULTI_LABEL in text and "## Roofline" in text
