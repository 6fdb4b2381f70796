"""``BENCHMARK.json`` keeps to the benchmark's contract, and a
configuration, a mix and a metric are added as new files and entries with
no edit to a file that exists."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

from conftest import SMALL

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LAYER_FREE = re.compile(r"^[^\t\n]{1,200}$")


def _spec(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_keys_names_and_units(root):
    spec = _spec(root)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) for p in spec["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in spec["paths"])
    assert 1 <= len(spec["command"]) <= 32
    assert all(LAYER_FREE.match(w) for w in spec["command"])
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group), group
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (root / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert LAYER_FREE.match(c["why"]) and LAYER_FREE.match(c["source"])
        assert c["name"] in {w["config"] for w in spec["workloads"]}
    assert len({c["file"] for c in spec["configs"]}) == len(spec["configs"])
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LAYER_FREE.match(w["why"])
        assert (root / "bench" / "mixes" / f"{w['traffic']}.json").is_file()
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(cells) // 4)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (root / "bench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= set(cells)
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    perf = (root / "PERF.md").read_text()
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LAYER_FREE.match(m["layer"]) and f"**{m['layer']}**" in perf
        moved = e2e[m["moves"]]
        # each cell that reads the metric reports the metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:     # every cell: setup_s, another end-to-end metric, a per-layer one
        own = [m for m in spec["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(own) >= 2
        assert any(cell in m.get("workloads", cells) for m in spec["per_layer"])
    # a full check of 24 cells fits the driver's time
    assert 2 + 14 * 24 * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(spec)) <= 64 * 1024


def _digest(path):
    return {p.relative_to(path): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_new_files_alone(root, tmp_path):
    """A new configuration (MLP-B served on ``kernel_q8``, expressed as data
    over the same module), a new closed-loop mix and a new per-layer metric
    run as a new cell; every file that was there but ``BENCHMARK.json`` is
    unchanged."""
    from bench.harness import run_cell

    new = tmp_path / "checkout"
    shutil.copytree(root / "bench", new / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", new / "BENCHMARK.json")
    before = _digest(new)
    cfg = json.loads((new / "bench" / "configs" / "mlp-b.json").read_text())
    cfg.update(name="mlp-b-q8", module="mlp-b", backend="kernel_q8")
    (new / "bench" / "configs" / "mlp-b-q8.json").write_text(json.dumps(cfg))
    (new / "bench" / "mixes" / "few.json").write_text(json.dumps(
        {"type": "closed", "clients": 2, "sizes": [5, 50, 500]}))
    (new / "bench" / "metrics" / "requests_per_batch.py").write_text(
        "def read(ctx):\n"
        "    (s0, s1) = ctx.serving\n"
        "    b = s1['batches_dispatched'] - s0['batches_dispatched']\n"
        "    return (s1['requests_served'] - s0['requests_served']) / b if b else None\n")
    spec = json.loads((new / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "mlp-b-q8", "source": "https://arxiv.org/abs/2506.05779",
                            "file": "bench/configs/mlp-b-q8.json", "reduced": [],
                            "why": "MLP-B on the int8 kernels"})
    spec["workloads"].append({"name": "mlp-b-q8.few", "config": "mlp-b-q8", "traffic": "few",
                              "chips": 1, "why": "two clients of 5-500 flows"})
    for m in spec["end_to_end"]:
        if m["name"] == "flows_per_s":
            m["workloads"].append("mlp-b-q8.few")
    spec["per_layer"].append({"name": "requests_per_batch", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "server", "moves": "flows_per_s",
                              "workloads": ["mlp-b-q8.few"]})
    (new / "BENCHMARK.json").write_text(json.dumps(spec))
    for trace in (False, True):
        r = run_cell("mlp-b-q8.few", 2**31 + 99, 1.0, trace, t_start=0.0, root=new,
                     device="cpu", overrides=SMALL, check_flows=20_000, warm_s=0.3)
        assert r["correct"], r["check"]
        want = {"requests_per_batch"} if trace else {"flows_per_s", "setup_s"}
        assert want <= set(r["metrics"])
    after = _digest(new)
    del before[Path("BENCHMARK.json")]           # gains entries, as it must
    assert {k: after[k] for k in before} == before
