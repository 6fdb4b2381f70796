"""The port's lint (``repro_torch.analysis.lint``, PG000-PG004 with torch's
host syncs and graph captures in its tables) against seeded fixtures, the
port's own tree, and both CLIs of ``python -m repro_torch.analysis``.

Fixture files under ``tests/fixtures/analysis_torch/`` mark every expected
finding with a ``# VIOLATION PGxxx`` comment ON the offending line; the
tests derive the expected (line, rule) pairs by scanning for those
markers.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (this worker's share of the cores)

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import lint_file, lint_paths, lint_source, main
from repro_torch.analysis import lint as tlint
from repro_torch.analysis import planaudit
from repro_torch.analysis.sanitizer import LOCK_RANKS

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "analysis_torch"
PORT = ROOT / "src" / "repro_torch"

_MARKER = re.compile(r"#\s*VIOLATION\s+(PG\d{3})")


def _expected(path: Path) -> list[tuple[int, str]]:
    out = []
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        m = _MARKER.search(line)
        if m:
            out.append((i, m.group(1)))
    return sorted(out)


def _found(findings) -> list[tuple[int, str]]:
    return sorted((f.line, f.rule) for f in findings)


@pytest.mark.parametrize("fixture,rule", [
    ("viol_pg001.py", "PG001"), ("viol_pg001_blocking.py", "PG001"),
    ("viol_pg002.py", "PG002"), ("viol_pg003.py", "PG003"), ("viol_pg004.py", "PG004"),
])
def test_fixture_findings_exactly_where_marked(fixture, rule):
    path = FIXTURES / fixture
    findings = lint_file(path)
    assert _expected(path), "a fixture marks at least one finding"
    assert _found(findings) == _expected(path)
    assert {f.rule for f in findings} == {rule}


def test_pg001_names_each_host_sync():
    messages = "\n".join(f.message for f in lint_file(FIXTURES / "viol_pg001.py"))
    for call in ("y.cpu()", ".item()", "host.numpy()", "y.tolist()",
                 "torch.cuda.synchronize()", "event.synchronize()",
                 "stream.synchronize()"):
        assert f"host sync `{call}`" in messages, call
    assert "plan build `build_plan`" in messages
    assert "clean_paths" not in messages


def test_pg003_ranks_come_from_the_sanitizers_table():
    """PG003 ranks a lock by the name it was created under, in the same
    ``LOCK_RANKS`` the runtime sanitizer checks; every ranked lock the port
    creates gets exactly its table rank."""
    msgs = [f.message for f in lint_file(FIXTURES / "viol_pg003.py")]
    assert msgs[0].startswith("`_lock` (rank 0) acquired while holding `_ctr_lock` (rank 2)")
    seen = {}
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        ranks = tlint._Linter._collect_lock_ranks(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                    and getattr(node.value.func, "id", None) == "make_lock"):
                name = node.value.args[0].value
                attr = getattr(node.targets[0], "attr", None) or node.targets[0].id
                if name in LOCK_RANKS:
                    assert ranks[attr] == LOCK_RANKS[name], (path.name, attr)
                    seen[name] = ranks[attr]
    assert seen == LOCK_RANKS


def test_suppressions_justified_silent_bare_is_pg000():
    path = FIXTURES / "suppressed.py"
    findings = lint_file(path)
    assert [f.rule for f in findings] == ["PG000"]
    bare = next(i for i, ln in enumerate(path.read_text().splitlines(), start=1)
                if ln.rstrip().endswith("disable=PG001"))
    assert findings[0].line == bare and "justification" in findings[0].message


def test_pg000_unattached_guarded_by_comment():
    findings = lint_source("# guarded-by: _lock\nx = 1\n")
    assert [f.rule for f in findings] == ["PG000"]
    assert "not attached" in findings[0].message


def test_port_tree_is_clean():
    """The port's own code lints clean under the port's tables."""
    assert lint_paths([PORT]) == []


def test_cli_exit_codes(capsys):
    assert main([str(FIXTURES / "viol_pg004.py")]) == 1
    out = capsys.readouterr().out
    assert "PG004" in out and "unsuppressed finding" in out
    assert main([str(PORT / "analysis" / "rules.py")]) == 0
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "PG004" in out and "PGA104" in out


def test_module_cli_exit_codes():
    """``python -m repro_torch.analysis <paths>`` in a process of its own:
    1 on findings, 0 on the clean port."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    bad = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          str(FIXTURES / "viol_pg001.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert bad.returncode == 1, bad.stderr
    good = subprocess.run([sys.executable, "-m", "repro_torch.analysis", str(PORT)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert good.returncode == 0, good.stdout + good.stderr
    assert "0 unsuppressed findings" in good.stdout


@pytest.mark.parametrize("families,budget,suppress,code", [
    ("mlp", None, "", 0),       # no finding above info
    ("cnn", None, "", 0),       # none either: the CNN-B heads' K = 24 LUT is read through L1
    ("cnn", 1024, "", 1),       # launches over a 1 KB shared-memory budget (PGA103 errors)
    ("cnn", 1024, "PGA103", 0),
], ids=["mlp--0", "cnn--0", "cnn-1024--1", "cnn-1024-PGA103-0"])
def test_plan_cli_exit_codes(families, budget, suppress, code, capsys, tmp_path):
    argv = ["--families", families, "--backends", "kernel_q8", "--device", "cpu",
            "--steps", "2", "--out", str(tmp_path / "audit.json")]
    if budget:
        argv += ["--smem-budget", str(budget)]
    if suppress:
        argv += ["--suppress", suppress]
    assert planaudit.main(argv) == code
    out = capsys.readouterr().out
    assert "plan-audit:" in out
    assert (tmp_path / "audit.json").exists()
