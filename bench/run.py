"""Run one cell of ``BENCHMARK.json`` once, on the machine it starts on.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace 0|1

Prints the set-up split, the check and the numbers compared on standard
error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each number
compared with its limit. Exits non-zero, printing no result, without as
many CUDA devices as the cell asks for, or when a module of JAX or of the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the root, not bench/, is on the path: bench's modules import as bench.*
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    fuzzy-LUT libraries already build into build/kernels/ there)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    from bench.harness import Cell, forbidden_modules, log, run_cell

    chips = Cell(args.workload).chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"bench: the cell needs {chips} CUDA device(s); this machine has {n}")
        return 2
    t_torch = time.perf_counter()
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    result["detail"]["setup_split_s"] = {"python_and_torch_import_s": t_torch - T_START,
                                         **result["detail"]["setup_split_s"]}
    bad = forbidden_modules()
    if bad:
        log(f"bench: the run loaded {bad} (JAX or the JAX package); no result")
        return 3
    detail = result.pop("detail")
    log("bench: " + json.dumps(detail, default=float))
    for key, c in result["check"].items():
        log(f"check {key} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
