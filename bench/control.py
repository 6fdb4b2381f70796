"""The readings that a cell's correctness limit is set from: on each seed,
the widest gap of the program's served logits from the plain reference
(the lower reading), and of the reference computed in bfloat16, put in the
program's place, on the same flows (the control, the upper reading).

    python3 bench/control.py --workload <name> --seeds 1,2,3 --seconds 3

One process, one set-up per seed, a short window at the cell's own load
that checks as many flows as a run does. Prints one JSON line per seed and a
summary line. The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def _cells() -> set:
    return {w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}


def main(argv=None) -> int:
    import numpy as np

    from bench.harness import (CHECK_FLOWS, GRACE_S, WARM_S, Cell, Setup, check_outputs,
                               freeze_setup)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True,
                    help="a cell of BENCHMARK.json, or <config>.<traffic>")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = Cell(args.workload) if args.workload in _cells() else Cell.of(
        *args.workload.split(".", 1))
    gaps, ctls = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        su = Setup(cell, seed, args.device)
        warm = su.phase(np.random.default_rng([seed, 2]))
        warm.drive(time.perf_counter(), WARM_S)
        warm.wait(GRACE_S)
        freeze_setup()
        flows_per_s = warm.log.view("size").sum() / WARM_S
        if cell.mix["type"] == "open":
            flows_per_s = cell.mix["rate"] * float(np.mean(cell.mix["sizes"]))
        ph = su.phase(np.random.default_rng([seed, 1]),
                      keep_p=min(1.0, CHECK_FLOWS / (flows_per_s * args.seconds)))
        ph.drive(time.perf_counter(), args.seconds)
        missing = ph.wait(GRACE_S)
        su.close()
        ok = ph.log.view("ok")
        idx = list(np.flatnonzero(ph.log.view("keep") & ok))
        chk = check_outputs(cell, su.drawn, su.pool, ph.log, idx, su.dev, control=True)
        gaps.append(chk["logit_gap"])
        ctls.append(chk["control_gap"])
        print(json.dumps({"seed": seed, "missing": missing, "failed": int((~ok).sum()), **chk}),
              flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(gaps), "lower": max(gaps),
                      "upper": min(ctls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
