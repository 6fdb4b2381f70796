"""Find the knee of an open-loop cell: the highest offered rate at which the
backlog does not grow over the window and the 95th percentile stays within
the deadline.

    python3 bench/sweep.py --config mlp-b --traffic stream --seed <n> \\
        --seconds 5 --rates 4000,5000,6000,7000,8000,9000,10000,12000

One set-up, then one window per rate, lowest first, each with the cell's
mix at that rate; stops after two rates in a row miss. Prints one JSON line
per rate and a last line with the knee and four fifths of it. Run it on the
card; the rate written into the mix file comes from it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

DEADLINE_MS = 150.0        # examples/serve_batched.py's deadline-bearing client


def outstanding(due, done, t) -> int:
    """Requests due by ``t`` and not yet complete at ``t``."""
    return int(((due <= t) & ~(done <= t)).sum())


def main(argv=None) -> int:
    import numpy as np

    from bench.harness import GRACE_S, WARM_S, Cell, Setup, freeze_setup, log

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rates = [float(r) for r in args.rates.split(",")]
    cell = Cell.of(args.config, args.traffic, mix_overrides={"rate": rates[0]})
    su = Setup(cell, args.seed, args.device)
    warm = su.phase(np.random.default_rng([args.seed, 2]))
    warm.drive(time.perf_counter(), WARM_S)
    warm.wait(GRACE_S)
    freeze_setup()
    knee, misses = None, 0
    for k, rate in enumerate(rates):
        ph = su.phase(np.random.default_rng([args.seed, 10 + k]), mix={**cell.mix, "rate": rate})
        t0 = time.perf_counter()
        ph.drive(t0, args.seconds)
        missing = ph.wait(GRACE_S)
        due, done = ph.log.view("due"), ph.log.view("done")
        lat = (done - due) * 1e3
        lat = np.where(np.isnan(lat), np.inf, lat)
        half = due < t0 + args.seconds / 2
        q = [outstanding(due, done, t0 + f * args.seconds) for f in (0.25, 0.5, 0.75, 1.0)]
        rec = {"rate": rate, "requests": int(len(due)), "missing": missing,
               "p50_ms": float(np.quantile(lat, 0.5)), "p95_ms": float(np.quantile(lat, 0.95)),
               "p95_first_half_ms": float(np.quantile(lat[half], 0.95)),
               "p95_second_half_ms": float(np.quantile(lat[~half], 0.95)),
               "outstanding_at_quarters": q,
               "generator_late_p99_ms": float(np.quantile(ph.log.view("sent") - due, 0.99)) * 1e3}
        growing = (q[-1] > 2 * max(q[0], q[1]) + rate * 0.005
                   or rec["p95_second_half_ms"] > 2 * rec["p95_first_half_ms"] + 5)
        rec["holds"] = bool(not missing and not growing and rec["p95_ms"] <= DEADLINE_MS)
        print(json.dumps(rec), flush=True)
        if rec["holds"]:
            knee, misses = rate, 0
        else:
            misses += 1
            if misses == 2:
                break
    su.close()
    print(json.dumps({"knee": knee, "rate_at_0.8": None if knee is None else 0.8 * knee,
                      "setup_split_s": su.split}), flush=True)
    log(f"sweep: knee {knee}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
