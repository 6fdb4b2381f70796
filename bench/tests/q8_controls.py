"""The readings that ``rnn-b-q8``'s correctness limit is held against: the
plain int8 reference (the program's arithmetic, tables as int8 codes) next
to three variants computed on the same flows, each as the widest |variant -
reference| logit over the reference logits' standard deviation, as
``bench/harness.py`` ``check_outputs`` reads the program:

- ``int4``: the drawn tables as int4 codes, one scale a group, max|lut_k| / 7,
  rounded half to even;
- ``f32_tables``: the drawn float32 tables, unquantized;
- ``bfloat16``: the reference with every step in bfloat16, as
  ``bench/control.py`` computes its control.

    python3 bench/tests/q8_controls.py --seeds 1,2,3 [--device cuda]

prints one JSON line a seed (on the seed's drawn flows, before tiling) and a
summary line: each variant's smallest gap over the seeds, and the limit.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def quantize_int4(lut: torch.Tensor) -> torch.Tensor:
    """The table rounded to int4 codes in [-7, 7], one scale a group
    (``max|lut_k| / 7``), given back as the float32 products ``q · s_k``
    that a plain sum adds."""
    scale = torch.clamp(lut.abs().amax(dim=(1, 2)), min=1e-8) / 7.0
    q = torch.clamp(torch.round(lut / scale[:, None, None]), -7, 7)
    return q * scale[:, None, None]


def int4_drawn(drawn: dict) -> dict:
    """A copy of the drawn banks with every table rounded to int4."""
    out = copy.copy(drawn)
    for key in ("x", "h"):
        out[key] = [copy.copy(b) for b in drawn[key]]
    out["out"] = copy.copy(drawn["out"])
    for b in out["x"] + out["h"] + [out["out"]]:
        b.lut = quantize_int4(b.lut)
    return out


def control_gaps(cell, drawn: dict, inputs: tuple, block: int = 1 << 16) -> dict:
    """Each variant's widest gap from the int8 reference on ``inputs``, over
    the int8 reference logits' standard deviation."""
    model, cfg = cell.model, cell.config
    low4 = int4_drawn(drawn)
    variants = {
        "int4": lambda x: model.reference(cfg, low4, x),
        "f32_tables": lambda x: model.reference(cfg, drawn, x),
        "bfloat16": lambda x: model.reference(cfg, drawn, x, dtype=torch.bfloat16),
    }
    gaps = dict.fromkeys(variants, 0.0)
    s1 = s2 = 0.0
    n = 0
    for start in range(0, inputs[0].shape[0], block):
        x = tuple(a[start:start + block] for a in inputs)
        want = model.reference(cfg, drawn, x, int8=True)
        w64 = want.to(torch.float64)
        s1, s2, n = s1 + float(w64.sum()), s2 + float((w64 * w64).sum()), n + w64.numel()
        for name, fn in variants.items():
            d = torch.nan_to_num((fn(x) - want).abs(), nan=float("inf"))
            gaps[name] = max(gaps[name], float(d.max()))
    spread = max((s2 / n - (s1 / n) ** 2) ** 0.5, 1e-30)
    return {name: g / spread for name, g in gaps.items()}


def main(argv=None) -> int:
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench.harness import Cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workload", default="rnn-b-q8.bulk")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = tuple(torch.as_tensor(a, device=args.device)
                       for a in cell.model.flows(cell.config, seed))
        drawn = cell.model.draw(cell.config, inputs, seed)
        rows.append({"seed": seed, "flows": int(inputs[0].shape[0]),
                     **control_gaps(cell, drawn, inputs)})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      **{k: min(r[k] for r in rows) for k in ("int4", "f32_tables", "bfloat16")},
                      "limit": cell.config["check"]["logit_gap"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
