"""Dry-run and roofline tables from the dry-run's JSON (port of
``repro.launch.report``), with the H100 meshes' labels and the roofline
priced on the H100 SXM5 datasheet constants (:mod:`.roofline`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.report \\
      --single results_dryrun_single.json [--patch results_dryrun_fix.json] \\
      --multi results_dryrun_multi.json --out roofline_report.md
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_config

from .roofline import format_row, roofline_terms

__all__ = ["load_results", "dryrun_table", "roofline_table", "narrative", "main",
           "SINGLE_LABEL", "MULTI_LABEL"]

SINGLE_LABEL = "32×8 (256 H100s: 32 HGX nodes of 8, \"model\" inside a node's NVLink)"
MULTI_LABEL = "2×32×8 (512 H100s: two 256-card groups over InfiniBand)"


def load_results(single: str, patch: str | None = None) -> dict:
    with open(single) as f:
        rows = json.load(f)
    table = {(r["arch"], r["shape"]): r for r in rows}
    if patch:
        with open(patch) as f:
            for r in json.load(f):
                table[(r["arch"], r["shape"])] = r
    return table


def _terms(arch: str, shape: str, r: dict) -> dict:
    return roofline_terms(get_config(arch), shape, r["collective_total"],
                          collective_by_axis=r.get("collective_by_axis"))


def dryrun_table(results: dict, mesh_label: str) -> list[str]:
    lines = [
        f"### Mesh {mesh_label}",
        "",
        "| arch | shape | trace (s) | FLOPs/dev (local ops) | collective B/dev "
        "| peak bytes/dev | status |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            r = results.get((arch, shape))
            if r is None:
                continue
            if "skipped" in r:
                lines.append(f"| {arch} | {shape} | — | — | — | — | SKIP ({r['skipped'][:40]}…) |")
            elif "error" in r:
                lines.append(f"| {arch} | {shape} | — | — | — | — | **FAIL** {r['error'][:60]} |")
            else:
                pk = r["memory"]["peak_bytes"] / 2**30
                lines.append(
                    f"| {arch} | {shape} | {r['trace_s']} | {r['flops']:.2e} | "
                    f"{r['collective_total']:.2e} | {pk:.1f} GiB | ok |")
    return lines


def roofline_table(results: dict) -> list[str]:
    lines = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
        "dominant | MODEL/HLO | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            r = results.get((arch, shape))
            if r is None or "skipped" in r or "error" in r:
                continue
            lines.append(format_row(arch, shape, _terms(arch, shape, r)))
    return lines


def narrative(results: dict) -> list[str]:
    """One sentence per cell on what would move the dominant term."""
    hints = {
        ("compute", "train"): "more cards / lower remat recompute (dots policy)",
        ("compute", "prefill"): "batch growth amortizes weight gathers; tensor cores already busy",
        ("compute", "decode"): "batch up decode or fuse kernels; compute rarely dominates decode",
        ("memory", "train"): "microbatching + sequence-sharded activations cut HBM traffic",
        ("memory", "prefill"): "chunked attention + bf16 activations",
        ("memory", "decode"): "KV-cache/LUT quantization (int8) halves bytes: the Pegasus lever",
        ("collective", "train"): "overlap FSDP gathers with compute; bf16 grad reduce; "
                                 "bigger per-device batch",
        ("collective", "prefill"): "re-shard activations to cut resharding all-gathers",
        ("collective", "decode"): "replicate small weights instead of gathering per step",
    }
    lines = ["", "Per-cell notes (what moves the dominant term):", ""]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            r = results.get((arch, shape))
            if r is None or "skipped" in r or "error" in r:
                continue
            t = _terms(arch, shape, r)
            kind = SHAPES[shape][2]
            lines.append(f"- **{arch} × {shape}** ({t['dominant']}-bound): "
                         f"{hints[(t['dominant'], kind)]}.")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--single", required=True)
    ap.add_argument("--patch", default=None)
    ap.add_argument("--multi", default=None)
    ap.add_argument("--out", default="roofline_report.md")
    args = ap.parse_args(argv)

    single = load_results(args.single, args.patch)
    out = ["## Dry-run", ""]
    out += dryrun_table(single, SINGLE_LABEL)
    if args.multi:
        out += [""]
        out += dryrun_table(load_results(args.multi), MULTI_LABEL)
    out += ["", "## Roofline (256 H100s, SXM5 datasheet at 700 W)", ""]
    out += roofline_table(single)
    out += narrative(single)
    with open(args.out, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
