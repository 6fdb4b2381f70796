"""Where a fuzzy-LUT launch spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.fuzzy_lut.breakdown

Builds variants of each kernel design (``csrc/fuzzy_lut_f32.cuh``,
``csrc/fuzzy_lut_q8.cuh``) that stop short of one phase each, and times
every variant in turns with the other design's shipped kernel as control
(control, variant, variant, control), at MLP-B's bucket-4096 shapes (the
widest bank, K=16 N=32, and the fused stack):

  full        the kernel as shipped;
  no_gather   without the LUT gather-sum (staging and descent);
  stage_only  without descent and gather (the trees' copies, the input
              rows; for int8 also the stage table and the LUT's copies);
  empty       no layer at all (the launch; for int8 the stage table and
              the barriers).

Successive differences read as the cost of gather, descent and staging
where a phase does not overlap the next. Prints one line per variant;
needs an NVIDIA GPU and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import _lib
from . import kernel as K
from . import quantized as Q

BUILD = _lib.BUILD_DIR / "breakdown"
# design -> header, {C entry: source}, [(variant, [(text in the header,
# its replacement at every place)])]. The f32 variants keep a use of what
# they skip (a test that never passes) so the compiler keeps the phases
# before it.
DESIGNS = {
    "f32": ("fuzzy_lut_f32.cuh",
            {"fuzzy_lut_f32": "fuzzy_lut_bank.cu",
             "fuzzy_lut_stack_f32": "fuzzy_lut_stack.cu"},
            [("full", []),
             ("no_gather", [("n0 < n_eff;", "n0 < (leaf == -7 ? n_eff : 0);")]),
             ("stage_only", [("d < g.depth;", "d < 0;"),
                             ("n0 < n_eff;", "n0 < (h == 1234.5f ? n_eff : 0);")]),
             ("empty", [("  const int L = g.L;", "  const int L = 0;")])]),
    "q8": ("fuzzy_lut_q8.cuh",
           {"fuzzy_lut_q8": "fuzzy_lut_q8_bank.cu",
            "fuzzy_lut_stack_q8": "fuzzy_lut_q8_stack.cu"},
           [("full", []),
            ("no_gather", [("      if (flags & Q8_GATHER) {", "      if (false) {")]),
            ("stage_only", [("      if (flags & Q8_GATHER) {", "      if (false) {"),
                            ("      if (flags & Q8_DESCENT) {", "      if (false) {")]),
            ("empty", [("  const int total = my_chunks * g.nfills;",
                        "  const int total = 0 * my_chunks;")])]),
}
T, V, DEPTH = 4096, 2, 6
BANK = dict(k=16, n=32)
STACK = dict(ks=(8, 16, 16, 16), nmax=32, n_out=3)


def _build() -> dict:
    """Every variant of every design, compiled in parallel."""
    procs = {}
    for design, (header, sources, variants) in DESIGNS.items():
        base = (_lib.CSRC / header).read_text()
        for name, edits in variants:
            text = base
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{design} {name}: {old!r} not in {header}")
                text = text.replace(old, new)
            out = BUILD / design / name
            out.mkdir(parents=True, exist_ok=True)
            (out / header).write_text(text)
            for fn, src in sources.items():
                (out / src).write_text((_lib.CSRC / src).read_text())
                lib = out / f"{src[:-3]}.so"
                procs[(design, name, fn)] = (lib, subprocess.Popen(
                    [_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(lib), str(out / src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (design, name, fn), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {design} {name}:\n{log}")
        f = getattr(ctypes.CDLL(str(lib)), fn)
        f.argtypes, f.restype = _lib._ARGTYPES[fn], ctypes.c_int
        fns[(design, name, fn)] = f
    return fns


def _q8_launcher(f, fn_name, args, ks, n_out, nmax):
    """A call of ``f`` with the int8 wrapper's own plan and launch shape."""
    dev = args[0].device
    plan = Q.plan_q8(ks, V, DEPTH, max(ks), nmax, n_out, has_bias=len(args) == 6)
    rows, nchunks, grid, threads, smem = Q.launch_shape(plan, T, K._sm_count(dev))
    geom = _lib.Q8Geom(L=len(ks), k0=ks[0], kmax=max(ks), nmax=nmax, n_out=n_out,
                       v=V, depth=DEPTH, width=plan.width, kstride=plan.kstride,
                       rows=rows, nchunks=nchunks, nstages=len(plan.stages),
                       nfills=len(plan.fills), slot_bytes=plan.slot_bytes)
    table = Q._stage_table(plan, dev)
    y = torch.empty((T, n_out), device=dev)

    def run():
        stream = torch.cuda.current_stream(dev).cuda_stream
        _lib.check_status(f(*(a.data_ptr() for a in args), y.data_ptr(), None,
                            table.data_ptr(), T, geom, grid, threads, smem, stream),
                          fn_name)
    return run, y


def _f32_launcher(f, fn_name, args, ks, n_out, nmax):
    """A call of ``f`` with the f32 wrapper's own plan and launch shape."""
    dev = args[0].device
    plan = K.plan_f32(ks, V, DEPTH, max(ks))
    _, grid, threads, smem = K.f32_launch_shape(plan, T, K._sm_count(dev))
    geom = K.f32_geom(plan, ks, ks[0], max(ks), nmax, n_out, V, DEPTH)
    y = torch.empty((T, n_out), device=dev)

    def run():
        stream = torch.cuda.current_stream(dev).cuda_stream
        _lib.check_status(f(*(a.data_ptr() for a in args), y.data_ptr(), None, T, geom,
                            grid, threads, smem, stream), fn_name)
    return run, y


def main() -> int:
    if not torch.cuda.is_available():
        print("breakdown: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[4]))
    import chip_smoke as cs

    dev = torch.device("cuda")
    fns = _build()
    rng = np.random.default_rng(0)
    p = cs.bank_problem(rng, T, BANK["k"], V, DEPTH, BANK["n"], dev)
    q, s = Q.quantize_lut_int8(p["lut"])
    sp = cs.stack_problem(rng, t=T, v=V, depth=DEPTH, device=dev, **STACK)
    qs, sc = cs.quantize_stack(sp["lut"])
    ks, n_out, nmax = STACK["ks"], STACK["n_out"], STACK["nmax"]
    # design -> (bank args, stack args, launcher, C entries)
    cases = {
        "f32": ([p["x"], p["features"], p["thresholds"], p["lut"]],
                [sp["x"], sp["features"], sp["thresholds"], sp["lut"], sp["bias"]],
                _f32_launcher, ("fuzzy_lut_f32", "fuzzy_lut_stack_f32")),
        "q8": ([p["x"], p["features"], p["thresholds"], q, s],
               [sp["x"], sp["features"], sp["thresholds"], qs, sc, sp["bias"]],
               _q8_launcher, ("fuzzy_lut_q8", "fuzzy_lut_stack_q8")),
    }
    want = {
        "f32": (K.fuzzy_lut_plain(*cases["f32"][0])[0],
                K.fuzzy_lut_stack_plain(*cases["f32"][1], ks, n_out)[0]),
        "q8": (Q.fuzzy_lut_q8_plain(*cases["q8"][0])[0],
               Q.fuzzy_lut_stack_q8_plain(*cases["q8"][1], ks, n_out)[0]),
    }

    def runs(design, variant):
        bank, stack, launcher, (fb, fs) = cases[design]
        rb, yb = launcher(fns[(design, variant, fb)], fb, bank, (BANK["k"],),
                          BANK["n"], BANK["n"])
        rs, ys = launcher(fns[(design, variant, fs)], fs, stack, ks, n_out, nmax)
        return rb, yb, rs, ys

    print(f"MLP-B at T={T}: bank K={BANK['k']} N={BANK['n']}, stack ks={ks}; card "
          f"{cs._nvidia_smi()}", flush=True)
    for design, other in (("f32", "q8"), ("q8", "f32")):
        cb, _, cstack, _ = runs(other, "full")
        for name, _ in DESIGNS[design][2]:
            rb, yb, rs, ys = runs(design, name)
            ctl_b, tb = cs.abba_ms(cb, rb)
            ctl_s, ts = cs.abba_ms(cstack, rs)
            exact = ""
            if name == "full":
                rb()
                rs()
                torch.cuda.synchronize()
                exact = (f" (bit-equal to plain: bank {torch.equal(yb, want[design][0])}, "
                         f"stack {torch.equal(ys, want[design][1])})")
            print(f"{design} {name:10s} bank {tb * 1e3:6.2f} us  stack {ts * 1e3:6.2f} us"
                  f"  | {other} control bank {ctl_b * 1e3:6.2f} us  stack "
                  f"{ctl_s * 1e3:6.2f} us{exact}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
