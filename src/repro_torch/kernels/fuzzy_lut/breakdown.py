"""Where an int8 fuzzy-LUT launch spends its time, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.fuzzy_lut.breakdown

Builds variants of ``csrc/fuzzy_lut_q8.cuh`` that stop short of one phase
each, and times every variant with the f32 kernels as control, at MLP-B's
bucket-4096 shapes (the widest bank, K=16 N=32, and the fused stack):

  full        the kernel as shipped;
  no_gather   without the LUT gather-sum (staging and descent);
  stage_only  without descent and gather (the table, the ring's copies,
              the input rows);
  empty       no stage at all (the launch, the stage table, the barriers).

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
# (variant, [(text in the header, its replacement)])
VARIANTS = [
    ("full", []),
    ("no_gather", [("      if (flags & Q8_GATHER) {", "      if (false) {")]),
    ("stage_only", [("      if (flags & Q8_GATHER) {", "      if (false) {"),
                    ("      if (flags & Q8_DESCENT) {", "      if (false) {")]),
    ("empty", [("  const int total = my_chunks * g.nfills;",
                "  const int total = 0 * my_chunks;")]),
]
SOURCES = {"fuzzy_lut_q8": "fuzzy_lut_q8_bank.cu",
           "fuzzy_lut_stack_q8": "fuzzy_lut_q8_stack.cu"}
T, V, DEPTH = 4096, 2, 6
BANK = dict(k=16, n=32)
STACK = dict(ks=(8, 16, 16, 16), nmax=32, n_out=3)


def _build() -> dict:
    header = (_lib.CSRC / "fuzzy_lut_q8.cuh").read_text()
    procs = {}
    for name, edits in VARIANTS:
        text = header
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not found once in the header")
            text = text.replace(old, new)
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "fuzzy_lut_q8.cuh").write_text(text)
        for fn, src in SOURCES.items():
            (out / src).write_text((_lib.CSRC / src).read_text())
            lib = out / f"{src[:-3]}.so"
            procs[(name, fn)] = (lib, subprocess.Popen(
                [_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(lib), str(out / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for (name, fn), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        f = getattr(ctypes.CDLL(str(lib)), fn)
        f.argtypes, f.restype = _lib._ARGTYPES[fn], ctypes.c_int
        fns[(name, fn)] = f
    return fns


def _launcher(f, fn_name, args, ks, n_out, nmax, has_bias):
    """A call of ``f`` with the wrapper's own plan and launch shape."""
    dev = args[0].device
    plan = Q.plan_q8(ks, V, DEPTH, max(ks), nmax, n_out, has_bias=has_bias)
    rows, nchunks, grid, threads, smem = Q.launch_shape(plan, T, dev)
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
    bank = [p["x"], p["features"], p["thresholds"], q, s]
    want_bank = Q.fuzzy_lut_q8_plain(*bank)[0]
    sp = cs.stack_problem(rng, t=T, v=V, depth=DEPTH, device=dev, **STACK)
    qs, sc = cs.quantize_stack(sp["lut"])
    stack = [sp["x"], sp["features"], sp["thresholds"], qs, sc, sp["bias"]]
    want_stack = Q.fuzzy_lut_stack_q8_plain(*stack, STACK["ks"], STACK["n_out"])[0]
    f32_bank = lambda: K.fuzzy_lut(p["x"], p["features"], p["thresholds"], p["lut"])
    f32_stack = lambda: K.fuzzy_lut_stack(sp["x"], sp["features"], sp["thresholds"],
                                          sp["lut"], sp["bias"], ks=STACK["ks"],
                                          n_out=STACK["n_out"])
    print(f"f32 control: bank {cs.device_ms(f32_bank) * 1e3:.2f} us, "
          f"stack {cs.device_ms(f32_stack) * 1e3:.2f} us", flush=True)
    for name, _ in VARIANTS:
        rb, yb = _launcher(fns[(name, "fuzzy_lut_q8")], "fuzzy_lut_q8", bank, (BANK["k"],),
                           BANK["n"], BANK["n"], False)
        rs, ys = _launcher(fns[(name, "fuzzy_lut_stack_q8")], "fuzzy_lut_stack_q8", stack,
                           STACK["ks"], STACK["n_out"], STACK["nmax"], True)
        tb, ts = cs.device_ms(rb), cs.device_ms(rs)
        exact = ""
        if name == "full":
            rb()
            rs()
            torch.cuda.synchronize()
            exact = (f" (bit-equal to plain: bank {torch.equal(yb, want_bank)}, "
                     f"stack {torch.equal(ys, want_stack)})")
        print(f"q8 {name:10s} bank {tb * 1e3:6.2f} us  stack {ts * 1e3:6.2f} us{exact}",
              flush=True)
    print(f"f32 control: bank {cs.device_ms(f32_bank) * 1e3:.2f} us, "
          f"stack {cs.device_ms(f32_stack) * 1e3:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
