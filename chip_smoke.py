#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # on a machine with an H100
    python3 chip_smoke.py --rehearse   # CPU, tiny sizes, plain versions;
                                       # prints no result line

Phases (any failure exits nonzero; none is caught and passed over):
  1. the device: its name, and its name and power limit from nvidia-smi;
  2. build the four fuzzy-LUT CUDA kernels from the sources in this checkout;
  3. hold each kernel against its plain PyTorch version on the card, at the
     MLP-B shapes at T=4096, at a ragged shape, at T=1 and at wide shapes
     (wider than a shared-memory ring slot or a warp, untimed): leaves
     exact, outputs bit-equal; time both with CUDA events, each f32 kernel
     and its int8 counterpart in turns (f32, int8, int8, f32); then the
     same, timed, at every geometry the other families launch, at the rows
     one served batch of 4096 flows gives it (depth 12 with v=6 at 24,576
     rows, K = 62 and 64 at 32,768 rows, the four-layer AE stack ...);
  4. the main path, as ``python -m repro_torch.launch.serve --pegasus``
     runs it at full size: peerrush traffic (1500 flows/class), the MLP-B
     teacher trained 800 steps on the card, ``pegasusify_mlp`` (v=2,
     depth 6), then ``PegasusServer`` on ``kernel`` and ``kernel_q8``, fused
     and unfused, serving ~32k flows as mixed-size requests; each output is
     held against the ``gather`` backend and the kernels' launch counts must
     show that the path went through them; a ``torch.profiler`` window
     over the fused ``kernel_q8`` run gives device time by kernel name and
     the device's idle share;
  5. the families: RNN, CNN-B, CNN-M (NAM), CNN-L and the AutoEncoder at
     their published widths, each teacher trained on the card for its
     default steps and pegasusified, then served (~32k flows of mixed-size
     requests through ``PegasusServer``) on ``gather``, ``kernel`` and
     ``kernel_q8``: ``kernel`` bit-equal to ``gather``, ``kernel_q8`` within
     the reference's limits, the launch counts per served run exactly those
     of the family's kernels; served macro-F1 beside the teacher's (the AE:
     whole-net error and anomaly AUC); a ``torch.profiler`` window over the
     RNN's ``kernel`` run under its graphs and one run eagerly;
  6. many models at once: every served path of phases 4-5 on ``kernel`` and
     ``kernel_q8`` served through its CUDA graphs and eagerly
     (``jit=False``), in turns, outputs bit-equal; a ``MultiModelServer``
     on each kernel backend holding all six models (MLP-B at priority
     weight 4) drains their interleaved traffic, each model's outputs
     bit-equal to its own ``PegasusServer``'s, no drain error, no fallback,
     the launch counts exactly those of the models' batches; an
     ``AsyncMultiModelServer(devices=1)`` (one stream-pool worker on its
     own CUDA stream) serves the same traffic through futures; three
     injected plan-call failures of the RNN open its breaker, it serves
     degraded on ``gather`` (bit-equal to ``kernel``) and a probe closes
     the breaker again;
  7. refinement: phase 4's MLP-B teacher pegasusified with the reference's
     default ``refine_steps=100`` on the card (timed; each bank's
     ``hard_mse`` before and after; new plans for the refined banks in the
     memo), served as phase 4 serves (``kernel`` bit-equal to ``gather``,
     ``kernel_q8`` within the limits, every kernel launched) and timed in
     turns against phase 4's servers; N3IC and BoS trained and Leo fitted
     beside MLP-B and RNN-B (the paper's Table 5, printed); one 20-step
     refine of CNN-M's depth-12 window bank;
  8. the plan audit and the dataplane: every plan phases 4-7 built on the
     card carries audit counts with no error (its seconds per build
     printed); its PGA103 rows per block and shared bytes equal
     ``f32_launch_shape`` / ``launch_shape`` of the plan's own operands at
     the rows a 4096-flow batch gives each step, on the card's SM count;
     PGA104 flags exactly the int8 plans with byte-wise column tiles (none:
     ``plan_q8`` stages a LUT by bulk copies only). Phase 7's refined MLP-B
     and the AE banks compiled to MAT pipelines (Table 6 rows); MLP-B's integer pipeline run on the card (``run_batch``) over
     the test split and the 32,768-flow tiling — equal to ``run_packet`` on
     the CPU on 256 flows, its flows/s, its argmax agreement with the
     served ``kernel`` outputs and its macro-F1 beside theirs — and the AE
     pipeline over the test split, held to ``run_packet`` the same way;
  9. the LM stack: Qwen2-VL-2B at its published width (28 layers, d_model
     1536, d_ff 8960, vocab 151,936; f32, random weights from a seed) drawn
     on the card; ``make_prefill_step`` over 8 x 1024 tokens (the chunked
     attention path) and ``Server(kv_len=2048, batch_size=8).generate``
     of 32 tokens, tokens/s each; 16 greedy ``decode_step``s held to
     ``forward_train`` (2e-3); a ``torch.profiler`` window over 8 decode
     steps. The last layer's FFN input, captured during the prefill by a
     forward hook, calibrates ``pegasusify_ffn_layer`` (v=4, depth 4, bf16
     LUT; fit seconds printed); ``pegasus_ffn_apply`` on gather, kernel and
     kernel_q8 over 8 and 8,192 rows: every bank launch bit-equal to its
     plain version, the FFN on kernel within 1e-4 of gather over the LUT
     upcast to f32, kernel_q8 under 0.12 per bank, one launch per bank per
     FFN call; each bank geometry timed (f32 and int8 in turns) beside its
     bound, its plain version and the dense product it replaces; then the
     nine other architectures at ``smoke_config`` on the card against the
     port's own CPU run (1e-4);
 10. the LM training path: Qwen2-VL-2B at its published width in f32
     (1.544 B parameters, no TF32) trained 6 steps of 8 x 1024 tokens
     through ``TrainLoop`` with the reference's default remat
     (``"nothing"``): loss and grad_norm per step (finite), seconds per
     step, tokens/s, 6·N·T per second against the f32 peak, peak memory, a
     ``torch.profiler`` window over one more step; the same width cut to 2
     layers, two train steps at a constant learning rate on the card
     against the CPU (loss, grad_norm, every gradient, m, v and the change
     of every parameter within the limits of ``TRAIN_*``), and, at 8 x 1024
     tokens, remat ``"nothing"``/``"dots"``/none against each other with
     the peak memory each adds; the reference's crash-recovery test on
     ``smoke_config``; an ``AsyncCheckpointer`` save and a
     ``restore`` of the 2-layer state (bit-equal; bytes and seconds); the
     nine other architectures at ``smoke_config``, 2 train steps on the
     card against the CPU;
 11. the mesh: (a) the six served models of phases 4-5 with their plans
     built over 4 row shards on the card (``build_plan(devices=("cuda:0",)
     * 4)``): outputs on kernel and kernel_q8 bit-equal to the
     single-device plan's at the 37 requests and at a ragged batch, the
     launches exactly four shards' worth, flows/s of both in turns; (b)
     ``Server`` on a (1, 1) mesh (a one-rank NCCL group: NCCL takes one rank
     per GPU, so the card measures DTensor's host cost, not scaling) for
     Qwen2-VL-2B at its published width, tokens identical to the unsharded
     ``Server``'s, tokens/s of both in turns and the idle share over 8
     meshed decode steps; (c) ``TrainLoop`` on that mesh against the
     unsharded loop, 3 steps of 8 x 1024 tokens: losses within 1e-6
     relative, s/step and peak memory of both; (d) the dry-run of
     Qwen2-VL-2B's train_4k, prefill_32k and decode_32k on the 256-rank
     production mesh over a fake process group, plain, then train_4k at 8
     microbatches and prefill/decode with ``optimized=True``: trace
     seconds, FLOPs per device beside ``analytic_cell``'s, collective bytes
     by kind and axis, peak bytes per device, the roofline terms and bound
     on the H100 constants; the run fails when a rank's train_4k FLOPs at
     8 microbatches exceed 1.1x those at 1;
 12. the example scripts (``examples/torch``) in process at the reference
     scripts' sizes: quickstart (MLP-B trained, refined, compiled to the
     MAT pipeline, served), anomaly_detection (the AE's AUCs), serve_batched
     (the three teachers once, then gather, kernel and kernel_q8 each sync
     and async, and async on kernel with a 150 ms deadline: ``kernel``
     bit-equal to ``gather``, ``kernel_q8`` bit-equal to the same flavour
     served with the int8 kernels' plain versions in their place, all four
     kernels launched, no fallback batch)
     and train_distributed twice into one checkpoint directory (the second
     run resumes and ends at twice the steps); wall seconds, macro-F1s,
     AUCs, the integer agreement and flows/s per backend and flavour;
 13. a ``{"kernels": [...]}`` line, then the device line as the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# (name, C entry, source, the Pallas kernel it replaces)
KERNELS = [
    ("fuzzy_lut", "src/repro_torch/kernels/fuzzy_lut/csrc/fuzzy_lut_bank.cu",
     "src/repro/kernels/fuzzy_lut/kernel.py:232"),
    ("fuzzy_lut_q8", "src/repro_torch/kernels/fuzzy_lut/csrc/fuzzy_lut_q8_bank.cu",
     "src/repro/kernels/fuzzy_lut/quantized.py:81"),
    ("fuzzy_lut_stack", "src/repro_torch/kernels/fuzzy_lut/csrc/fuzzy_lut_stack.cu",
     "src/repro/kernels/fuzzy_lut/kernel.py:334"),
    ("fuzzy_lut_stack_q8", "src/repro_torch/kernels/fuzzy_lut/csrc/fuzzy_lut_q8_stack.cu",
     "src/repro/kernels/fuzzy_lut/quantized.py:125"),
]

# H100 SXM data-sheet peaks: HBM bytes/s and f32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

Q8_BANK_REL, Q8_AGREE = 0.12, 0.75

# MLP-B at its published Pegasus geometry: v=2, depth 6, hidden 32, 3 classes
MLPB_BANKS = [(8, 32), (16, 32), (16, 32), (16, 3)]       # (K, N) per bank
MLPB_STACK = dict(ks=(8, 16, 16, 16), v=2, depth=6, nmax=32, n_out=3)
RAGGED_BANK = dict(t=1000, k=13, v=4, depth=5, n=70)
RAGGED_STACK = dict(t=1000, ks=(13, 9, 5), v=4, depth=5, nmax=70, n_out=70)
T1_BANK = dict(t=1, k=3, v=2, depth=1, n=1)
T1_STACK = dict(t=1, ks=(3, 1), v=1, depth=1, nmax=3, n_out=1)
# untimed: wider than an int8 ring slot (column tiles) and than a warp (N
# in chunks of 32), and a bank whose trees and LUT exceed a slot (read
# through L1; its f32 leaves kept in shared memory)
WIDE_BANKS = [dict(t=300, k=16, v=2, depth=6, n=2048), dict(t=200, k=256, v=2, depth=6, n=40)]
WIDE_STACK = dict(t=300, ks=(16, 16), v=2, depth=6, nmax=1024, n_out=1024)
REQUEST_SIZES = (1, 7, 64, 300, 1000, 2500, 4096, 33)

# Every geometry the other families launch, at the rows one served batch of
# 4096 flows gives it, as (t, k, v, depth, n): the RNN's x, h and out banks;
# the CNN-B and CNN-M window banks (6 windows per flow, depth 12, v=6); the
# CNN-L encoder banks (8 packets per flow, K = 62 and 64, wider than a warp)
FAMILY_BANKS = {"rnn-x": (4096, 2, 1, 8, 24), "rnn-h": (4096, 24, 1, 8, 24),
                "rnn-out": (4096, 24, 1, 8, 3), "cnn-b-window": (24576, 1, 6, 12, 16),
                "cnn-m-window": (24576, 1, 6, 12, 3), "cnn-l-b1": (32768, 62, 1, 8, 64),
                "cnn-l-b2": (32768, 64, 1, 8, 16)}
# the CNN-B head pair and the AE's four-layer stack (trees through L1)
FAMILY_STACKS = {"cnn-b-heads": dict(t=4096, ks=(16, 24), v=1, depth=8, nmax=24, n_out=3),
                 "ae": dict(t=4096, ks=(24, 12, 3, 12), v=1, depth=8, nmax=24, n_out=24)}
# The families at their published widths (the reference nets' defaults):
# teacher steps, and the launches one served batch makes on ``kernel``
# (``kernel_q8`` launches the int8 instance of each)
FAMILIES = {"rnn": dict(steps=900, per_batch={"fuzzy_lut": 16}),
            "cnn_b": dict(steps=900, per_batch={"fuzzy_lut": 1, "fuzzy_lut_stack": 1}),
            "cnn_m": dict(steps=900, per_batch={"fuzzy_lut": 1}),
            "cnn_l": dict(steps=1000, per_batch={"fuzzy_lut": 2}),
            "ae": dict(steps=400, per_batch={"fuzzy_lut_stack": 1})}
Q8_NAME = {"fuzzy_lut": "fuzzy_lut_q8", "fuzzy_lut_stack": "fuzzy_lut_stack_q8"}


def _setup_path() -> None:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke.py: the port's sources are missing under {SRC}")
    sys.path.insert(0, str(SRC))


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Problems, bounds and timing
# ---------------------------------------------------------------------------


def bank_problem(rng, t, k, v, depth, n, device):
    import numpy as np
    import torch

    i = 2**depth - 1
    thr = rng.normal(size=(k, i)).astype(np.float32)
    thr[rng.random(size=thr.shape) < 0.05] = np.inf      # degenerate nodes
    arrays = dict(
        x=rng.normal(size=(t, k, v)).astype(np.float32),
        features=rng.integers(0, v, size=(k, i)).astype(np.int32),
        thresholds=thr,
        lut=rng.normal(size=(k, i + 1, n)).astype(np.float32))
    return {key: torch.as_tensor(a, device=device) for key, a in arrays.items()}


def stack_problem(rng, t, ks, v, depth, nmax, n_out, device):
    """Padded stacks: groups k >= ks[l] hold +inf thresholds and zero rows."""
    import numpy as np
    import torch

    nl, kmax, c = len(ks), max(ks), 2**depth
    feats = np.zeros((nl, kmax, c - 1), np.int32)
    thr = np.full((nl, kmax, c - 1), np.inf, np.float32)
    lut = np.zeros((nl, kmax, c, nmax), np.float32)
    bias = np.zeros((nl, nmax), np.float32)
    for l, k in enumerate(ks):
        n = n_out if l == nl - 1 else ks[l + 1] * v
        feats[l, :k] = rng.integers(0, v, size=(k, c - 1))
        thr[l, :k] = rng.normal(size=(k, c - 1))
        lut[l, :k, :, :n] = rng.normal(size=(k, c, n)) * 0.3
        bias[l, :n] = rng.normal(size=n) * 0.1
    arrays = dict(x=rng.normal(size=(t, ks[0], v)).astype(np.float32),
                  features=feats, thresholds=thr, lut=lut, bias=bias)
    return {key: torch.as_tensor(a, device=device) for key, a in arrays.items()}


def _rows_touched(leaves, c) -> int:
    """Distinct (group, leaf) LUT rows this run's data reads."""
    import torch

    k = leaves.shape[-1]
    flat = leaves.reshape(-1, k).long() + torch.arange(k, device=leaves.device) * c
    return int(torch.unique(flat).numel())


def bank_bound(p, leaves, q8: bool):
    """(bytes, ops) the per-bank function needs on these inputs."""
    t, k, v = p["x"].shape
    i = p["features"].shape[1]
    n = p["lut"].shape[2]
    nbytes = (4 * t * k * v + 8 * k * i + _rows_touched(leaves, i + 1) * n * (1 if q8 else 4)
              + (4 * k if q8 else 0) + 4 * t * n)
    depth = (i + 1).bit_length() - 1
    ops = t * k * depth + t * k * n * (2 if q8 else 1)
    return nbytes, ops


def stack_bound(p, leaves, ks, n_out, q8: bool):
    t, k0, v = p["x"].shape
    c = p["lut"].shape[2]
    depth = c.bit_length() - 1
    nbytes, ops = 4 * t * k0 * v + 4 * t * n_out, 0
    for l, k in enumerate(ks):
        n_eff = n_out if l == len(ks) - 1 else ks[l + 1] * v
        rows = _rows_touched(leaves[l, :, :k], c)
        nbytes += 8 * k * (c - 1) + rows * n_eff * (1 if q8 else 4) + 4 * n_eff + (4 * k if q8 else 0)
        ops += t * k * depth + t * k * n_eff * (2 if q8 else 1) + t * n_eff
    return nbytes, ops


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def device_ms(fn, inner: int = 20, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call: ``inner`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events (the host's
    per-call overhead is not in it), after ``warmup`` eager calls."""
    import numpy as np
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def _compare(name, shape_tag, got_y, got_leaves, want_y, want_leaves):
    """Leaves exact and outputs bit-equal: every kernel sums in the plain
    version's order."""
    import torch

    if not torch.equal(got_leaves.long(), want_leaves.long()):
        bad = int((got_leaves.long() != want_leaves.long()).sum())
        raise AssertionError(f"{name} {shape_tag}: {bad} leaves differ from the plain version")
    err = float((got_y - want_y).abs().max()) if got_y.numel() else 0.0
    if not torch.equal(got_y, want_y):
        raise AssertionError(f"{name} {shape_tag}: not bit-equal to the plain version "
                             f"(max |kernel - plain| {err})")
    return err


def abba_ms(fn_a, fn_b, **kw) -> tuple[float, float]:
    """Device times of ``fn_a`` and ``fn_b`` taken in turns a, b, b, a
    (``kw`` goes to :func:`device_ms`)."""
    a1, b1, b2, a2 = (device_ms(fn_a, **kw), device_ms(fn_b, **kw), device_ms(fn_b, **kw),
                      device_ms(fn_a, **kw))
    return (a1 + a2) / 2, (b1 + b2) / 2


def check_kernels(device, *, t: int = 4096, time_it: bool = True) -> dict:
    """Each kernel vs its plain version at the MLP-B shapes (batch ``t``), at
    a ragged shape, at T=1 and at the wide shapes. Returns per-kernel max
    error, times and bound; the per-bank kernels' numbers sum over the four
    MLP-B banks (one served batch on the unfused path, ``timed_launches``
    launches). Each f32 kernel is timed in turns with its int8
    counterpart."""
    import numpy as np

    from repro_torch.kernels.fuzzy_lut import kernel as K
    from repro_torch.kernels.fuzzy_lut import quantized as Q

    rng = np.random.default_rng(0)
    out = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                      nbytes=0, ops=0, timed_launches=0) for name, _, _ in KERNELS}

    def record(name, err, nbytes, ops, ms=None, plain=None):
        rec = out[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if nbytes is None:
            return
        rec["nbytes"] += nbytes
        rec["ops"] += ops
        rec["timed_launches"] += 1
        if time_it:
            rec["ms"] += ms
            rec["plain_ms"] += device_ms(plain)

    def check_bank(shape, timed):
        p = bank_problem(rng, device=device, **shape)
        tag = f"T={shape['t']} K={shape['k']} v={shape['v']} d={shape['depth']} N={shape['n']}"
        x, f, th, lut = p["x"], p["features"], p["thresholds"], p["lut"]
        q, s = Q.quantize_lut_int8(lut)
        run32 = lambda: K.fuzzy_lut(x, f, th, lut)
        run8 = lambda: Q.fuzzy_lut_q8(x, f, th, q, s)
        ms32, ms8 = abba_ms(run32, run8) if timed and time_it else (None, None)
        y, lv = K.fuzzy_lut(x, f, th, lut, return_leaves=True)
        wy, wl = K.fuzzy_lut_plain(x, f, th, lut)
        err = _compare("fuzzy_lut", tag, y, lv, wy, wl)
        nb, ops = bank_bound(p, wl, q8=False)
        record("fuzzy_lut", err, nb if timed else None, ops, ms32,
               lambda: K.fuzzy_lut_plain(x, f, th, lut))
        y, lv = Q.fuzzy_lut_q8(x, f, th, q, s, return_leaves=True)
        wy, wl = Q.fuzzy_lut_q8_plain(x, f, th, q, s)
        err = _compare("fuzzy_lut_q8", tag, y, lv, wy, wl)
        nb, ops = bank_bound(p, wl, q8=True)
        record("fuzzy_lut_q8", err, nb if timed else None, ops, ms8,
               lambda: Q.fuzzy_lut_q8_plain(x, f, th, q, s))
        log(f"  checked per-bank kernels at {tag}")

    def check_stack(shape, timed):
        ks, n_out = shape["ks"], shape["n_out"]
        p = stack_problem(rng, device=device, **shape)
        tag = f"T={shape['t']} ks={ks} v={shape['v']} d={shape['depth']} Nmax={shape['nmax']}"
        x, f, th, lut, b = (p[k] for k in ("x", "features", "thresholds", "lut", "bias"))
        qs, sc = quantize_stack(lut)
        run32 = lambda: K.fuzzy_lut_stack(x, f, th, lut, b, ks=ks, n_out=n_out)
        run8 = lambda: Q.fuzzy_lut_stack_q8(x, f, th, qs, sc, b, ks=ks, n_out=n_out)
        ms32, ms8 = abba_ms(run32, run8) if timed and time_it else (None, None)
        y, lv = K.fuzzy_lut_stack(x, f, th, lut, b, ks=ks, n_out=n_out, return_leaves=True)
        wy, wl = K.fuzzy_lut_stack_plain(x, f, th, lut, b, ks, n_out)
        err = _compare("fuzzy_lut_stack", tag, y, lv, wy, wl)
        nb, ops = stack_bound(p, wl, ks, n_out, q8=False)
        record("fuzzy_lut_stack", err, nb if timed else None, ops, ms32,
               lambda: K.fuzzy_lut_stack_plain(x, f, th, lut, b, ks, n_out))
        y, lv = Q.fuzzy_lut_stack_q8(x, f, th, qs, sc, b, ks=ks, n_out=n_out,
                                     return_leaves=True)
        wy, wl = Q.fuzzy_lut_stack_q8_plain(x, f, th, qs, sc, b, ks, n_out)
        err = _compare("fuzzy_lut_stack_q8", tag, y, lv, wy, wl)
        nb, ops = stack_bound(p, wl, ks, n_out, q8=True)
        record("fuzzy_lut_stack_q8", err, nb if timed else None, ops, ms8,
               lambda: Q.fuzzy_lut_stack_q8_plain(x, f, th, qs, sc, b, ks, n_out))
        log(f"  checked stacked kernels at {tag}")

    for k, n in MLPB_BANKS:
        check_bank(dict(t=t, k=k, v=2, depth=6, n=n), True)
    check_bank(RAGGED_BANK, False)
    check_bank(T1_BANK, False)
    for shape in WIDE_BANKS:
        check_bank(shape, False)
    check_stack(dict(t=t, **MLPB_STACK), True)
    check_stack(RAGGED_STACK, False)
    check_stack(T1_STACK, False)
    check_stack(WIDE_STACK, False)

    for rec in out.values():
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["nbytes"], rec["ops"])
    return out


def check_family_kernels(device, *, rows: int | None = None, time_it: bool = True) -> list:
    """Each kernel against its plain version at every family geometry
    (``rows`` overrides the row count, for the rehearsal): leaves exact,
    outputs bit-equal; each f32 kernel timed in turns with its int8
    counterpart and the plain versions once, each beside its bound.
    Returns one record per (geometry, kernel)."""
    import numpy as np

    from repro_torch.kernels.fuzzy_lut import kernel as K
    from repro_torch.kernels.fuzzy_lut import quantized as Q

    rng = np.random.default_rng(1)
    recs = []

    def add(geom, name, err, nbytes, ops, ms, plain):
        rec = dict(geom=geom, kernel=name, max_abs_err=err, nbytes=nbytes, ops=ops)
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
        if time_it:
            rec.update(ms=ms, plain_ms=device_ms(plain, inner=3, reps=5))
        recs.append(rec)

    for geom, (t, k, v, depth, n) in FAMILY_BANKS.items():
        p = bank_problem(rng, rows or t, k, v, depth, n, device)
        x, f, th, lut = p["x"], p["features"], p["thresholds"], p["lut"]
        q, s = Q.quantize_lut_int8(lut)
        tag = f"{geom} T={x.shape[0]} K={k} v={v} d={depth} N={n}"
        ms32, ms8 = (abba_ms(lambda: K.fuzzy_lut(x, f, th, lut),
                             lambda: Q.fuzzy_lut_q8(x, f, th, q, s))
                     if time_it else (None, None))
        y, lv = K.fuzzy_lut(x, f, th, lut, return_leaves=True)
        wy, wl = K.fuzzy_lut_plain(x, f, th, lut)
        err = _compare("fuzzy_lut", tag, y, lv, wy, wl)
        add(geom, "fuzzy_lut", err, *bank_bound(p, wl, q8=False), ms32,
            lambda: K.fuzzy_lut_plain(x, f, th, lut))
        y, lv = Q.fuzzy_lut_q8(x, f, th, q, s, return_leaves=True)
        wy, wl = Q.fuzzy_lut_q8_plain(x, f, th, q, s)
        err = _compare("fuzzy_lut_q8", tag, y, lv, wy, wl)
        add(geom, "fuzzy_lut_q8", err, *bank_bound(p, wl, q8=True), ms8,
            lambda: Q.fuzzy_lut_q8_plain(x, f, th, q, s))
        log(f"  checked per-bank kernels at {tag}")
    for geom, shape in FAMILY_STACKS.items():
        shape = dict(shape, t=rows or shape["t"])
        ks, n_out = shape["ks"], shape["n_out"]
        p = stack_problem(rng, device=device, **shape)
        x, f, th, lut, b = (p[k] for k in ("x", "features", "thresholds", "lut", "bias"))
        qs, sc = quantize_stack(lut)
        tag = f"{geom} T={shape['t']} ks={ks} v={shape['v']} d={shape['depth']}"
        ms32, ms8 = (abba_ms(
            lambda: K.fuzzy_lut_stack(x, f, th, lut, b, ks=ks, n_out=n_out),
            lambda: Q.fuzzy_lut_stack_q8(x, f, th, qs, sc, b, ks=ks, n_out=n_out))
            if time_it else (None, None))
        y, lv = K.fuzzy_lut_stack(x, f, th, lut, b, ks=ks, n_out=n_out, return_leaves=True)
        wy, wl = K.fuzzy_lut_stack_plain(x, f, th, lut, b, ks, n_out)
        err = _compare("fuzzy_lut_stack", tag, y, lv, wy, wl)
        add(geom, "fuzzy_lut_stack", err, *stack_bound(p, wl, ks, n_out, q8=False), ms32,
            lambda: K.fuzzy_lut_stack_plain(x, f, th, lut, b, ks, n_out))
        y, lv = Q.fuzzy_lut_stack_q8(x, f, th, qs, sc, b, ks=ks, n_out=n_out,
                                     return_leaves=True)
        wy, wl = Q.fuzzy_lut_stack_q8_plain(x, f, th, qs, sc, b, ks, n_out)
        err = _compare("fuzzy_lut_stack_q8", tag, y, lv, wy, wl)
        add(geom, "fuzzy_lut_stack_q8", err, *stack_bound(p, wl, ks, n_out, q8=True), ms8,
            lambda: Q.fuzzy_lut_stack_q8_plain(x, f, th, qs, sc, b, ks, n_out))
        log(f"  checked stacked kernels at {tag}")
    return recs


def quantize_stack(lut):
    """Per-(layer, group) int8 codes and scales of a ``[L, Kmax, C, Nmax]``
    stack (all-zero padded groups get codes 0 and the 1e-8/127 floor
    scale)."""
    from repro_torch.kernels.fuzzy_lut.quantized import quantize_lut_int8

    nl, kmax, c, nmax = lut.shape
    q, s = quantize_lut_int8(lut.reshape(nl * kmax, c, nmax))
    return q.reshape(lut.shape).contiguous(), s.reshape(nl, kmax).contiguous()


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def main_path(device, *, flows_per_class: int = 1500, steps: int = 800,
              depth: int = 6, n_serve: int = 32768) -> dict:
    """Train, pegasusify and serve MLP-B on ``device`` through the port's
    entry points; hold every kernel backend against ``gather``."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic_traffic import make_dataset
    from repro_torch.nets.common import macro_f1
    from repro_torch.nets.mlp import mlp_apply, pegasusify_mlp, train_mlp

    ds = make_dataset("peerrush", flows_per_class=flows_per_class)
    t0 = time.perf_counter()
    mlp = train_mlp(ds.train["stats"], ds.train["label"], ds.num_classes,
                    steps=steps, device=device)
    _sync(device)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    banks = pegasusify_mlp(mlp, ds.train["stats"].astype(np.float32), depth=depth,
                           refine_steps=0)
    peg_s = time.perf_counter() - t0
    log(f"  trained MLP-B {steps} steps in {train_s:.2f} s, pegasusified "
        f"{[(b.num_groups, b.out_features) for b in banks]} (K, N) banks at "
        f"depth {depth} in {peg_s:.2f} s")

    requests, (x,) = _requests("mlp-b", (ds.test["stats"].astype(np.float32),), n_serve)
    y = np.tile(ds.test["label"], -(-n_serve // len(ds.test["label"])))[:n_serve]
    with torch.no_grad():
        teacher = mlp_apply(mlp, torch.as_tensor(x, device=device)).argmax(-1).cpu().numpy()
    res = dict(teacher_f1=macro_f1(teacher, y, ds.num_classes), requests=len(requests),
               flows=n_serve, train_s=train_s, peg_s=peg_s, model=banks,
               request_list=requests, teacher=mlp, ds=ds, depth=depth, x=x, y=y)
    res.update(serve_mlp(banks, requests, x, y, ds.num_classes, device))
    if device.type == "cuda":
        res["profile"] = profile_window(res["runs"][("kernel_q8", True)]["server"], requests)
    return res


def serve_mlp(banks, requests, x, y, num_classes: int, device) -> dict:
    """Serve MLP-B ``banks`` through ``PegasusServer`` on gather, kernel and
    kernel_q8, fused and unfused: ``kernel`` bit-equal to ``gather``,
    ``kernel_q8`` within the reference's limits, and on the card each
    kernel run launching only its own kernel. Returns the runs and the
    launches of the timed runs."""
    import numpy as np
    import torch

    from repro_torch.kernels.fuzzy_lut import _lib
    from repro_torch.launch.serve import PegasusServer
    from repro_torch.nets.common import macro_f1

    n_serve = len(x)
    runs, launches = {}, dict.fromkeys(_lib.LAUNCHES, 0)
    for backend, fuse in (("gather", True), ("kernel", True), ("kernel_q8", True),
                          ("kernel", False), ("kernel_q8", False)):
        server = PegasusServer(banks, backend=backend, fuse=fuse, device=device)
        server.serve(requests)                       # first use of every bucket
        _sync(device)
        _lib.reset_launches()
        t0 = time.perf_counter()
        results = server.serve(requests)
        _sync(device)
        dt = time.perf_counter() - t0
        run_launches = dict(_lib.LAUNCHES)
        for k, n in run_launches.items():
            launches[k] += n
        out = np.concatenate([r.output for r in results])
        if out.shape != (n_serve, num_classes) or not np.isfinite(out).all():
            raise AssertionError(f"{backend}: output {out.shape} not finite of the expected shape")
        st = server.stats()
        runs[(backend, fuse)] = dict(
            out=out, flows_per_s=n_serve / dt, launches=run_launches,
            f1=macro_f1(out.argmax(-1), y, num_classes),
            batches=st["serving"]["batches_run"] // 2, server=server)
        log(f"  served {len(requests)} requests ({n_serve} flows, "
            f"{runs[(backend, fuse)]['batches']} batches) on {backend} "
            f"fuse={fuse}: {n_serve / dt:.1f} flows/s, launches {run_launches}")

    ref = runs[("gather", True)]["out"]
    for fuse in (True, False):
        run = runs[("kernel", fuse)]
        run["max_abs_err"] = float(np.abs(run["out"] - ref).max())
        if not np.array_equal(run["out"], ref):
            raise AssertionError(f"kernel fuse={fuse}: not bit-equal to gather "
                                 f"(max |kernel - gather| {run['max_abs_err']})")
        run = runs[("kernel_q8", fuse)]
        plan = run["server"].plan
        rels = []
        for bank, xb in zip(plan.banks, plan.bank_inputs(x)):
            yg = bank.apply(xb, "gather")
            yq = bank.apply(xb, "kernel_q8")
            rels.append(float(torch.linalg.norm(yq - yg) / max(float(torch.linalg.norm(yg)), 1e-6)))
        run["bank_rel"] = rels
        run["agree"] = float((run["out"].argmax(-1) == ref.argmax(-1)).mean())
        run["max_abs_err"] = float(np.abs(run["out"] - ref).max())
        if max(rels) >= Q8_BANK_REL or run["agree"] < Q8_AGREE:
            raise AssertionError(f"kernel_q8 fuse={fuse}: per-bank rel {rels} "
                                 f"(< {Q8_BANK_REL}), agreement {run['agree']} (>= {Q8_AGREE})")
        log(f"  kernel fuse={fuse}: max |kernel - gather| = "
            f"{runs[('kernel', fuse)]['max_abs_err']}; kernel_q8: per-bank "
            f"rel err {['%.4f' % r for r in rels]}, argmax agreement {run['agree']:.4f}")

    if device.type == "cuda":
        expect = {("kernel", True): "fuzzy_lut_stack", ("kernel_q8", True): "fuzzy_lut_stack_q8",
                  ("kernel", False): "fuzzy_lut", ("kernel_q8", False): "fuzzy_lut_q8"}
        for key, name in expect.items():
            got = runs[key]["launches"]
            if got[name] == 0 or sum(got.values()) != got[name]:
                raise AssertionError(f"{key}: launches {got}; expected only {name}")
    return dict(runs=runs, launches=launches)


def _requests(model: str, arrays: tuple, n_serve: int) -> tuple[list, tuple]:
    """``n_serve`` flows of ``arrays`` (each tiled along axis 0) as
    mixed-size requests; returns the requests and the tiled arrays."""
    import numpy as np

    from repro_torch.launch.serve import InferRequest

    reps = -(-n_serve // len(arrays[0]))
    tiled = tuple(np.concatenate([a] * reps)[:n_serve] for a in arrays)
    requests, start, i = [], 0, 0
    while start < n_serve:
        size = min(REQUEST_SIZES[i % len(REQUEST_SIZES)], n_serve - start)
        part = tuple(a[start : start + size] for a in tiled)
        requests.append(InferRequest(model, part if len(part) > 1 else part[0]))
        start, i = start + size, i + 1
    return requests, tiled


def _pegasusified(name, ds, device, *, steps: int, tiny: bool):
    """Train ``name``'s teacher on ``device`` and pegasusify it at the
    family's published widths (tiny depths for the rehearsal). Returns the
    model, the teacher's forward over the served inputs (the AE: the
    teacher itself), the inputs of the test split and the teacher."""
    import numpy as np

    from repro_torch.nets import autoencoder as ae
    from repro_torch.nets import cnn, rnn

    tr, te, nc = ds.train, ds.test, ds.num_classes
    if name == "rnn":
        m = rnn.train_rnn(tr["seq"], tr["label"], nc, steps=steps, device=device)
        peg = rnn.pegasusify_rnn(m, tr["seq"], depth=3 if tiny else 8)
        return peg, lambda x: rnn.rnn_apply(m.params, x), (te["seq"],), m
    if name in ("cnn_b", "cnn_m"):
        m = cnn.train_cnn(tr["seq"], tr["label"], nc, size=name[-1].upper(), steps=steps,
                          device=device)
        peg = cnn.pegasusify_cnn(m, tr["seq"], depth=4 if tiny else 12)
        return peg, lambda x: cnn.cnn_apply(m, x), (te["seq"],), m
    if name == "cnn_l":
        m = cnn.train_cnn_l(tr["seq"], tr["bytes"], tr["label"], nc, steps=steps,
                            device=device)
        peg = cnn.pegasusify_cnn_l(m, tr["seq"], tr["bytes"], enc_depth=3 if tiny else 8,
                                   index_bits=3 if tiny else 8)
        return peg, lambda s, p: cnn.cnn_l_apply(m, s, p), (te["seq"], te["bytes"]), m
    x = tr["seq"].reshape(len(tr["label"]), -1)
    m = ae.train_autoencoder(x, steps=steps, device=device)
    banks = ae.pegasusify_ae(m, x.astype(np.float32), depth=3 if tiny else 8)
    feats = ae.anomaly_features(te["seq"].reshape(len(te["label"]), -1)).numpy()
    return banks, m, (feats,), m


def _ae_aucs(ds, teacher, banks, device) -> dict:
    """Anomaly AUC (malware, dos) of the teacher and of each backend
    through ``pegasus_ae_error``."""
    import torch

    from repro_torch.data.synthetic_traffic import anomaly_testset
    from repro_torch.nets import autoencoder as ae

    out = {}
    for kind in ("malware", "dos"):
        test = anomaly_testset(ds, kind=kind)
        x = test["seq"].reshape(len(test["label"]), -1)
        with torch.no_grad():
            scores = {"teacher": ae.reconstruction_error(teacher, x)}
            for be in ("gather", "kernel", "kernel_q8"):
                scores[be] = ae.pegasus_ae_error(banks, x, backend=be, device=device)
        for who, sc in scores.items():
            out[(kind, who)] = ae.auc_score(sc.cpu().numpy(), test["label"])
    return out


def family_path(name, ds, device, *, steps: int, tiny: bool = False,
                n_serve: int = 32768) -> dict:
    """One family through the port's entry points: train, pegasusify and
    serve ``n_serve`` flows as mixed-size requests on gather, kernel and
    kernel_q8; ``kernel`` must equal ``gather`` bit for bit, ``kernel_q8``
    stay within the reference's limits, and the launch counts show which
    kernels each served run went through."""
    import numpy as np
    import torch

    from repro_torch.engine import bucket_chunks
    from repro_torch.kernels.fuzzy_lut import _lib
    from repro_torch.launch.serve import PegasusServer
    from repro_torch.nets.common import macro_f1

    t0 = time.perf_counter()
    model, teacher, inputs, trained = _pegasusified(name, ds, device, steps=steps, tiny=tiny)
    _sync(device)
    build_s = time.perf_counter() - t0
    requests, tiled = _requests(name, inputs, n_serve)
    y = np.tile(ds.test["label"], -(-n_serve // len(ds.test["label"])))[:n_serve]
    res = dict(build_s=build_s, runs={}, requests=len(requests), model=model,
               request_list=requests, teacher=trained, ds=ds, inputs=tiled)
    if name != "ae":
        with torch.no_grad():
            logits = teacher(*(torch.as_tensor(a, device=device) for a in tiled))
        res["teacher_f1"] = macro_f1(logits.argmax(-1).cpu().numpy(), y, ds.num_classes)
    launches = dict.fromkeys(_lib.LAUNCHES, 0)
    for backend in ("gather", "kernel", "kernel_q8"):
        server = PegasusServer(model, backend=backend, device=device)
        server.serve(requests)                       # first use of every bucket
        _sync(device)
        _lib.reset_launches()
        t0 = time.perf_counter()
        results = server.serve(requests)
        _sync(device)
        dt = time.perf_counter() - t0
        got = dict(_lib.LAUNCHES)
        for k, n in got.items():
            launches[k] += n
        out = np.concatenate([r.output for r in results])
        n_out = inputs[0].shape[1] if name == "ae" else ds.num_classes
        if out.shape != (n_serve, n_out) or not np.isfinite(out).all():
            raise AssertionError(f"{name} {backend}: output {out.shape} not finite of "
                                 "the expected shape")
        batches = len(bucket_chunks(n_serve, server.plan.buckets, server.max_batch))
        run = dict(out=out, flows_per_s=n_serve / dt, launches=got, batches=batches,
                   server=server)
        if name != "ae":
            run["f1"] = macro_f1(out.argmax(-1), y, ds.num_classes)
        if device.type == "cuda":
            want = {} if backend == "gather" else {
                (k if backend == "kernel" else Q8_NAME[k]): n * batches
                for k, n in FAMILIES[name]["per_batch"].items()}
            if {k: n for k, n in got.items() if n} != want:
                raise AssertionError(f"{name} {backend}: launches {got}; expected {want}")
        res["runs"][backend] = run
        banks = [(b.layer.num_groups, b.layer.group_size, b.layer.num_centroids,
                  b.layer.out_features) for b in server.plan.banks]
    res["banks"], res["launches"] = banks, launches

    ref = res["runs"]["gather"]["out"]
    kern = res["runs"]["kernel"]
    kern["max_abs_err"] = float(np.abs(kern["out"] - ref).max())
    if not np.array_equal(kern["out"], ref):
        raise AssertionError(f"{name} kernel: not bit-equal to gather "
                             f"(max |kernel - gather| {kern['max_abs_err']})")
    q8 = res["runs"]["kernel_q8"]
    plan = q8["server"].plan
    rels = []
    with torch.no_grad():
        for bank, xb in zip(plan.banks, plan.bank_inputs(*tiled)):
            yg, yq = bank.apply(xb, "gather"), bank.apply(xb, "kernel_q8")
            rels.append(float(torch.linalg.norm(yq - yg))
                        / max(float(torch.linalg.norm(yg)), 1e-6))
    q8["bank_rel"] = rels
    q8["net_rel"] = float(np.linalg.norm(q8["out"] - ref) / np.linalg.norm(ref))
    if name == "ae":
        q8["agree"] = None
        res["auc"] = _ae_aucs(ds, teacher, model, device)
    else:
        q8["agree"] = float((q8["out"].argmax(-1) == ref.argmax(-1)).mean())
    if max(rels) >= Q8_BANK_REL or (q8["agree"] is not None and q8["agree"] < Q8_AGREE):
        raise AssertionError(f"{name} kernel_q8: per-bank rel max {max(rels)} "
                             f"(< {Q8_BANK_REL}), agreement {q8['agree']} (>= {Q8_AGREE})")
    if device.type == "cuda" and name == "rnn":
        res["profile"] = profile_window(kern["server"], requests)
        res["profile_eager"] = profile_window(kern["server"], requests, jit=False)
    return res


def families_phase(device, *, flows_per_class: int = 1500, steps: int | None = None,
                   tiny: bool = False, n_serve: int = 32768) -> dict:
    """RNN, CNN-B, CNN-M, CNN-L and the AutoEncoder, each through
    :func:`family_path` on peerrush traffic (``steps`` overrides every
    teacher's default)."""
    from repro_torch.data.synthetic_traffic import make_dataset

    ds = make_dataset("peerrush", flows_per_class=flows_per_class)
    out = {}
    for name, cfg in FAMILIES.items():
        out[name] = res = family_path(name, ds, device, steps=steps or cfg["steps"],
                                      tiny=tiny, n_serve=n_serve)
        for be, run in res["runs"].items():
            f1 = "" if name == "ae" else f", served macro-F1 {run['f1']:.4f} " \
                f"(teacher {res['teacher_f1']:.4f})"
            log(f"  {name} {be}: {run['flows_per_s']:.1f} flows/s over {run['batches']} "
                f"batches, launches {({k: n for k, n in run['launches'].items() if n})}{f1}")
        q8 = res["runs"]["kernel_q8"]
        log(f"  {name}: banks (K, v, C, N) {res['banks']}, built in {res['build_s']:.2f} s; "
            f"max |kernel - gather| {res['runs']['kernel']['max_abs_err']}; kernel_q8 "
            f"per-bank rel {['%.4f' % r for r in q8['bank_rel']]}, whole-net rel "
            f"{q8['net_rel']:.4f}, argmax agreement {q8['agree']}")
        if name == "ae":
            log("  ae anomaly AUC: " + ", ".join(
                f"{kind}/{who} {auc:.4f}" for (kind, who), auc in res["auc"].items()))
    return out


# ---------------------------------------------------------------------------
# Phase 6: many models behind one server, through the graphs
# ---------------------------------------------------------------------------

# the six served models of phases 4-5, by the name they are registered under
MODELS = ("mlp", "rnn", "cnn_b", "cnn_m", "cnn_l", "ae")
# launches one served batch makes on ``kernel`` (MLP-B fused: one stack)
PER_BATCH = {"mlp": {"fuzzy_lut_stack": 1},
             **{name: cfg["per_batch"] for name, cfg in FAMILIES.items()}}


def _served(res, fams, name, backend):
    """(model, request list renamed to ``name``, served output) of one model
    on ``backend`` from phases 4-5."""
    import dataclasses

    src = res if name == "mlp" else fams[name]
    run = src["runs"][(backend, True) if name == "mlp" else backend]
    reqs = [dataclasses.replace(r, model=name) for r in src["request_list"]]
    return src["model"], reqs, run


def _interleaved(lists: dict) -> list:
    """Round-robin across the models' request lists."""
    out, i = [], 0
    while any(i < len(v) for v in lists.values()):
        out += [v[i] for v in lists.values() if i < len(v)]
        i += 1
    return out


def _timed_serve(server, requests, device, **kw):
    _sync(device)
    t0 = time.perf_counter()
    results = server.serve(requests, **kw)
    _sync(device)
    return results, time.perf_counter() - t0


def graph_vs_eager(res, fams, device) -> dict:
    """Every served path of phases 4-5 on kernel and kernel_q8 (their
    graphs already captured), served once more through the graphs and once
    with ``jit=False``, in turns eager, graph, graph, eager: outputs
    bit-equal, flows/s of each."""
    import numpy as np

    paths = [("mlp", fuse) for fuse in (True, False)] + [(n, None) for n in FAMILIES]
    out = {}
    for name, fuse in paths:
        for backend in ("kernel", "kernel_q8"):
            src = res if name == "mlp" else fams[name]
            run = src["runs"][(backend, fuse) if name == "mlp" else backend]
            server, reqs = run["server"], src["request_list"]
            flows = sum(r.flows for r in reqs)
            e1, te1 = _timed_serve(server, reqs, device, jit=False)
            g1, tg1 = _timed_serve(server, reqs, device)
            g2, tg2 = _timed_serve(server, reqs, device)
            e2, te2 = _timed_serve(server, reqs, device, jit=False)
            outs = [np.concatenate([r.output for r in rs]) for rs in (e1, g1, g2, e2)]
            if not all(np.array_equal(o, run["out"]) for o in outs):
                err = max(float(np.abs(o - run["out"]).max()) for o in outs)
                raise AssertionError(f"{name} fuse={fuse} {backend}: graph and eager outputs "
                                     f"differ (max |diff| {err})")
            tag = name if fuse is None else f"mlp fuse={fuse}"
            out[(tag, backend)] = dict(eager=2 * flows / (te1 + te2),
                                       graph=2 * flows / (tg1 + tg2))
    return out


def multi_model(res, fams, device, backend: str, smi: str):
    """``MultiModelServer`` on ``backend`` holding the six models (mlp at
    priority weight 4): the interleaved traffic drained twice (the first
    captures the new plans' graphs); each model's outputs bit-equal to its
    own ``PegasusServer`` output, flows counted per model, every model in
    the schedule, no drain error and no fallback, the launch counts of the
    timed drain exactly those of the models' batches."""
    import numpy as np

    from repro_torch.kernels.fuzzy_lut import _lib
    from repro_torch.launch.serve import MultiModelServer

    server = MultiModelServer(backend=backend, device=device)
    lists, want = {}, {}
    for name in MODELS:
        model, reqs, run = _served(res, fams, name, backend)
        server.add_model(name, model, priority="high" if name == "mlp" else None)
        lists[name], want[name] = reqs, run["out"]
    traffic = _interleaved(lists)
    flows = sum(r.flows for r in traffic)
    for attempt in ("warm-up", "timed"):
        for req in traffic:
            server.submit(req)
        before = server.stats()["serving"]["models"]
        _sync(device)
        _lib.reset_launches()
        t0 = time.perf_counter()
        out = server.drain()
        _sync(device)
        dt = time.perf_counter() - t0
        launches = dict(_lib.LAUNCHES)
        _check_drain(server, f"MultiModelServer {backend} {attempt}")
        st = server.stats()["serving"]["models"]
        for name in MODELS:
            got = np.concatenate(out[name])
            if not np.array_equal(got, want[name]):
                raise AssertionError(f"MultiModelServer {backend}: {name} differs from its "
                                     f"PegasusServer output (max |diff| "
                                     f"{float(np.abs(got - want[name]).max())})")
            served = st[name]["flows_served"] - before[name]["flows_served"]
            if served != sum(r.flows for r in lists[name]):
                raise AssertionError(f"MultiModelServer {backend}: {name} served {served} flows")
        if set(server.schedule_log) != set(MODELS):
            raise AssertionError(f"schedule_log holds {sorted(set(server.schedule_log))}")
    if device.type == "cuda":
        expect: dict = {}
        for name in MODELS:
            batches = st[name]["batches_run"] - before[name]["batches_run"]
            for k, n in PER_BATCH[name].items():
                k = k if backend == "kernel" else Q8_NAME[k]
                expect[k] = expect.get(k, 0) + n * batches
        if {k: n for k, n in launches.items() if n} != expect:
            raise AssertionError(f"MultiModelServer {backend}: launches {launches}; "
                                 f"expected {expect}")
    log(f"  MultiModelServer {backend}: {len(traffic)} requests of six models "
        f"({flows} flows) in {server.batches_dispatched // 2} batches per drain: "
        f"{flows / dt:.1f} flows/s aggregate, launches {({k: n for k, n in launches.items() if n})}"
        f" on {smi}")
    return server, dict(flows_per_s=flows / dt, launches=launches, out=out,
                        traffic=traffic, want=want)


def _check_drain(server, what: str) -> None:
    """No drain error and no degraded batch outside an injected fault."""
    health = server.stats()["health"]["models"]
    fallback = {n: h["fallback_batches"] for n, h in health.items() if h["fallback_batches"]}
    if server.last_drain_errors or fallback:
        raise AssertionError(f"{what}: drain errors {server.last_drain_errors}, "
                             f"fallback batches {fallback}")


def async_server(mm, device, backend: str, smi: str) -> tuple:
    """``AsyncMultiModelServer(devices=1)``: one stream-pool worker on its own
    CUDA stream serves the same traffic through ``submit`` futures, twice
    (the first pass captures the worker stream's graphs); the second pass
    ends in ``stop(drain=True)``. Every output equals the sync drain's.
    Returns the second pass's flows/s and the (closed) server."""
    import numpy as np

    from repro_torch.launch.serve import AsyncMultiModelServer

    srv = AsyncMultiModelServer(backend=backend, device=device,
                                devices=1 if device.type == "cuda" else [device])
    try:
        for name in MODELS:
            srv.add_model(name, mm["server"].registry.model(name),
                          priority="high" if name == "mlp" else None)
        srv.start()
        for attempt in ("warm-up", "timed"):
            t0 = time.perf_counter()
            futs = [(r.model, srv.submit(r)) for r in mm["traffic"]]
            if attempt == "timed":
                srv.stop(drain=True, timeout=300)
            got: dict = {}
            for name, f in futs:
                got.setdefault(name, []).append(f.result(timeout=300).output)
            dt = time.perf_counter() - t0
            _check_drain(srv, f"AsyncMultiModelServer {backend} {attempt}")
            for name in MODELS:
                if not np.array_equal(np.concatenate(got[name]),
                                      np.concatenate(mm["out"][name])):
                    raise AssertionError(f"AsyncMultiModelServer {backend}: {name} differs "
                                         "from the sync drain")
        if srv.running or srv.loop_errors:
            raise AssertionError(f"AsyncMultiModelServer: running {srv.running}, loop "
                                 f"errors {list(srv.loop_errors)}")
        pool = srv.stats()["devices"]
    finally:
        srv.close()
    flows = sum(r.flows for r in mm["traffic"])
    log(f"  AsyncMultiModelServer(devices=1) {backend}: outputs equal to the sync drain; "
        f"{flows / dt:.1f} flows/s through futures (second pass, ending in "
        f"stop(drain=True)); pool {[(d['device'], d['dispatched_chunks']) for d in pool['per_device']]}"
        f" on {smi}")
    return flows / dt, srv


def injected_fault(mm, device) -> dict:
    """Three injected ``plan_call`` failures of rnn on the kernel server: the
    breaker opens, rnn serves degraded on gather (equal to kernel bit for
    bit), and after the cooldown a probe closes the breaker again."""
    import numpy as np

    from repro_torch.launch.chaos import FaultInjector

    server = mm["server"]
    rnn_reqs = [r for r in mm["traffic"] if r.model == "rnn"]
    one_mlp = next(r for r in mm["traffic"] if r.model == "mlp")
    want = np.concatenate(mm["out"]["rnn"])
    inj = FaultInjector(seed=0)
    inj.inject("plan_call", model="rnn", count=3)
    server.install_chaos(inj)
    try:
        for r in rnn_reqs:
            server.submit(r)
        states = []
        for _ in range(3):               # each drain's first rnn slice fails
            server.submit(one_mlp)
            server.drain()
            states.append(server.stats()["health"]["models"]["rnn"]["state"])
        if states != ["closed", "closed", "open"]:
            raise AssertionError(f"breaker states after 1-3 failures: {states}")
        degraded = server.drain()["rnn"]          # the whole queue, on gather
        if not np.array_equal(np.concatenate(degraded), want):
            raise AssertionError("degraded gather batches differ from the kernel output")
        time.sleep(server.breaker_reset_s + 0.05)
        for r in rnn_reqs:
            server.submit(r)
        probed = server.drain()["rnn"]
        if server.last_drain_errors or not np.array_equal(np.concatenate(probed), want):
            raise AssertionError(f"probe drain: errors {server.last_drain_errors}")
        health = server.stats()["health"]["models"]["rnn"]
    finally:
        server.uninstall_chaos()
    if (health["state"] != "closed" or health["opened"] != 1 or health["reinstated"] != 1
            or not health["fallback_batches"] or inj.stats()["fired"] != 3):
        raise AssertionError(f"breaker did not open and close once: {health}")
    log(f"  injected fault (3 x plan_call on rnn): breaker {states} -> degraded "
        f"{health['fallback_batches']} gather batches (bit-equal to kernel) -> probe "
        f"{health['probe_batches']} -> {health['state']}; health {health}")
    return health


def multi_model_phase(res, fams, device, smi: str) -> dict:
    """Phase 6: graph against eager, ``MultiModelServer`` on kernel and
    kernel_q8, ``AsyncMultiModelServer(devices=1)``, one injected fault."""
    import torch

    log("  graph against eager (flows/s, in turns eager, graph, graph, eager):")
    speed = graph_vs_eager(res, fams, device)
    for (tag, backend), r in speed.items():
        log(f"    {tag:13s} {backend:9s} eager {r['eager']:.1f}, graph {r['graph']:.1f} "
            f"flows/s (graph/eager {r['graph'] / r['eager']:.3f}) on {smi}")
    out = dict(speed=speed, launches={})
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for backend in ("kernel", "kernel_q8"):
        server, mm = multi_model(res, fams, device, backend, smi)
        mm["server"] = server
        out[backend] = mm
        for k, n in mm["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + n
    if device.type == "cuda":
        log(f"  card memory after the multi-model servers: allocated "
            f"{torch.cuda.memory_allocated()} B, peak {torch.cuda.max_memory_allocated()} B "
            f"on {smi}")
        missing = [k for k, n in out["launches"].items() if not n]
        if missing:
            raise AssertionError(f"phase 6 launched no {missing}")
    out["async_flows_per_s"], out["async"] = async_server(out["kernel"], device, "kernel", smi)
    out["health"] = injected_fault(out["kernel"], device)
    return out


# ---------------------------------------------------------------------------
# Phase 7: backprop refinement, and the refined MLP-B through the kernels
# ---------------------------------------------------------------------------


def refinement_phase(res, fams, device, smi: str, *, baseline_steps: int = 900,
                     cnn_m_steps: int = 20) -> dict:
    """Phase 7: phase 4's MLP-B teacher pegasusified with the reference's
    default refinement (``refine_steps=100``) on ``device``, timed (phase 4
    timed the same call without refinement), with each bank's hard error
    before and after; the refined banks served as phase 4 serves its banks
    (:func:`serve_mlp`) under plans of their own; N3IC and BoS trained and
    Leo fitted beside MLP-B and RNN-B (the paper's Table 5, printed, not
    asserted); one refine of CNN-M's depth-12 window bank."""
    import numpy as np
    import torch

    from repro_torch.core.finetune import hard_mse, refine
    from repro_torch.engine import STATS, plan_for
    from repro_torch.nets import cnn
    from repro_torch.nets import mlp as mlp_net
    from repro_torch.nets.baselines import bos, leo, n3ic
    from repro_torch.nets.common import macro_f1

    ds, teacher, plain = res["ds"], res["teacher"], res["model"]
    x_cal = ds.train["stats"].astype(np.float32)
    _sync(device)
    t0 = time.perf_counter()
    banks = mlp_net.pegasusify_mlp(teacher, x_cal, depth=res["depth"])   # refine_steps=100
    _sync(device)
    refined_s, plain_s = time.perf_counter() - t0, res["peg_s"]
    acts = mlp_net._activations(teacher, x_cal)
    with torch.no_grad():
        targets = acts[1:] + [mlp_net.mlp_apply(teacher, torch.as_tensor(x_cal, device=device))]
    mse = [(hard_mse(a, acts[i], targets[i]), hard_mse(b, acts[i], targets[i]))
           for i, (a, b) in enumerate(zip(plain, banks))]
    for i, (a, b) in enumerate(zip(plain, banks)):
        if b.lut.device.type != device.type:
            raise AssertionError(f"bank {i} refined on {b.lut.device}, not on {device}")
        if not torch.equal(a.trees.features, b.trees.features):
            raise AssertionError(f"bank {i}: refinement did not start from the unrefined trees")
        if torch.equal(a.lut, b.lut) or not torch.isfinite(b.lut).all():
            raise AssertionError(f"bank {i}: refined LUT unchanged or not finite")
    if not all(np.isfinite(m).all() for m in mse):
        raise AssertionError(f"hard_mse not finite: {mse}")
    log(f"  pegasusify_mlp(refine_steps=100) on {device}: {refined_s:.3f} s; phase 4's "
        f"refine_steps=0: {plain_s:.3f} s; refinement {refined_s - plain_s:.3f} s "
        f"(4 banks x 100 Adam steps, batch 512) on {smi}")
    log("  per-bank hard_mse before -> after: " + ", ".join(
        f"bank {i} {before:.6g} -> {after:.6g}" for i, (before, after) in enumerate(mse)))

    builds = STATS.plan_builds
    p_plain, p_refined = plan_for(plain, device=device), plan_for(banks, device=device)
    if p_plain is p_refined or plan_for(plain, device=device) is not p_plain \
            or STATS.plan_builds != builds + 2:
        raise AssertionError(f"plan memo: {STATS.plan_builds - builds} builds for the "
                             "unrefined and the refined banks (expected 2)")

    reqs = res["request_list"]
    served = serve_mlp(banks, reqs, res["x"], res["y"], ds.num_classes, device)
    log("  refined against unrefined (phase 4's servers), flows/s in turns unrefined, "
        "refined, refined, unrefined:")
    for key, run in served["runs"].items():
        old = res["runs"][key]["server"]
        t = [_timed_serve(srv, reqs, device)[1] for srv in (old, run["server"],
                                                           run["server"], old)]
        run["in_turns"] = (2 * res["flows"] / (t[0] + t[3]), 2 * res["flows"] / (t[1] + t[2]))
        log(f"    {key[0]:9s} fuse={key[1]!s:5s} unrefined {run['in_turns'][0]:.1f}, refined "
            f"{run['in_turns'][1]:.1f} flows/s; served macro-F1 {run['f1']:.4f} (unrefined "
            f"{res['runs'][key]['f1']:.4f}, teacher {res['teacher_f1']:.4f}) on {smi}")

    tr, te, nc = ds.train, ds.test, ds.num_classes
    f1 = {}
    for name, model, test_x in (("MLP-B (refined)", banks, te["stats"].astype(np.float32)),
                                ("MLP-B (unrefined)", plain, te["stats"].astype(np.float32)),
                                ("RNN-B", fams["rnn"]["model"], te["seq"])):
        pred = plan_for(model, device=device)(test_x, backend="kernel").argmax(-1).cpu().numpy()
        f1[name] = macro_f1(pred, te["label"], nc)
    t0 = time.perf_counter()
    n3 = n3ic.train_n3ic(tr["stats"], tr["label"], nc, steps=baseline_steps, device=device)
    bs = bos.train_bos(tr["seq"], tr["label"], nc, steps=baseline_steps, device=device)
    _sync(device)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = leo.train_leo(tr["stats"], tr["label"], nc, max_nodes=1024)
    leo_s = time.perf_counter() - t0
    with torch.no_grad():
        f1["N3IC"] = macro_f1(n3ic.n3ic_apply(n3, te["stats"]).argmax(-1).cpu().numpy(),
                              te["label"], nc)
        f1["BoS"] = macro_f1(bos.bos_apply(bs, te["seq"]).argmax(-1).cpu().numpy(),
                             te["label"], nc)
    f1["Leo"] = macro_f1(leo.leo_predict(tree, te["stats"]), te["label"], nc)
    log(f"  Table 5 (test macro-F1, {len(te['label'])} flows): "
        + ", ".join(f"{k} {v:.4f}" for k, v in f1.items())
        + f"; N3IC + BoS trained {baseline_steps} steps each on {device} in {train_s:.2f} s, "
        f"Leo fitted ({tree.node_count} nodes) in {leo_s:.2f} s")

    cnn_m = fams["cnn_m"]
    win = cnn_m["model"].window_bank
    flat, target = cnn.nam_window_targets(cnn_m["teacher"], cnn_m["ds"].train["seq"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = hard_mse(win, flat, target)
    _sync(device)
    t0 = time.perf_counter()
    refined_win = refine(win, flat, target, steps=cnn_m_steps)
    _sync(device)
    cnn_s = time.perf_counter() - t0
    after = hard_mse(refined_win, flat, target)
    if not (np.isfinite(after) and torch.isfinite(refined_win.lut).all()):
        raise AssertionError(f"CNN-M window bank refine: hard_mse {after}")
    peak = (f", peak card memory allocated {torch.cuda.max_memory_allocated()} B"
            if device.type == "cuda" else "")
    geom = (win.num_groups, win.group_size, win.num_centroids, win.out_features)
    log(f"  CNN-M window bank (K, v, C, N) {geom}: refine {cnn_m_steps} steps on {len(flat)} "
        f"windows in {cnn_s:.3f} s, hard_mse {before:.6g} -> {after:.6g}{peak} on {smi}")
    return dict(launches=served["launches"], runs=served["runs"], mse=mse, f1=f1,
                refine_s=refined_s - plain_s, cnn_m=(before, after, cnn_s), banks=banks)


# ---------------------------------------------------------------------------
# Phase 8: the plan audit and the dataplane on the card
# ---------------------------------------------------------------------------


def _phase_plans(res, fams, multi, refined, device) -> list:
    """(label, plan, served inputs) of every plan phases 4-7 built, once each."""
    from repro_torch.engine import STATS, plan_for

    builds = STATS.plan_builds
    inputs = {"mlp": (res["x"],), **{name: f["inputs"] for name, f in fams.items()}}
    out, seen = [], set()

    def add(label, plan, x):
        if id(plan) not in seen:
            seen.add(id(plan))
            out.append((label, plan, x))

    for (be, fuse), run in res["runs"].items():
        add(f"mlp {be} fuse={fuse}", run["server"].plan, inputs["mlp"])
    for name, fam in fams.items():
        for be, run in fam["runs"].items():
            add(f"{name} {be}", run["server"].plan, inputs[name])
    for be, server in (("kernel", multi["kernel"]["server"]),
                       ("kernel_q8", multi["kernel_q8"]["server"]), ("async", multi["async"])):
        for name in server.models():
            add(f"multi {be} {name}", server.registry.get(name), inputs[name])
    for (be, fuse), run in refined["runs"].items():
        add(f"mlp refined {be} fuse={fuse}", run["server"].plan, inputs["mlp"])
    # the memo's plans (plan_for: phase 7's Table 5 and memo check, the AE's
    # anomaly scores): memo hits, nothing is built here
    for label, model, name in (("mlp", res["model"], "mlp"),
                               ("mlp refined", refined["banks"], "mlp"),
                               ("rnn", fams["rnn"]["model"], "rnn"),
                               ("ae", fams["ae"]["model"], "ae")):
        add(f"plan_for {label}", plan_for(model, device=device), inputs[name])
    if STATS.plan_builds != builds:
        raise AssertionError(f"phase 8 built {STATS.plan_builds - builds} plan(s); it audits "
                             "the plans of phases 4-7")
    return out


def _plan_steps(plan) -> list:
    """(site, step) of a plan as the audit names them: fused stacks, then
    the banks outside them."""
    members = {id(b) for s in plan.fused_stacks for b in s.banks}
    steps = []
    for g, st in enumerate(plan.fused_stacks):
        lo = plan.banks.index(st.banks[0])
        steps.append((f"stack[{g}]=banks[{lo}:{lo + len(st.banks)}]", st))
    steps += [(f"bank[{i}]", b) for i, b in enumerate(plan.banks) if id(b) not in members]
    return steps


def _launch_check(step, rows: int, n_sm: int) -> tuple:
    """What the kernels' planners give one step at ``rows`` rows: f32 (rows
    per block, shared bytes), int8 (rows per block, shared bytes), and
    whether the int8 plan copies a column tile byte by byte."""
    import numpy as np

    from repro_torch.kernels.fuzzy_lut import quantized as Q
    from repro_torch.kernels.fuzzy_lut.kernel import f32_launch_shape, plan_f32

    if hasattr(step, "ks"):
        ks, v, (kmax, c, nmax), n_out = step.ks, step.v, step.lut.shape[1:], step.n_out
        ops = (step.features, step.thr, step.lut_q8, step.scales, step.bias)
    else:
        lay = step.layer
        ks, v, kmax, c = (lay.num_groups,), lay.group_size, lay.num_groups, lay.num_centroids
        n_out = lay.out_features
        ops = (step.features, step.thr, step.lut_q8, step.scales, None)
    f_rows, _, _, f_smem = f32_launch_shape(plan_f32(tuple(ks), v, int(np.log2(c)), kmax),
                                            rows, n_sm)
    qp = Q.launch_plan(v, *ops, ks, n_out)
    q_rows, _, _, _, q_smem = Q.launch_shape(qp, rows, n_sm)
    bytewise = any(st.flags & Q.LUT and not st.flags & Q.FULLROW and not st.bulk & Q.B_LUT
                   for st in qp.stages)
    return (f_rows, f_smem), (q_rows, q_smem), bytewise


def audit_phase(res, fams, multi, refined, device, smi: str) -> dict:
    """Phase 8, first half: every plan phases 4-7 built on ``device`` was
    audited at build (counts in ``compile_stats()``, no error finding); its
    PGA103 rows per block and shared bytes equal the kernels' planners at
    the rows a 4096-flow batch gives each step (measured here with
    ``bank_inputs``) on the device's SM count; PGA104 flags exactly the
    steps whose int8 plan copies a column tile byte by byte."""
    import numpy as np
    import torch

    n_sm = (torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else 132)
    plans = _phase_plans(res, fams, multi, refined, device)
    flagged, expect, seconds = set(), set(), []
    for label, plan, inputs in plans:
        counts = plan.compile_stats()["audit"]
        if counts is None or counts["error"]:
            raise AssertionError(f"{label}: audit counts {counts} (expected counts, no error)")
        rep = plan.audit_report
        seconds.append(rep.summary["seconds"])
        top = max(plan.buckets)
        first = [np.concatenate([x] * -(-top // len(x)))[:top] for x in inputs]
        rows = {id(b): int(x.shape[0]) for b, x in zip(plan.banks, plan.bank_inputs(*first))}
        notes = {f.site: f for f in rep.findings if f.rule == "PGA103"}
        warned = {f.site for f in rep.findings if f.rule == "PGA104" and f.severity == "warning"}
        parts = []
        for site, step in _plan_steps(plan):
            head = step.banks[0] if hasattr(step, "ks") else step
            f32, q8, bytewise = _launch_check(step, rows[id(head)], n_sm)
            m = notes[site].metrics
            got = ((m["f32"]["rows_per_block"], m["f32"]["smem_bytes"]),
                   (m["q8"]["rows_per_block"], m["q8"]["smem_bytes"]))
            if m["rows"] != rows[id(head)] or got != (f32, q8) or m["n_sm"] != n_sm:
                raise AssertionError(f"{label} {site}: audit rows {m['rows']}, (rows/block, "
                                     f"shared B) {got} on {m['n_sm']} SMs; the planners give "
                                     f"{rows[id(head)]} rows, {(f32, q8)} on {n_sm}")
            lay = head.layer
            geom = (("stack", *step.ks) if hasattr(step, "ks") else
                    (lay.num_groups, lay.group_size, lay.num_centroids, lay.out_features))
            if bytewise:
                expect.add((label, site))
            if site in warned:
                flagged.add((label, site, geom))
            parts.append(f"{site} {rows[id(head)]} rows: f32 {f32[0]}/{f32[1]} B, int8 "
                         f"{q8[0]}/{q8[1]} B{' PGA104' if site in warned else ''}")
        log(f"  {label}: audit {rep.summary['seconds']:.4f} s at build, counts {counts}; "
            f"PGA103 (rows/block, shared B per block) " + "; ".join(parts))
    if {(label, site) for label, site, _ in flagged} != expect:
        raise AssertionError(f"PGA104 flags {sorted(flagged)}; the int8 plans with byte-wise "
                             f"column tiles are {sorted(expect)}")
    geoms = sorted({(site, geom) for _, site, geom in flagged}, key=str)
    log(f"  PGA104 flags {len(flagged)} launches of {len(plans)} plans, the int8 plans with "
        f"byte-wise column tiles exactly: {geoms}")
    log(f"  audit seconds per plan build: min {min(seconds):.4f}, max {max(seconds):.4f}, "
        f"total {sum(seconds):.3f} over {len(plans)} plans on {smi} ({n_sm} SMs)")
    return dict(plans=len(plans), flagged=geoms, seconds=seconds)


def _pipeline_rate(pipe, x, device, reps: int = 5) -> tuple:
    """(outputs, flows/s): the median of ``reps`` timed ``run_batch`` calls
    over ``x`` on ``device`` (host clock ending in a sync), after one
    untimed call that moves the tables there."""
    import numpy as np
    import torch

    xb = torch.as_tensor(x, device=device)
    out = pipe.run_batch(xb)
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        out = pipe.run_batch(xb)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return out.cpu().numpy(), len(x) / float(np.median(times))


def _exact_on(pipe, x, device, what: str) -> int:
    """``run_batch`` on ``device`` over the first 256 flows of ``x`` equals
    ``run_packet`` on the CPU, exactly. Returns the flows checked."""
    import numpy as np
    import torch

    n = min(256, len(x))
    got = pipe.run_batch(torch.as_tensor(x[:n], device=device)).cpu().numpy()
    want = np.stack([pipe.run_packet(p) for p in x[:n]])
    if got.dtype != np.int32 or not np.array_equal(got, want):
        bad = int((got != want).any(-1).sum())
        raise AssertionError(f"{what}: run_batch on {device} differs from run_packet on "
                             f"{bad} of {n} flows")
    return n


def dataplane_phase(res, fams, refined, device, smi: str) -> dict:
    """Phase 8, second half: phase 7's refined MLP-B (80 stateful bits per
    flow, as the reference's quickstart) and the AE banks compiled to MAT
    pipelines (Table 6 rows); MLP-B's integer pipeline run on ``device``
    over the test split and the served tiling, exactly ``run_packet``'s
    outputs, with its flows/s, its argmax agreement with the served
    ``kernel`` outputs and its macro-F1 beside theirs; the AE pipeline over
    the test split, held to ``run_packet`` the same way."""
    import numpy as np

    from repro_torch.dataplane.compile import compile_model
    from repro_torch.nets.common import macro_f1

    ds, nc = res["ds"], res["ds"].num_classes
    n_test = len(ds.test["label"])
    out = {}
    pipe = compile_model(list(refined["banks"]), stateful_bits_per_flow=80)
    ae_pipe = compile_model(list(fams["ae"]["model"]))
    for name, p in (("MLP-B (refined)", pipe), ("AE", ae_pipe)):
        rep = p.report()
        log(f"  Table 6: {rep.table6_row(name)}  ({rep.stages_used} stages, "
            f"{rep.recirculations} recirculation(s), PHV peak {rep.phv_bits_peak} bits, "
            f"violations: {rep.validate() or 'none'})")
        out[name] = dict(report=rep)
    test_x = ds.test["stats"].astype(np.float32)
    checked = _exact_on(pipe, test_x, device, "MLP-B pipeline")
    served = refined["runs"][("kernel", True)]
    for what, x, y in (("test split", test_x, ds.test["label"]),
                       ("served tiling", res["x"], res["y"])):
        ints, rate = _pipeline_rate(pipe, x, device)
        f1 = macro_f1(ints.argmax(-1), y, nc)
        line = (f"  MLP-B integer pipeline on {device}, {what} ({len(x)} flows): "
                f"{rate:.1f} flows/s, macro-F1 {f1:.4f}")
        if what == "served tiling":
            agree = float((ints.argmax(-1) == served["out"].argmax(-1)).mean())
            line += (f"; argmax agreement with the served kernel outputs {agree:.4f}, "
                     f"served kernel macro-F1 {served['f1']:.4f}")
            out["agree"], out["served_f1"] = agree, served["f1"]
        else:
            line += f" (kernel on the test split {refined['f1']['MLP-B (refined)']:.4f})"
        log(line + f"; run_batch equal to run_packet on {checked} flows, on {smi}")
        out[what] = dict(flows_per_s=rate, f1=f1)
    feats = fams["ae"]["inputs"][0][:n_test]
    checked = _exact_on(ae_pipe, feats, device, "AE pipeline")
    _, rate = _pipeline_rate(ae_pipe, feats, device)
    log(f"  AE integer pipeline on {device}, test split ({n_test} flows): {rate:.1f} flows/s; "
        f"run_batch equal to run_packet on {checked} flows, on {smi}")
    out["ae_flows_per_s"] = rate
    return out


def profile_window(server, requests, **kw) -> dict | None:
    """``torch.profiler`` over one served run of ``server`` (``kw`` goes to
    ``serve``); see :func:`profile_fn`."""
    return profile_fn(lambda: server.serve(requests, **kw))


def profile_fn(fn) -> dict | None:
    """``torch.profiler`` over one ``fn()``: device time by kernel name and
    the device's idle share over the window (the span from the first to the
    last event, host or device). None when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.time_range.end > e.time_range.start]
    if not dev:
        return None
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for st, en in spans[1:]:
        if st > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    return dict(window_us=t1 - t0, busy_us=busy, idle_share=1 - busy / (t1 - t0),
                by_name=dict(sorted(by_name.items(), key=lambda kv: -kv[1])))


# ---------------------------------------------------------------------------
# Phase 9: the LM stack, Qwen2-VL-2B at its published width
# ---------------------------------------------------------------------------

LM_ARCH = "qwen2_vl_2b"
# full size: 8 prompts, 1024-token prefill (the chunked attention path), a
# 2048-slot cache, 32 generated tokens, 16 decode steps held to the forward
LM_FULL = dict(batch=8, prefill_len=1024, kv_len=2048, max_new=32, check_steps=16,
               calib_rows=1024)
LM_REHEARSE = dict(batch=2, prefill_len=1024, kv_len=64, max_new=4, check_steps=8,
                   calib_rows=1024)
# the reference's own prefill-vs-decode limit (tests/test_archs.py)
LM_DECODE_TOL = 2e-3
# kernel vs gather over the LUT upcast to f32: both sum the same f32 terms
# in ascending k, so they agree to the bit; the limit leaves f32 headroom
LM_FFN_TOL = 1e-4
# the smoke architectures on the card vs the CPU: f32 sums in another order
# (the Hymba mamba state grows to ~60 over 32 steps, ~1e-6 relative)
LM_SMOKE_TOL = 1e-4
LM_SMOKE_B, LM_SMOKE_S, LM_SMOKE_STEPS = 2, 32, 4
LM_TIME_BUDGET_S = 1.0     # per device_ms call at the LM bank geometries


def _median_s(fn, device, reps: int = 3) -> float:
    """Median wall seconds of ``fn()`` over ``reps`` runs, each ending in a
    sync (host clock)."""
    import numpy as np

    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _close(got, want, tol: float, what: str) -> float:
    """Max |got - want|; raises unless |got - want| <= tol + tol * |want|
    everywhere."""
    import torch

    got, want = got.to(torch.float32), want.to(torch.float32)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if got.shape != want.shape or not torch.isfinite(got).all() or \
            bool(((got - want).abs() > tol + tol * want.abs()).any()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"max |diff| {err} (limit {tol} + {tol}·|ref|)")
    return err


def lm_dense(cfg, device, smi: str, *, batch, prefill_len, kv_len, max_new,
             check_steps, **_) -> dict:
    """The dense model on ``device``: prefill, generate, decode against the
    forward, a profiler window over 8 decode steps. Captures the last
    layer's FFN input during the first prefill (forward pre-hook)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import Server, make_prefill_step
    from repro_torch.models.transformer import (
        decode_step, forward_train, init_decode_state, init_model, padded_vocab,
    )

    t0 = time.perf_counter()
    params = init_model(cfg, 0, dtype=torch.float32, device=device)
    _sync(device)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size} (padded {padded_vocab(cfg)}): {n_params} f32 parameters "
        f"({4 * n_params / 1e9:.3f} GB) drawn on {device} in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prefill_len)),
                             dtype=torch.int32, device=device)
    prefill = make_prefill_step(cfg)
    captured = []
    hook = params.layers[-1].ffn.register_forward_pre_hook(
        lambda _m, args: captured.append(args[0].detach().clone()))
    try:
        first = prefill(params, {"tokens": tokens})
    finally:
        hook.remove()
    if first.shape != (batch,) or int(first.min()) < 0 or int(first.max()) >= padded_vocab(cfg):
        raise AssertionError(f"prefill tokens {first.tolist()} out of range")
    prefill_s = _median_s(lambda: prefill(params, {"tokens": tokens}), device)
    prefill_tps = batch * prefill_len / prefill_s

    server = Server(cfg, device=device, kv_len=kv_len, batch_size=batch, params=params)
    prompts = tokens[:, :1].cpu().numpy()
    out = server.generate(prompts, max_new=max_new)
    if out.shape != (batch, 1 + max_new) or out.min() < 0 or out.max() >= padded_vocab(cfg):
        raise AssertionError(f"generate returned {out.shape} tokens in "
                             f"[{out.min()}, {out.max()}]")
    decode_s = _median_s(lambda: server.generate(prompts, max_new=max_new), device)
    decode_tps = batch * max_new / decode_s
    log(f"  prefill {batch} x {prefill_len} tokens: median {prefill_s:.4f} s, "
        f"{prefill_tps:.1f} tokens/s; generate {batch} x {max_new} tokens (kv_len "
        f"{kv_len}): median {decode_s:.4f} s, {decode_tps:.1f} tokens/s (host clock "
        f"ending in a sync, median of 3, f32 matmul precision "
        f"{torch.get_float32_matmul_precision()}) on {smi}")

    # greedy decode_step against forward_train over the same tokens
    state = init_decode_state(cfg, batch, check_steps, dtype=torch.float32, device=device)
    tok, fed, steps = tokens[:, :1], [], []
    with torch.no_grad():
        for t in range(check_steps):
            logits, state = decode_step(cfg, params, state, tok, t)
            fed.append(tok)
            steps.append(logits)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        full, _ = forward_train(cfg, params, {"tokens": torch.cat(fed, dim=1)})
    dec = torch.stack(steps, dim=1)
    err = _close(dec, full, LM_DECODE_TOL, f"{cfg.name} decode vs forward")
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    log(f"  {check_steps} greedy decode_steps vs forward_train: max |diff| {err:.3e} "
        f"(limit {LM_DECODE_TOL}), argmax agreement {agree:.4f}")

    prof = None
    if device.type == "cuda":
        prof = profile_fn(lambda: server.generate(prompts, max_new=8))
    del server
    return dict(params=params, ffn_in=captured[0], prefill_tps=prefill_tps,
                decode_tps=decode_tps, prefill_s=prefill_s, decode_s=decode_s,
                decode_err=err, agree=agree, profile=prof, n_params=n_params)


def _f32_lut(ffn):
    """The PegasusFFN with each LUT upcast to f32 (the gather oracle of the
    kernel path, which sums the f32 upcast of the LUT)."""
    import dataclasses

    return dataclasses.replace(ffn, **{
        name: dataclasses.replace(b, lut=b.lut.float())
        for name, b in (("w_in", ffn.w_in), ("w_gate", ffn.w_gate), ("w_out", ffn.w_out))
        if b is not None})


def _bank_rel(bank, x, path: str) -> float:
    """||bank on ``path`` - bank on gather|| / ||bank on gather||."""
    import torch

    from repro_torch.core.amm import pegasus_linear_apply

    yg = pegasus_linear_apply(bank, x, path="gather")
    yp = pegasus_linear_apply(bank, x, path=path)
    return float(torch.linalg.norm(yp - yg) / max(float(torch.linalg.norm(yg)), 1e-6))


def lm_pegasus(cfg, dense: dict, device, smi: str, *, calib_rows, time_it: bool, **_) -> dict:
    """The last layer's FFN pegasusified at the reference defaults and run
    on gather / kernel / kernel_q8 over 8 and all captured rows; each bank
    launch held against its plain version; the launch counts of the
    counted FFN calls; each bank geometry timed (f32 and int8 in turns)
    beside its bound, its plain version and the dense product it replaces."""
    import numpy as np
    import torch

    from repro_torch.core.amm import pegasus_linear_apply
    from repro_torch.kernels.fuzzy_lut import _lib, ops
    from repro_torch.kernels.fuzzy_lut import kernel as K
    from repro_torch.kernels.fuzzy_lut import quantized as Q
    from repro_torch.models.layers import activation
    from repro_torch.models.pegasus_layer import pegasus_ffn_apply, pegasusify_ffn_layer

    dense_ffn = dense["params"].layers[-1].ffn
    rows = dense["ffn_in"].reshape(-1, cfg.d_model)
    calib, held = rows[:calib_rows], rows[calib_rows:]
    t0 = time.perf_counter()
    ffn = pegasusify_ffn_layer(cfg, dense_ffn, calib.cpu().numpy())
    fit_s = time.perf_counter() - t0
    banks = dict(w_in=ffn.w_in, w_gate=ffn.w_gate, w_out=ffn.w_out)
    log(f"  pegasusified the last FFN (v=4, depth 4, bf16 LUT) on {calib_rows} captured "
        f"rows in {fit_s:.2f} s: (K, C, N) = " + ", ".join(
            f"{n} {(b.num_groups, b.num_centroids, b.out_features)}" for n, b in banks.items()))
    ffn32 = _f32_lut(ffn)
    act = activation(cfg.act)

    launches = dict.fromkeys(_lib.LAUNCHES, 0)
    probs, out = [], dict(fit_s=fit_s, runs={})
    for x in (held[:8], rows):
        t = x.shape[0]
        with torch.no_grad():
            h = act(pegasus_linear_apply(ffn.w_gate, x, path="kernel")) * \
                pegasus_linear_apply(ffn.w_in, x, path="kernel")
        inputs = dict(w_in=x, w_gate=x, w_out=h)
        rels = {}
        for name, bank in banks.items():
            xb = inputs[name]
            xg = xb.reshape(-1, bank.num_groups, bank.group_size).contiguous()
            f, th, lut, _ = ops.padded_layout(bank, quant=False)
            qf, qth, q, sc = ops.padded_layout(bank, quant=True)
            tag = f"{name} T={t} K={bank.num_groups} N={bank.out_features}"
            y, lv = K.fuzzy_lut(xg, f, th, lut, return_leaves=True)
            wy, wl = K.fuzzy_lut_plain(xg, f, th, lut)
            err32 = _compare("fuzzy_lut", tag, y, lv, wy, wl)
            y, lv = Q.fuzzy_lut_q8(xg, qf, qth, q, sc, return_leaves=True)
            wy, wl8 = Q.fuzzy_lut_q8_plain(xg, qf, qth, q, sc)
            err8 = _compare("fuzzy_lut_q8", tag, y, lv, wy, wl8)
            rels[name] = _bank_rel(bank, xb, "kernel_q8")
            probs.append(dict(tag=tag, name=name, t=t, x=xg, f=f, th=th, lut=lut, q=q, sc=sc,
                              leaves=wl, err32=err32, err8=err8, xb=xb,
                              w=getattr(dense_ffn, name)))
        if max(rels.values()) >= Q8_BANK_REL:
            raise AssertionError(f"kernel_q8 per-bank rel {rels} (< {Q8_BANK_REL}) at T={t}")

        # the counted run: the FFN on each kernel path, counts set to 0 just before
        _sync(device)
        _lib.reset_launches()
        with torch.no_grad():
            y_k = pegasus_ffn_apply(ffn, x, path="kernel")
            y_q = pegasus_ffn_apply(ffn, x, path="kernel_q8")
        _sync(device)
        got = dict(_lib.LAUNCHES)
        for key, n in got.items():
            launches[key] += n
        n_banks = len(banks)
        expect = dict(dict.fromkeys(got, 0), fuzzy_lut=n_banks, fuzzy_lut_q8=n_banks)
        if device.type == "cuda" and got != expect:
            raise AssertionError(f"T={t}: launches {got}; expected {n_banks} fuzzy_lut and "
                                 f"{n_banks} fuzzy_lut_q8 (one per bank per FFN call)")
        with torch.no_grad():
            y_g = pegasus_ffn_apply(ffn, x, path="gather")
            y_g32 = pegasus_ffn_apply(ffn32, x, path="gather")
        err = _close(y_k, y_g32, LM_FFN_TOL, f"FFN kernel vs gather (f32 LUT) T={t}")
        if y_q.shape != y_k.shape or not torch.isfinite(y_q).all():
            raise AssertionError(f"kernel_q8 FFN output {tuple(y_q.shape)} not finite")
        bf16 = float((y_k - y_g).abs().max())
        out["runs"][t] = dict(err=err, bf16_gather=bf16, q8_rel=rels, launches=got)
        log(f"  T={t}: every bank launch bit-equal to its plain version, leaves exact; FFN "
            f"kernel vs gather over the f32-upcast LUT max |diff| {err} (limit {LM_FFN_TOL}); "
            f"vs gather over the bf16 LUT (bf16 result) {bf16:.3e}; kernel_q8 per-bank rel "
            + ", ".join(f"{n} {r:.4f}" for n, r in rels.items())
            + f" (< {Q8_BANK_REL}); launches {got}")

    with torch.no_grad():
        want = dense_ffn(held)
        got_h = pegasus_ffn_apply(ffn, held, path="kernel")
    rel = float(torch.linalg.norm(got_h - want) / torch.linalg.norm(want))
    out["dense_rel"] = rel
    log(f"  Pegasus FFN (kernel) vs the dense FFN on {held.shape[0]} held-out rows: relative "
        f"error {rel:.4f} (printed only: the weights are random)")

    out["times"] = []
    for p in probs:
        rec = dict(tag=p["tag"], name=p["name"], t=p["t"], err32=p["err32"], err8=p["err8"])
        pb = dict(x=p["x"], features=p["f"], lut=p["lut"])
        rec["bound32"] = bound_ms(*bank_bound(pb, p["leaves"], q8=False))
        rec["bound8"] = bound_ms(*bank_bound(dict(pb, lut=p["q"]), p["leaves"], q8=True))
        if time_it:
            x, f, th, lut, q, sc, xb, w = (p[k] for k in ("x", "f", "th", "lut", "q", "sc",
                                                          "xb", "w"))
            kw = _budget(lambda: Q.fuzzy_lut_q8(x, f, th, q, sc))
            rec["ms32"], rec["ms8"] = abba_ms(lambda: K.fuzzy_lut(x, f, th, lut),
                                              lambda: Q.fuzzy_lut_q8(x, f, th, q, sc), **kw)
            plain = lambda: K.fuzzy_lut_plain(x, f, th, lut)      # noqa: E731
            rec["plain32"] = device_ms(plain, **_budget(plain))
            plain8 = lambda: Q.fuzzy_lut_q8_plain(x, f, th, q, sc)  # noqa: E731
            rec["plain8"] = device_ms(plain8, **_budget(plain8))
            mm = lambda: torch.matmul(xb, w)                      # noqa: E731
            rec["dense_ms"] = device_ms(mm, **_budget(mm))
            log(f"  {rec['tag']}: f32 {rec['ms32']:.5f} ms, int8 {rec['ms8']:.5f} ms (in "
                f"turns); bound f32 {rec['bound32'][0]:.6f} ms by {rec['bound32'][1]}, int8 "
                f"{rec['bound8'][0]:.6f} ms by {rec['bound8'][1]}; plain f32 "
                f"{rec['plain32']:.4f} ms, int8 {rec['plain8']:.4f} ms; the dense f32 product "
                f"it replaces ([T, D] x [D, N], torch.matmul) {rec['dense_ms']:.5f} ms on {smi}")
        out["times"].append(rec)
    out["launches"] = launches
    return out


def _budget(fn) -> dict:
    """device_ms arguments that keep one timing of ``fn`` near
    :data:`LM_TIME_BUDGET_S`: one call timed once with CUDA events decides
    the replays (and a single warm-up call for calls above 50 ms)."""
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    one = a.elapsed_time(b) / 1e3
    if one < 1e-3:
        return {}
    reps = max(1, min(25, int(LM_TIME_BUDGET_S / one) - 4))
    return dict(inner=1, reps=reps, warmup=1 if one > 0.05 else 3)


def lm_smoke_archs(device) -> list:
    """The other nine architectures at ``smoke_config``: ``forward_train``
    and ``LM_SMOKE_STEPS`` decode steps on ``device`` against the port's own
    CPU run on the same weights."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs.registry import ARCH_IDS, smoke_config
    from repro_torch.models.transformer import (
        decode_step, forward_train, init_decode_state, init_model,
    )

    cpu = torch.device("cpu")
    recs = []
    for arch in ARCH_IDS:
        if arch == LM_ARCH:
            continue
        cfg = smoke_config(arch)
        rng = np.random.default_rng(7)
        b, s = LM_SMOKE_B, LM_SMOKE_S
        arrays = {}
        if cfg.encoder_layers:
            arrays["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
            arrays["dec_tokens"] = rng.integers(0, cfg.vocab_size, (b, 16)).astype(np.int32)
        elif cfg.frontend_stub:
            arrays["embeds"] = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        else:
            arrays["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        enc = (rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
               if cfg.encoder_layers else None)
        toks = rng.integers(0, cfg.vocab_size, (LM_SMOKE_STEPS, b, 1)).astype(np.int32)
        params_cpu = init_model(cfg, 0, dtype=torch.float32, device=cpu)
        runs = {}
        for dev, params in ((cpu, params_cpu), (device, copy.deepcopy(params_cpu).to(device))):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
            with torch.no_grad():
                logits, aux = forward_train(cfg, params, batch)
                state = init_decode_state(cfg, b, 64, dtype=torch.float32, device=dev)
                steps = []
                for t in range(LM_SMOKE_STEPS):
                    lg, state = decode_step(
                        cfg, params, state, torch.as_tensor(toks[t], device=dev), t,
                        enc_out=None if enc is None else torch.as_tensor(enc, device=dev))
                    steps.append(lg)
            runs[dev.type] = (logits.cpu(), aux.cpu(), torch.stack(steps).cpu(),
                              {k: v.cpu() for k, v in state.items()})
        (lc, ac, dc, sc), (lg, ag, dg, sg) = runs["cpu"], runs[device.type]
        errs = [_close(lg, lc, LM_SMOKE_TOL, f"{arch} forward_train"),
                _close(ag, ac, LM_SMOKE_TOL, f"{arch} aux"),
                _close(dg, dc, LM_SMOKE_TOL, f"{arch} decode logits")]
        errs += [_close(sg[k], sc[k], LM_SMOKE_TOL, f"{arch} state {k}") for k in sc]
        recs.append((arch, cfg.family, max(errs)))
        log(f"  {arch} ({cfg.family}) smoke: forward_train + {LM_SMOKE_STEPS} decode_steps "
            f"(logits and every state tensor) on {device} vs the CPU: max |diff| "
            f"{max(errs):.3e} (limit {LM_SMOKE_TOL})")
    return recs


def lm_phase(device, smi: str, *, rehearse: bool = False) -> dict:
    """Phase 9: Qwen2-VL-2B through the LM stack's serving path, its last
    FFN through the per-bank kernels, and the nine other architectures."""
    import torch

    from repro_torch.configs.registry import get_config, smoke_config

    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must stay f32 on the LM path (no TF32)")
    sizes = LM_REHEARSE if rehearse else LM_FULL
    cfg = smoke_config(LM_ARCH) if rehearse else get_config(LM_ARCH)
    t0 = time.perf_counter()
    dense = lm_dense(cfg, device, smi, **sizes)
    peg = lm_pegasus(cfg, dense, device, smi, time_it=device.type == "cuda", **sizes)
    smoke = lm_smoke_archs(device)
    res = dict(dense={k: v for k, v in dense.items() if k not in ("params", "ffn_in")},
               pegasus=peg, smoke=smoke, launches=peg["launches"],
               seconds=time.perf_counter() - t0)
    del dense
    return res


# ---------------------------------------------------------------------------
# Phase 10: the LM training path, Qwen2-VL-2B at its published width
# ---------------------------------------------------------------------------

# full size: 8 x 1024 tokens (phase 9's prefill shape), the reference's
# default remat ("nothing"), 6 steps through TrainLoop, then one profiled
TRAIN_FULL = dict(batch=8, seq=1024, steps=6, cut_layers=2, cut_batch=2, cut_seq=64,
                  cut_steps=2)
TRAIN_REHEARSE = dict(batch=2, seq=64, steps=3, cut_layers=2, cut_batch=2, cut_seq=16,
                      cut_steps=2)
# card vs CPU on train steps: f32 sums in another order (cuBLAS vs the
# CPU's BLAS, K up to 8,960), ~1e-6 relative per value. Loss and grad_norm
# relative; grads and m by relative L2 per leaf; v holds squares, so twice
# the relative error. Both devices step at one constant learning rate,
# TRAIN_LR (the default schedule's peak; its warmup starts at 0), and per
# leaf the change the steps made to the params is held by relative L2: a
# weight the steps did not move is off by 1. Adam's first update,
# g/(|g| + eps), passes on the relative error of each gradient element
# near eps whatever the learning rate: 1.4e-3 on Granite's wk after one step
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL, TRAIN_V_REL, TRAIN_MOVE_REL = 1e-5, 1e-4, 2e-4, 1e-2
TRAIN_LR = 3e-4
# the remat policies against each other: the same products recomputed
TRAIN_REMAT_REL = 1e-6
# crash recovery: the reference's own limits (tests/test_runtime.py)
RECOVERY_RTOL, RECOVERY_ATOL = 1e-5, 1e-6
TRAIN_SMOKE_B, TRAIN_SMOKE_S, TRAIN_SMOKE_STEPS = 2, 16, 2


def _rel_l2(got, want) -> float:
    import torch

    got, want = got.detach().cpu().to(torch.float64), want.detach().cpu().to(torch.float64)
    den = float(torch.linalg.vector_norm(want))
    num = float(torch.linalg.vector_norm(got - want))
    return num / den if den > 0 else num


def _held(errs: dict, limit: float, what: str) -> float:
    """Max of ``errs`` (name -> error); raises when one exceeds ``limit``."""
    bad = {k: e for k, e in errs.items() if not e <= limit}
    if bad:
        worst = max(bad, key=bad.get)
        raise AssertionError(f"{what}: {len(bad)} leaves above {limit}, worst {worst} "
                             f"{bad[worst]:.3e}")
    return max(errs.values(), default=0.0)


def train_compare(cfg, devices, *, batch: int, seq: int, steps: int) -> dict:
    """``steps`` train steps of ``cfg`` at the learning rate ``TRAIN_LR``
    from the same weights (drawn on the CPU from seed 0) and the same
    ``synthetic_batches`` on each of the two ``devices``: loss, grad_norm,
    gradients, m, v and what the steps so far moved each parameter, held
    at every step."""
    import copy

    import torch

    from repro_torch.launch.train import loss_and_grads, make_train_step, synthetic_batches
    from repro_torch.models.transformer import init_model
    from repro_torch.train.optimizer import adamw_init

    base = init_model(cfg, 0, dtype=torch.float32, device=torch.device("cpu"))
    before = {k: p.detach().clone() for k, p in base.named_parameters()}
    runs = {}
    for dev in devices:
        params = copy.deepcopy(base).to(dev).requires_grad_(True)
        opt = adamw_init(dict(params.named_parameters()))
        step = make_train_step(cfg, lr_fn=lambda _step: TRAIN_LR)
        batches = synthetic_batches(cfg, batch, seq, seed=3)
        rec = []
        for _ in range(steps):
            b = {k: v.to(dev) for k, v in next(batches).items()}
            _, grads = loss_and_grads(cfg, params, b)
            params, opt, m = step(params, opt, b)
            rec.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                            grads={k: g.cpu() for k, g in grads.items()},
                            m={k: t.cpu() for k, t in opt.m.items()},
                            v={k: t.cpu() for k, t in opt.v.items()},
                            moved={k: p.detach().cpu() - before[k]
                                   for k, p in params.named_parameters()}))
        runs[dev] = rec
        del params, opt
    want, got = runs[devices[0]], runs[devices[1]]
    out = dict(loss=0.0, grad_norm=0.0, losses=[r["loss"] for r in got])
    for i, (w, g) in enumerate(zip(want, got)):
        for key, tol in (("loss", TRAIN_LOSS_RTOL), ("grad_norm", TRAIN_GRAD_REL)):
            err = abs(g[key] - w[key]) / abs(w[key])
            if not (err <= tol and torch.isfinite(torch.tensor(g[key]))):
                raise AssertionError(f"{cfg.name} step {i} {key}: {g[key]} vs {w[key]} "
                                     f"(relative {err:.3e}, limit {tol})")
            out[key] = max(out[key], err)
        if not all(float(torch.linalg.vector_norm(t)) > 0 for t in w["moved"].values()):
            raise AssertionError(f"{cfg.name} step {i} left a parameter where it was")
        for key, tol in (("grads", TRAIN_GRAD_REL), ("m", TRAIN_GRAD_REL), ("v", TRAIN_V_REL),
                         ("moved", TRAIN_MOVE_REL)):
            out[key] = max(out.get(key, 0.0), _held(
                {k: _rel_l2(g[key][k], w[key][k]) for k in w[key]}, tol,
                f"{cfg.name} step {i} {key} (relative L2)"))
    return out


def remat_compare(cfg, device, *, batch: int, seq: int) -> dict:
    """``loss_and_grads`` under remat ``"nothing"``, ``"dots"`` and none on
    ``device``, from the same weights and batch: equal values (bit-equality
    reported), and the peak memory each call adds to what was allocated
    before it (the earlier calls' gradients stay allocated)."""
    import torch

    from repro_torch.launch.train import loss_and_grads, synthetic_batches
    from repro_torch.models.transformer import init_model

    params = init_model(cfg, 0, dtype=torch.float32, device=device).requires_grad_(True)
    b = {k: v.to(device) for k, v in next(synthetic_batches(cfg, batch, seq, seed=3)).items()}
    runs, peaks = {}, {}
    for policy in ("nothing", "dots", "none"):
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        runs[policy] = loss_and_grads(cfg, params, b, remat_policy=policy)
        if device.type == "cuda":
            peaks[policy] = torch.cuda.max_memory_allocated() - before
    loss0, g0 = runs["nothing"]
    out = dict(peaks=peaks, bit_equal={})
    for policy in ("dots", "none"):
        loss, g = runs[policy]
        errs = {k: _rel_l2(g[k], g0[k]) for k in g0}
        errs["loss"] = abs(float(loss) - float(loss0)) / abs(float(loss0))
        out[policy] = _held(errs, TRAIN_REMAT_REL, f"remat {policy!r} vs 'nothing'")
        out["bit_equal"][policy] = bool(torch.equal(loss, loss0)) and all(
            torch.equal(g[k], g0[k]) for k in g0)
    return out


def crash_recovery(cfg, device) -> float:
    """The reference's crash-recovery test on ``device``: 6 steps straight
    against 3 steps, a fresh ``TrainLoop`` that restores, and 3 more; every
    parameter within its limits. Returns the max |diff|."""
    import tempfile

    import torch

    from repro_torch.launch.train import TrainLoop, synthetic_batches
    from repro_torch.train.checkpoint import latest_step

    with tempfile.TemporaryDirectory() as tmp:
        loop = TrainLoop(cfg, device=device, ckpt_dir=f"{tmp}/a", ckpt_every=100)
        loop.run(synthetic_batches(cfg, 2, 16, seed=0), steps=6)
        straight = {k: p.detach().cpu() for k, p in loop.params.named_parameters()}
        del loop
        first = TrainLoop(cfg, device=device, ckpt_dir=f"{tmp}/b", ckpt_every=3)
        first.run(synthetic_batches(cfg, 2, 16, seed=0), steps=3)
        del first                                  # the "crash"
        loop = TrainLoop(cfg, device=device, ckpt_dir=f"{tmp}/b", ckpt_every=100)
        if loop.start_step != 3:
            raise AssertionError(f"restored at step {loop.start_step}, not 3")
        gen = synthetic_batches(cfg, 2, 16, seed=0)
        for _ in range(3):
            next(gen)
        loop.run(gen, steps=3)
        if latest_step(f"{tmp}/b") != 6:
            raise AssertionError(f"last checkpoint {latest_step(f'{tmp}/b')}, not 6")
        resumed = {k: p.detach().cpu() for k, p in loop.params.named_parameters()}
    for k, want in straight.items():
        torch.testing.assert_close(resumed[k], want, rtol=RECOVERY_RTOL, atol=RECOVERY_ATOL)
    return max(float((resumed[k] - straight[k]).abs().max()) for k in straight)


def checkpoint_roundtrip(cfg, device) -> dict:
    """One train step of ``cfg`` on ``device``, one ``AsyncCheckpointer``
    save of (params, AdamWState) and one ``restore`` into fresh tensors:
    bit-equal. Returns bytes and seconds."""
    import os
    import tempfile

    import torch

    from repro_torch.launch.train import make_train_step, synthetic_batches
    from repro_torch.models.transformer import init_model
    from repro_torch.train.checkpoint import AsyncCheckpointer, restore
    from repro_torch.train.optimizer import adamw_init

    params = init_model(cfg, 0, dtype=torch.float32, device=device)
    params.requires_grad_(True)
    opt = adamw_init(dict(params.named_parameters()))
    b = {k: v.to(device) for k, v in next(synthetic_batches(cfg, 2, 16, seed=3)).items()}
    params, opt, _ = make_train_step(cfg)(params, opt, b)
    with tempfile.TemporaryDirectory() as tmp:
        _sync(device)
        t0 = time.perf_counter()
        ck = AsyncCheckpointer(tmp)
        ck.save(1, (params, opt))
        handed = time.perf_counter() - t0
        ck.wait()
        save_s = time.perf_counter() - t0
        nbytes = sum(e.stat().st_size for e in os.scandir(f"{tmp}/step_1"))
        fresh = init_model(cfg, 1, dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        (got, got_opt), step = restore(tmp, (fresh, adamw_init(dict(fresh.named_parameters()))))
        _sync(device)
        restore_s = time.perf_counter() - t0
    named = dict(params.named_parameters())
    pairs = [(got_opt.step, opt.step)] + [
        (dict(got.named_parameters())[k], named[k]) for k in named] + [
        (got_opt.m[k], opt.m[k]) for k in named] + [(got_opt.v[k], opt.v[k]) for k in named]
    if step != 1 or not all(torch.equal(a, w) and a.device == w.device for a, w in pairs):
        raise AssertionError("the restored checkpoint is not bit-equal to what was saved")
    return dict(bytes=nbytes, tensors=len(pairs), handed_s=handed, save_s=save_s,
                restore_s=restore_s)


def train_phase(device, smi: str, *, rehearse: bool = False) -> dict:
    """Phase 10: Qwen2-VL-2B trained through ``TrainLoop`` at its published
    width; card against CPU, remat, crash recovery and a checkpoint on a
    2-layer cut; the nine other architectures card against CPU."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
    from repro_torch.launch.train import TrainLoop, synthetic_batches

    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("f32 matmuls must stay f32 on the LM path (no TF32)")
    sizes = TRAIN_REHEARSE if rehearse else TRAIN_FULL
    cfg = smoke_config(LM_ARCH) if rehearse else get_config(LM_ARCH)
    cpu, cuda = torch.device("cpu"), device.type == "cuda"
    t_phase = time.perf_counter()

    # (a) the published width through TrainLoop
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = TrainLoop(cfg, device=device, ckpt_dir=None, remat_policy="nothing",
                     dtype=torch.float32, seed=0)
    _sync(device)
    n_params = sum(p.numel() for p in loop.params.parameters())
    log(f"  {cfg.name}: {cfg.num_layers} layers, {n_params} f32 parameters, params + "
        f"AdamW state drawn on {device} in {time.perf_counter() - t0:.2f} s")
    batches = synthetic_batches(cfg, sizes["batch"], sizes["seq"], seed=0)
    steps = []
    for _ in range(sizes["steps"]):
        m = loop.run(batches, 1)
        steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                          s=loop.step_times[-1]))
    if not all(torch.isfinite(torch.tensor([s["loss"], s["grad_norm"]])).all() for s in steps):
        raise AssertionError(f"non-finite loss or grad_norm: {steps}")
    tokens = sizes["batch"] * sizes["seq"]
    step_s = float(sorted(s["s"] for s in steps[1:])[(len(steps) - 1) // 2])
    peak = torch.cuda.max_memory_allocated() if cuda else None
    rate = 6 * n_params * tokens / step_s
    for i, s in enumerate(steps):
        log(f"  step {i}: loss {s['loss']:.6f}, grad_norm {s['grad_norm']:.6f}, "
            f"{s['s']:.4f} s")
    log(f"  {cfg.name} trained {sizes['batch']} x {sizes['seq']} tokens a step, f32, remat "
        f"'nothing': median {step_s:.4f} s per step (steps 1-{len(steps) - 1}; step 0 "
        f"{steps[0]['s']:.4f} s), {tokens / step_s:.1f} tokens/s, 6·N·T/step "
        f"{rate / 1e12:.2f} TFLOP/s = {rate / F32_OPS_PER_S:.4f} of the f32 (non-tensor) "
        f"peak {F32_OPS_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{'not measured' if peak is None else f'{peak} B ({peak / 2**30:.2f} GiB)'} "
        f"(host clock ending in a sync) on {smi}")
    nxt = next(batches)
    prof = profile_fn(lambda: loop.run(iter([nxt]), 1)) if cuda else None
    del loop
    if cuda:
        torch.cuda.empty_cache()

    # (b) a 2-layer cut at the published width: card against CPU, remat
    cut = dataclasses.replace(cfg, num_layers=sizes["cut_layers"])
    kw = dict(batch=sizes["cut_batch"], seq=sizes["cut_seq"])
    cmp = train_compare(cut, (cpu, device), steps=sizes["cut_steps"], **kw)
    log(f"  {cut.name} cut to {cut.num_layers} layers, {sizes['cut_steps']} train steps of "
        f"{kw['batch']} x {kw['seq']} at lr {TRAIN_LR} on {device} vs the CPU: losses "
        f"{[round(x, 6) for x in cmp['losses']]} (relative {cmp['loss']:.3e}, limit "
        f"{TRAIN_LOSS_RTOL}), grad_norm {cmp['grad_norm']:.3e}, grads {cmp['grads']:.3e}, m "
        f"{cmp['m']:.3e} (limit {TRAIN_GRAD_REL}), v {cmp['v']:.3e} (limit {TRAIN_V_REL}), "
        f"change of the params {cmp['moved']:.3e} (limit {TRAIN_MOVE_REL}); relative L2 "
        f"per leaf, max")
    remat = remat_compare(cut, device, batch=sizes["batch"], seq=sizes["seq"])
    peaks = ", ".join(f"{k} {v} B ({v / 2**30:.2f} GiB)" for k, v in remat["peaks"].items())
    log(f"  remat on {device}, {cut.num_layers} layers, {sizes['batch']} x {sizes['seq']} "
        f"tokens: 'dots' {remat['dots']:.3e}, none {remat['none']:.3e} against 'nothing' "
        f"(relative L2, limit {TRAIN_REMAT_REL}; bit-equal {remat['bit_equal']}); peak memory "
        f"added by loss_and_grads: {peaks or 'not measured'} on {smi}")

    # (c) crash recovery, (d) the 2-layer state checkpointed
    rec_err = crash_recovery(smoke_config(LM_ARCH), device)
    log(f"  crash recovery on {device}: 6 steps straight vs 3 + restore + 3, max |diff| "
        f"{rec_err:.3e} (rtol {RECOVERY_RTOL}, atol {RECOVERY_ATOL})")
    ck = checkpoint_roundtrip(cut, device)
    log(f"  checkpoint of the {cut.num_layers}-layer state ({ck['tensors']} tensors, "
        f"{ck['bytes']} B on disk): AsyncCheckpointer.save returned in {ck['handed_s']:.3f} s, "
        f"written in {ck['save_s']:.3f} s ({ck['bytes'] / ck['save_s'] / 1e9:.3f} GB/s); "
        f"restore {ck['restore_s']:.3f} s; bit-equal, on {smi}")

    # (e) the nine other architectures
    smoke = []
    for arch in ARCH_IDS:
        if arch == LM_ARCH:
            continue
        scfg = smoke_config(arch)
        r = train_compare(scfg, (cpu, device), batch=TRAIN_SMOKE_B, seq=TRAIN_SMOKE_S,
                          steps=TRAIN_SMOKE_STEPS)
        smoke.append((arch, scfg.family, r))
        log(f"  {arch} ({scfg.family}) smoke: {TRAIN_SMOKE_STEPS} train steps on {device} vs "
            f"the CPU: loss {r['loss']:.3e}, grad_norm {r['grad_norm']:.3e}, grads "
            f"{r['grads']:.3e}, m {r['m']:.3e}, v {r['v']:.3e}, change of the params "
            f"{r['moved']:.3e}")
    return dict(steps=steps, step_s=step_s, tokens_per_s=tokens / step_s, peak=peak,
                rate=rate, n_params=n_params, profile=prof, cut=cmp, remat=remat,
                recovery=rec_err, checkpoint=ck, smoke=smoke,
                seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# Phase 11: the mesh
# ---------------------------------------------------------------------------

# (a) every served model's plan split into 4 row shards; a ragged batch
MESH_SHARDS, MESH_RAGGED = 4, 1037
# (b) Server and (c) TrainLoop on a (1, 1) mesh: phases 9-10's shapes
MESH_FULL = dict(batch=8, kv_len=64, max_new=32, profile_steps=8, train_batch=8,
                 train_seq=1024, train_steps=3)
MESH_REHEARSE = dict(batch=2, kv_len=16, max_new=4, profile_steps=2, train_batch=2,
                     train_seq=64, train_steps=3)
MESH_LOSS_RTOL = 1e-6
# (d) the supported cells of LM_ARCH on the 256-rank production mesh, each
# plain, then train_4k in 8 microbatches and prefill/decode with the
# reference's --optimized knobs; a rank's train_4k FLOPs at 8 microbatches
# stay within MESH_MICROBATCH_FLOPS_RATIO of one microbatch's
MESH_CELLS = (("train_4k", {}), ("train_4k", {"microbatches": 8}), ("prefill_32k", {}),
              ("prefill_32k", {"optimized": True}), ("decode_32k", {}),
              ("decode_32k", {"optimized": True}))
MESH_MICROBATCH_FLOPS_RATIO = 1.1


def sharded_plans(res, fams, device, smi: str) -> dict:
    """(a) The six served models of phases 4-5, each plan built with
    ``devices=(device,) * 4``: served on kernel and kernel_q8 in turns with
    the single-device plan (single, sharded, sharded, single), outputs
    bit-equal, and at a ragged batch; the sharded runs' launches exactly
    four shards times the family's launches per batch."""
    import numpy as np
    import torch

    from repro_torch.engine import bucket_chunks
    from repro_torch.kernels.fuzzy_lut import _lib
    from repro_torch.launch.serve import PegasusServer

    devs = (device,) * MESH_SHARDS
    launches, rates = dict.fromkeys(_lib.LAUNCHES, 0), {}
    for name in MODELS:
        src = res if name == "mlp" else fams[name]
        reqs = src["request_list"]
        inputs = (src["x"],) if name == "mlp" else src["inputs"]
        ragged = tuple(a[:MESH_RAGGED] for a in inputs)
        flows = sum(r.flows for r in reqs)
        for backend in ("kernel", "kernel_q8"):
            single = PegasusServer(src["model"], backend=backend, device=device)
            sharded = PegasusServer(src["model"], backend=backend, devices=devs)
            if sharded.plan.compile_stats()["devices"] != MESH_SHARDS:
                raise AssertionError(f"{name}: the plan is not sharded over {MESH_SHARDS}")
            want = np.concatenate([r.output for r in single.serve(reqs)])
            sharded.serve(reqs)                          # first use of every bucket
            runs, outs = [], []
            for which in ("single", "sharded", "sharded", "single"):
                server = single if which == "single" else sharded
                _sync(device)
                _lib.reset_launches()
                results, dt = _timed_serve(server, reqs, device)
                got = dict(_lib.LAUNCHES)
                outs.append(np.concatenate([r.output for r in results]))
                runs.append((which, dt, got))
            if not all(np.array_equal(o, want) for o in outs):
                err = max(float(np.abs(o - want).max()) for o in outs)
                raise AssertionError(f"{name} {backend}: sharded outputs differ from the "
                                     f"single-device plan's (max |diff| {err})")
            _lib.reset_launches()
            a = sharded.plan(*ragged, backend=backend)
            got_ragged = dict(_lib.LAUNCHES)
            b = single.plan(*ragged, backend=backend)
            if not torch.equal(a, b):
                raise AssertionError(f"{name} {backend}: sharded ragged batch of "
                                     f"{MESH_RAGGED} differs from the single-device plan")
            batches = len(bucket_chunks(flows, sharded.plan.buckets, sharded.max_batch))
            for which, _, got in runs:
                if which == "sharded":
                    for k, n in got.items():
                        launches[k] += n
            for k, n in got_ragged.items():
                launches[k] += n
            if device.type == "cuda":
                per = {(k if backend == "kernel" else Q8_NAME[k]): n
                       for k, n in PER_BATCH[name].items()}
                expect = {k: n * batches * MESH_SHARDS for k, n in per.items()}
                for which, _, got in runs:
                    if which == "sharded" and {k: n for k, n in got.items() if n} != expect:
                        raise AssertionError(f"{name} {backend} sharded: launches {got}; "
                                             f"expected {expect}")
            t_single = sum(dt for w, dt, _ in runs if w == "single")
            t_sharded = sum(dt for w, dt, _ in runs if w == "sharded")
            rates[(name, backend)] = dict(single=2 * flows / t_single,
                                          sharded=2 * flows / t_sharded)
            log(f"  {name:6s} {backend:9s} {MESH_SHARDS} shards on {device}: bit-equal at "
                f"{len(reqs)} requests and a ragged batch of {MESH_RAGGED}; flows/s single "
                f"{rates[(name, backend)]['single']:.1f}, sharded "
                f"{rates[(name, backend)]['sharded']:.1f} (in turns) on {smi}")
    return dict(rates=rates, launches=launches)


def _one_rank_mesh(device):
    """A (1, 1) ("data", "model") mesh over a one-rank process group: NCCL
    on the card (one rank per GPU), gloo on the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device.type, (1, 1), mesh_dim_names=("data", "model"))


def mesh_server(cfg, mesh, device, smi: str, sizes: dict) -> dict:
    """(b) ``Server`` on the (1, 1) mesh against the unsharded ``Server``:
    identical tokens; tokens/s of both in turns; the idle share over the
    meshed server's decode steps."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import Server

    kw = dict(kv_len=sizes["kv_len"], batch_size=sizes["batch"], dtype=torch.float32)
    plain = Server(cfg, device=device, **kw)
    meshed = Server(cfg, mesh=mesh, **kw)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(sizes["batch"], 1)).astype(np.int32)
    plain.generate(prompts, max_new=2)                   # first use
    meshed.generate(prompts, max_new=2)
    outs, times = {}, {"plain": [], "mesh": []}
    for which in ("plain", "mesh", "mesh", "plain"):
        server = plain if which == "plain" else meshed
        _sync(device)
        t0 = time.perf_counter()
        outs.setdefault(which, []).append(server.generate(prompts, max_new=sizes["max_new"]))
        _sync(device)
        times[which].append(time.perf_counter() - t0)
    ref = outs["plain"][0]
    if not all(np.array_equal(o, ref) for v in outs.values() for o in v):
        raise AssertionError("Server on the (1, 1) mesh: tokens differ from the unsharded "
                             "Server's")
    tokens = sizes["batch"] * sizes["max_new"]
    rate = {k: 2 * tokens / sum(v) for k, v in times.items()}
    prof = profile_fn(lambda: meshed.generate(prompts, max_new=sizes["profile_steps"])) \
        if device.type == "cuda" else None
    del plain, meshed
    return dict(tokens_per_s=rate, profile=prof, tokens=ref)


def mesh_trainloop(cfg, mesh, device, smi: str, sizes: dict) -> dict:
    """(c) ``TrainLoop`` on the (1, 1) mesh against the unsharded loop, one
    after the other (two full-width train states do not fit at once): the
    losses per step within ``MESH_LOSS_RTOL``; seconds per step and peak
    memory of both."""
    import torch

    from repro_torch.launch.train import TrainLoop, synthetic_batches

    cuda = device.type == "cuda"
    out = {}
    for which in ("plain", "mesh"):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        loop = TrainLoop(cfg, mesh=mesh if which == "mesh" else None, device=device,
                         ckpt_dir=None, dtype=torch.float32, seed=0)
        batches = synthetic_batches(cfg, sizes["train_batch"], sizes["train_seq"], seed=0)
        losses = [float(loop.run(batches, 1)["loss"]) for _ in range(sizes["train_steps"])]
        out[which] = dict(losses=losses, step_s=loop.step_times,
                          peak=torch.cuda.max_memory_allocated() if cuda else None,
                          placed=all(hasattr(p, "placements") for p in loop.params.parameters()))
        del loop
    if not out["mesh"]["placed"]:
        raise AssertionError("TrainLoop on the mesh: its params are not DTensors")
    errs = [abs(a - b) / abs(b) for a, b in zip(out["mesh"]["losses"], out["plain"]["losses"])]
    if not max(errs) <= MESH_LOSS_RTOL:
        raise AssertionError(f"TrainLoop on the (1, 1) mesh: losses {out['mesh']['losses']} "
                             f"vs {out['plain']['losses']} (relative {max(errs):.3e}, limit "
                             f"{MESH_LOSS_RTOL})")
    out["loss_rel"] = max(errs)
    if cuda:
        torch.cuda.empty_cache()
    return out


def mesh_dryrun(arch: str, *, smoke: bool) -> list:
    """(d) The supported cells of ``arch`` on the 256-rank production mesh
    over a fake process group (no card, no allocation), each with the
    knobs of ``MESH_CELLS``; raises when a rank's train_4k FLOPs at 8
    microbatches exceed ``MESH_MICROBATCH_FLOPS_RATIO`` times one
    microbatch's (the rank's work would grow with the batch's cut)."""
    from repro_torch.launch.dryrun import dryrun_cell

    rows = []
    for cell, knobs in MESH_CELLS:
        r = dryrun_cell(arch, cell, smoke=smoke, **knobs)
        if "skipped" in r or not r["flops"] > 0:
            raise AssertionError(f"dry-run {arch} {cell} {knobs}: {r}")
        if r["kind"] == "train" and not r["collective_total"] > 0:
            raise AssertionError(f"dry-run {arch} {cell}: a train step moved no collective")
        r["knobs"] = knobs
        rows.append(r)
    one, eight = rows[0], rows[1]       # train_4k at 1 and 8 microbatches
    if eight["flops"] > MESH_MICROBATCH_FLOPS_RATIO * one["flops"]:
        raise AssertionError(
            f"dry-run {arch} train_4k: FLOPs/rank at 8 microbatches {eight['flops']:.4e} "
            f"exceed {MESH_MICROBATCH_FLOPS_RATIO} x those at 1 ({one['flops']:.4e})")
    return rows


def mesh_phase(res, fams, device, smi: str, *, rehearse: bool = False) -> dict:
    """Phase 11: the sharded plan; ``Server`` and ``TrainLoop`` on a (1, 1)
    mesh; the dry-run of LM_ARCH's supported cells."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config, smoke_config

    sizes = MESH_REHEARSE if rehearse else MESH_FULL
    cfg = smoke_config(LM_ARCH) if rehearse else get_config(LM_ARCH)
    t_phase = time.perf_counter()
    log("  (a) every served model's plan sharded over 4 row shards:")
    t0 = time.perf_counter()
    plans = sharded_plans(res, fams, device, smi)
    plans["seconds"] = time.perf_counter() - t0
    mesh = _one_rank_mesh(device)
    try:
        t0 = time.perf_counter()
        srv = mesh_server(cfg, mesh, device, smi, sizes)
        srv["seconds"] = time.perf_counter() - t0
        r = srv["tokens_per_s"]
        log(f"  (b) Server on a (1, 1) mesh, {cfg.name}, f32, {sizes['batch']} prompts x "
            f"{sizes['max_new']} tokens: tokens identical to the unsharded Server's; "
            f"tokens/s unsharded {r['plain']:.1f}, meshed {r['mesh']:.1f} (in turns, host "
            f"clock ending in a sync; mesh/plain {r['mesh'] / r['plain']:.4f}) on {smi}")
        prof = srv["profile"]
        if prof is not None:
            log(f"      profiler window ({sizes['profile_steps']} meshed decode steps, {smi}): "
                f"window {prof['window_us']:.1f} us, device busy {prof['busy_us']:.1f} us, "
                f"idle share {prof['idle_share']:.4f}")
        elif device.type == "cuda":
            log("      profiler window: device time not measured (no device events)")
        t0 = time.perf_counter()
        tr = mesh_trainloop(cfg, mesh, device, smi, sizes)
        tr["seconds"] = time.perf_counter() - t0
        for which in ("plain", "mesh"):
            w = tr[which]
            steps = ", ".join(f"{x:.4f}" for x in w["step_s"])
            peak = "not measured" if w["peak"] is None else \
                f"{w['peak']} B ({w['peak'] / 2**30:.2f} GiB)"
            log(f"  (c) TrainLoop {which:5s} {sizes['train_batch']} x {sizes['train_seq']} "
                f"tokens: losses {[round(x, 7) for x in w['losses']]}, s/step [{steps}], "
                f"peak memory {peak} on {smi}")
        log(f"      losses within {tr['loss_rel']:.3e} relative (limit {MESH_LOSS_RTOL})")
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    rows = mesh_dryrun(LM_ARCH, smoke=rehearse)
    for r in rows:
        t = r["roofline"]
        log(f"  (d) dry-run {r['arch']} {r['shape']} {r['knobs'] or 'plain'} on {r['mesh']} "
            f"({r['ranks']} fake ranks): trace {r['trace_s']} s; FLOPs/device "
            f"{r['flops']:.4e} (analytic {r['analytic_flops']:.4e}, ratio "
            f"{r['flops'] / r['analytic_flops']:.4f}); collective B/device {r['collective_total']} "
            f"{ {k: v for k, v in r['collective_bytes'].items() if v} } by axis "
            f"{r['collective_by_axis']}; peak bytes/device {r['memory']['peak_bytes']}; "
            f"roofline on the H100 SXM5 datasheet (700 W): compute {t['compute_s'] * 1e3:.3f} "
            f"ms, memory {t['memory_s'] * 1e3:.3f} ms, collective {t['collective_s'] * 1e3:.3f} "
            f"ms, {t['dominant']}-bound, bound {t['bound_step_s']:.6g} s")
    one, eight = rows[0], rows[1]       # MESH_CELLS' order
    log(f"      train_4k at 8 microbatches / 1: FLOPs/rank {eight['flops'] / one['flops']:.4f} "
        f"(limit {MESH_MICROBATCH_FLOPS_RATIO}), collective B "
        f"{eight['collective_total'] / one['collective_total']:.4f}, peak "
        f"{eight['memory']['peak_bytes'] / one['memory']['peak_bytes']:.4f}")
    plain, knobs = rows[4], rows[5]
    log(f"      decode_32k --optimized / plain: collective B "
        f"{knobs['collective_total'] / plain['collective_total']:.4f}, FLOPs/rank "
        f"{knobs['flops'] / plain['flops']:.4f}")
    dry_s = time.perf_counter() - t0
    return dict(plans=plans, server=srv, train=tr, dryrun=rows, dryrun_s=dry_s,
                launches=plans["launches"], seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# Phase 12: the example scripts on the card
# ---------------------------------------------------------------------------

EXAMPLES = ROOT / "examples" / "torch"
# serve_batched's backends, each in the sync and async flavour, then one
# run with a deadline on every request
EXAMPLE_BACKENDS = ("gather", "kernel", "kernel_q8")
EXAMPLE_DEADLINE_MS = 150.0
# CPU rehearsal sizes; the card runs every script at the reference's
EXAMPLES_REHEARSE = dict(
    quickstart=dict(flows_per_class=48, steps=5, refine_steps=2, depth=3,
                    request_sizes=(12, 5)),
    anomaly_detection=dict(flows_per_class=48, steps=5, depth=4),
    serve_batched=dict(flows_per_class=48, steps=5),
    train_distributed=["--steps", "12", "--batch", "2", "--seq", "16"])


def _example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kw):
    """``fn``'s result and seconds, its prints kept back (shown if it raises)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(*args, **kw)
    except BaseException:
        print(buf.getvalue(), flush=True)
        raise
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def _plain_int8_plans():
    """Plans built inside run the int8 kernels' plain versions in their
    place, on the same device: the served int8 path with no kernel in it."""
    from repro_torch.engine import plan as P
    from repro_torch.kernels.fuzzy_lut import quantized as Q

    saved = P.fuzzy_lut_q8, P.fuzzy_lut_stack_q8
    P.fuzzy_lut_q8 = lambda *a: Q.fuzzy_lut_q8_plain(*a)[0]
    P.fuzzy_lut_stack_q8 = lambda *a, ks, n_out: Q.fuzzy_lut_stack_q8_plain(*a, ks, n_out)[0]
    try:
        yield
    finally:
        P.fuzzy_lut_q8, P.fuzzy_lut_stack_q8 = saved


def _same_outputs(got: dict, want: dict) -> bool:
    """Served outputs (lists of arrays by model) equal, bit for bit."""
    import numpy as np

    return got.keys() == want.keys() and all(
        len(got[name]) == len(outs) and all(np.array_equal(a, b) for a, b in zip(got[name], outs))
        for name, outs in want.items())


def example_serving(device, smi: str, *, rehearse: bool) -> dict:
    """serve_batched: the three teachers trained and pegasusified once, then
    served on gather, kernel and kernel_q8, each sync and async, and async
    on kernel with a deadline. ``kernel`` bit-equal to ``gather``; each
    ``kernel_q8`` flavour bit-equal to the same flavour served with the
    int8 kernels' plain versions in their place (phase 1 holds each kernel
    bit-equal to its plain version; these runs launch no kernel and are
    not counted); no drain error, no fallback batch; without a deadline
    nothing is shed; on the card gather launches no kernel and each kernel
    run launches only its own, all four across the kernel runs."""
    from repro_torch.kernels.fuzzy_lut import _lib

    sb = _example("serve_batched")
    kw = EXAMPLES_REHEARSE["serve_batched"] if rehearse else {}
    (ds, models), build_s = _quiet(sb.build_models, device, **kw)
    log(f"  serve_batched: 3 teachers trained ({kw.get('steps', 120)} steps) and "
        f"pegasusified in {build_s:.2f} s")
    runs, launches, walls = {}, dict.fromkeys(_lib.LAUNCHES, 0), []
    configs = [(b, sync, None) for b in EXAMPLE_BACKENDS for sync in (True, False)]
    configs.append(("kernel", False, EXAMPLE_DEADLINE_MS))
    for backend, sync, deadline in configs:
        before = dict(_lib.LAUNCHES)
        r, wall = _quiet(sb.serve, models, ds, device, backend=backend, sync=sync,
                         deadline_ms=deadline)
        got = {k: n - before[k] for k, n in _lib.LAUNCHES.items() if n > before[k]}
        walls.append(wall)
        for k, n in got.items():
            launches[k] += n
        if r["drain_errors"] or any(r["fallback_batches"].values()):
            raise AssertionError(f"serve_batched {backend} {r['mode']}: drain errors "
                                 f"{r['drain_errors']}, fallback {r['fallback_batches']}")
        if deadline is None and r["shed"]:
            raise AssertionError(f"serve_batched {backend} {r['mode']}: {r['shed']} shed")
        if device.type == "cuda":
            allowed = {"gather": set(), "kernel": {"fuzzy_lut", "fuzzy_lut_stack"},
                       "kernel_q8": {"fuzzy_lut_q8", "fuzzy_lut_stack_q8"}}[backend]
            if not set(got) <= allowed or (backend != "gather" and set(got) != allowed):
                raise AssertionError(f"serve_batched {backend} {r['mode']}: launches {got}")
        runs[(backend, sync, deadline)] = r
        tag = r["mode"] + ("" if deadline is None else f", deadline {deadline:.0f} ms")
        log(f"  serve_batched --backend {backend:9s} ({tag}): {r['flows_per_s']:.1f} flows/s "
            f"aggregate ({r['flows_per_burst']} flows in {r['burst_ms']:.3f} ms a burst, "
            f"{r['batches_per_burst']} batches), shed {r['shed']}, launches {got}, run "
            f"{wall:.2f} s on {smi}")
    for sync in (True, False):
        if not _same_outputs(runs[("kernel", sync, None)]["outputs"],
                             runs[("gather", sync, None)]["outputs"]):
            raise AssertionError(f"serve_batched: kernel differs from gather (sync={sync})")
        before = dict(_lib.LAUNCHES)
        with _plain_int8_plans():
            plain, _ = _quiet(sb.serve, models, ds, device, backend="kernel_q8", sync=sync)
        if _lib.LAUNCHES != before:
            raise AssertionError(f"serve_batched plain int8 run launched kernels: "
                                 f"{before} -> {_lib.LAUNCHES}")
        if not _same_outputs(runs[("kernel_q8", sync, None)]["outputs"], plain["outputs"]):
            raise AssertionError(f"serve_batched: kernel_q8 differs from its plain int8 "
                                 f"version (sync={sync})")
    if device.type == "cuda":
        missing = [k for k, n in launches.items() if not n]
        if missing:
            raise AssertionError(f"serve_batched launched no {missing}")
    log(f"  serve_batched: kernel bit-equal to gather and kernel_q8 bit-equal to its plain "
        f"int8 version (sync and async), 0 fallback batches, launches {launches}")
    return dict(runs=runs, seconds=build_s + sum(walls))


def examples_phase(device, smi: str, *, rehearse: bool = False) -> dict:
    """Phase 12: the four ``examples/torch`` scripts in process at the
    reference scripts' sizes (``rehearse``: throwaway sizes on the CPU):
    quickstart, anomaly_detection, serve_batched (see
    :func:`example_serving`) and train_distributed twice into one
    checkpoint directory, the second run resuming where the first ended."""
    import math
    import tempfile

    from repro_torch.kernels.fuzzy_lut import _lib

    on = ["--device", device.type]
    t_phase = time.perf_counter()
    _lib.reset_launches()
    qs, qs_s = _quiet(_example("quickstart").main, on,
                      **(EXAMPLES_REHEARSE["quickstart"] if rehearse else {}))
    if not all(math.isfinite(qs[k]) for k in ("f1_dense", "f1_pegasus", "agreement")):
        raise AssertionError(f"quickstart: {qs}")
    log(f"  quickstart {qs_s:.2f} s: macro-F1 dense {qs['f1_dense']:.4f}, pegasus "
        f"{qs['f1_pegasus']:.4f}; integer agreement {qs['agreement']:.4f}; Table 6 "
        f"{qs['table6_row']!r}, violations {qs['violations'] or 'none'}; served "
        f"{qs['served']['flows']} flows on {qs['served']['streams']} stream(s) on {smi}")
    ad, ad_s = _quiet(_example("anomaly_detection").main, on,
                      **(EXAMPLES_REHEARSE["anomaly_detection"] if rehearse else {}))
    if not all(math.isfinite(v["auc"]) for v in ad.values()):
        raise AssertionError(f"anomaly_detection: {ad}")
    log(f"  anomaly_detection {ad_s:.2f} s: "
        + ", ".join(f"{k} AUC {v['auc']:.4f} caught {v['caught']:.4f}" for k, v in ad.items())
        + f" on {smi}")
    serving = example_serving(device, smi, rehearse=rehearse)

    td = _example("train_distributed")
    argv = on + (EXAMPLES_REHEARSE["train_distributed"] if rehearse else [])
    with tempfile.TemporaryDirectory(prefix="pegasus_ckpt_") as d:
        first, first_s = _quiet(td.main, argv + ["--ckpt", d])
        again, again_s = _quiet(td.main, argv + ["--ckpt", d])
    launches = dict(_lib.LAUNCHES)
    steps = first["step"]
    if (first["resumed_from"] is not None or again["resumed_from"] != steps
            or again["step"] != 2 * steps or again["checkpoints"][-1] != 2 * steps
            or not math.isfinite(again["loss"])):
        raise AssertionError(f"train_distributed: first {first}, resumed {again}")
    log(f"  train_distributed: {steps} steps in {first_s:.2f} s (loss {first['loss']:.4f}, "
        f"median {first['median_step_s']:.4f} s a step), resumed at {again['resumed_from']} "
        f"and ended at {again['step']} in {again_s:.2f} s (loss {again['loss']:.4f}); "
        f"checkpoints {again['checkpoints']}; mesh {again['mesh']} on {smi}")
    return dict(quickstart=qs, anomaly=ad, serving=serving, train=(first, again),
                wall_s=dict(quickstart=qs_s, anomaly_detection=ad_s,
                            serve_batched=serving["seconds"], train_distributed=first_s + again_s),
                launches=launches, seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at tiny size with the plain versions; "
                         "prints no result line")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    _setup_path()
    import torch

    if args.rehearse:
        device = torch.device("cpu")
        check_kernels(device, t=64, time_it=False)
        res = main_path(device, flows_per_class=48, steps=5, depth=3, n_serve=300)
        check_family_kernels(device, rows=64, time_it=False)
        fams = families_phase(device, flows_per_class=48, steps=5, tiny=True, n_serve=300)
        multi = multi_model_phase(res, fams, device, "the CPU (rehearsal)")
        refined = refinement_phase(res, fams, device, "the CPU (rehearsal)",
                                   baseline_steps=5, cnn_m_steps=3)
        audit_phase(res, fams, multi, refined, device, "the CPU (rehearsal)")
        dataplane_phase(res, fams, refined, device, "the CPU (rehearsal)")
        lm_phase(device, "the CPU (rehearsal)", rehearse=True)
        train_phase(device, "the CPU (rehearsal)", rehearse=True)
        mesh_phase(res, fams, device, "the CPU (rehearsal)", rehearse=True)
        examples_phase(device, "the CPU (rehearsal)", rehearse=True)
        log(f"rehearsal done: teacher F1 {res['teacher_f1']:.4f}")
        return 0

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"device: {kind} (count {count}), torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = _nvidia_smi()
    log(f"nvidia-smi: {smi}")

    from repro_torch.kernels.fuzzy_lut import _lib

    t0 = time.perf_counter()
    built = _lib.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name, text in sorted(_lib.build_log().items()):
        for line in text.splitlines():
            if any(w in line for w in ("registers", "Compiling entry", "spill")):
                log(f"  ptxas[{name}]: {line.strip()}")

    log("kernels vs plain versions:")
    checks = check_kernels(device)
    for name, rec in checks.items():
        n = rec["timed_launches"]
        log(f"  {name}: max_abs_err {rec['max_abs_err']}, {rec['ms']:.5f} ms for {n} "
            f"launch(es), {rec['ms'] / n:.5f} ms per launch (plain {rec['plain_ms']:.5f} ms, "
            f"bound {rec['bound_ms']:.6f} ms by {rec['bound_by']}: {rec['nbytes']} B, "
            f"{rec['ops']} ops)")
    for f32, q8 in (("fuzzy_lut_stack", "fuzzy_lut_stack_q8"), ("fuzzy_lut", "fuzzy_lut_q8")):
        a, b = checks[f32]["ms"], checks[q8]["ms"]
        log(f"  f32 vs int8, timed in turns: {f32} {a:.5f} ms, {q8} {b:.5f} ms "
            f"(f32/int8 = {a / b:.3f}, int8/f32 = {b / a:.3f}) on {smi}")
    log("kernels vs plain versions at the family geometries:")
    for rec in check_family_kernels(device):
        checks[rec["kernel"]]["max_abs_err"] = max(checks[rec["kernel"]]["max_abs_err"],
                                                   rec["max_abs_err"])
        log(f"  {rec['geom']:13s} {rec['kernel']:19s} max_abs_err {rec['max_abs_err']}, "
            f"{rec['ms']:.5f} ms per launch (plain {rec['plain_ms']:.5f} ms, bound "
            f"{rec['bound_ms']:.6f} ms by {rec['bound_by']}: {rec['nbytes']} B, "
            f"{rec['ops']} ops) on {smi}")

    log("main path:")
    res = main_path(device)
    for (backend, fuse), run in res["runs"].items():
        log(f"  {backend:9s} fuse={fuse!s:5s} {run['flows_per_s']:.1f} flows/s, "
            f"served macro-F1 {run['f1']:.4f} (teacher {res['teacher_f1']:.4f})")

    prof = res["profile"]
    if prof is None:
        log("profiler window (kernel_q8 fused served run): device time not measured "
            "(the trace holds no device events)")
    else:
        log(f"profiler window (kernel_q8 fused served run, {smi}): window "
            f"{prof['window_us']:.1f} us, device busy {prof['busy_us']:.1f} us, idle share "
            f"{prof['idle_share']:.4f}")
        for name, us in prof["by_name"].items():
            log(f"  device {us:10.1f} us  {name[:110]}")

    log("families:")
    fams = families_phase(device)
    for key, what in (("profile", "graphs"), ("profile_eager", "eager, jit=False")):
        prof = fams["rnn"][key]
        if prof is None:
            log(f"profiler window (rnn kernel served run, {what}): device time not "
                "measured (the trace holds no device events)")
            continue
        log(f"profiler window (rnn kernel served run, {what}, {smi}): window "
            f"{prof['window_us']:.1f} us, device busy {prof['busy_us']:.1f} us, idle share "
            f"{prof['idle_share']:.4f}")
        for name, us in prof["by_name"].items():
            log(f"  device {us:10.1f} us  {name[:110]}")

    log("many models behind one server:")
    multi = multi_model_phase(res, fams, device, smi)

    log("refinement:")
    refined = refinement_phase(res, fams, device, smi)

    log("the plan audit on the card:")
    t0 = time.perf_counter()
    audit_phase(res, fams, multi, refined, device, smi)
    log("the dataplane on the card:")
    dataplane_phase(res, fams, refined, device, smi)
    log(f"phase 8 took {time.perf_counter() - t0:.2f} s")

    log(f"the LM stack: {LM_ARCH} at its published width:")
    lm = lm_phase(device, smi)
    prof = lm["dense"]["profile"]
    if prof is None:
        log("profiler window (8 decode steps): device time not measured (the trace holds "
            "no device events)")
    else:
        log(f"profiler window (8 decode steps of {LM_ARCH}, batch {LM_FULL['batch']}, {smi}): "
            f"window {prof['window_us']:.1f} us, device busy {prof['busy_us']:.1f} us, idle "
            f"share {prof['idle_share']:.4f}")
        for name, us in list(prof["by_name"].items())[:25]:
            log(f"  device {us:10.1f} us  {name[:110]}")
    for rec in lm["pegasus"]["times"]:
        for name, key in (("fuzzy_lut", "err32"), ("fuzzy_lut_q8", "err8")):
            checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], rec[key])
    log(f"phase 9 took {lm['seconds']:.2f} s")

    log(f"the LM training path: {LM_ARCH} at its published width:")
    tr = train_phase(device, smi)
    prof = tr["profile"]
    if prof is None:
        log("profiler window (one train step): device time not measured (the trace holds "
            "no device events)")
    else:
        log(f"profiler window (one train step of {LM_ARCH}, {TRAIN_FULL['batch']} x "
            f"{TRAIN_FULL['seq']} tokens, {smi}): window {prof['window_us']:.1f} us, device "
            f"busy {prof['busy_us']:.1f} us, idle share {prof['idle_share']:.4f}")
        for name, us in list(prof["by_name"].items())[:25]:
            log(f"  device {us:10.1f} us  {name[:110]}")
    log(f"phase 10 took {tr['seconds']:.2f} s")

    log("the mesh:")
    mesh = mesh_phase(res, fams, device, smi)
    log(f"phase 11 took {mesh['seconds']:.2f} s ((a) {mesh['plans']['seconds']:.2f} s, (b) "
        f"{mesh['server']['seconds']:.2f} s, (c) {mesh['train']['seconds']:.2f} s, (d) "
        f"{mesh['dryrun_s']:.2f} s)")

    log("the example scripts (examples/torch) at the reference scripts' sizes:")
    ex = examples_phase(device, smi)
    log(f"phase 12 took {ex['seconds']:.2f} s (wall seconds per script: "
        + ", ".join(f"{k} {v:.2f}" for k, v in ex["wall_s"].items())
        + f"); kernel launches {ex['launches']} on {smi}")

    log(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    lines = []
    for name, source, replaces in KERNELS:
        rec = checks[name]
        launches = (res["launches"][name] + sum(f["launches"][name] for f in fams.values())
                    + multi["launches"][name] + refined["launches"][name]
                    + lm["launches"][name] + mesh["launches"][name] + ex["launches"][name])
        lines.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=None, lm_launches=lm["launches"][name],
            mesh_launches=mesh["launches"][name], example_launches=ex["launches"][name]))
    log(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
