"""Build and load the fuzzy-LUT CUDA kernels (``csrc/*.cu``).

Each ``.cu`` source compiles with ``nvcc`` into its own shared library with
a plain C interface, loaded through ``ctypes``. The build happens at first
use, from the sources in this package only, into ``build/kernels/`` at the
repository root (listed in ``.gitignore``); a library's file name carries a
hash of its sources and flags, so an edited source is never served by a
stale build. All sources compile in parallel, one ``nvcc`` each.

Nothing here falls back: without CUDA or ``nvcc`` :func:`library` raises.
Each wrapper counts its launches in :data:`LAUNCHES` through
:func:`count_launch` — one per kernel launch, nowhere else — so a run can
show that it went through the kernels. A wrapper called while a CUDA graph
is captured launches nothing: under :func:`recording` its counts go to the
capture's tally instead, and each replay of the graph adds that tally
(:func:`add_launches`), so the counts keep meaning launches executed.
:func:`graph_kernel_nodes` counts every kernel a captured graph holds, the
port's own and torch's alike, through the CUDA driver.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["F32Geom", "LAUNCHES", "MAX_L", "Q8Geom", "add_launches", "build_all",
           "build_log", "check_status", "count_launch", "graph_kernel_nodes", "library",
           "recording", "reset_launches"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = {"bank": "fuzzy_lut_bank.cu", "stack": "fuzzy_lut_stack.cu",
           "q8_bank": "fuzzy_lut_q8_bank.cu", "q8_stack": "fuzzy_lut_q8_stack.cu"}
HEADERS = ("fuzzy_lut_f32.cuh", "fuzzy_lut_q8.cuh")

# Must equal F32_MAX_L in csrc/fuzzy_lut_f32.cuh.
MAX_L = 16

LAUNCHES = {"fuzzy_lut": 0, "fuzzy_lut_q8": 0, "fuzzy_lut_stack": 0,
            "fuzzy_lut_stack_q8": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOG: dict[str, str] = {}
_LOCK = threading.Lock()
# LAUNCHES is bumped from the drain thread, infer() callers and the stream
# pool's workers at once: a read-modify-write under a lock loses nothing
_COUNT_LOCK = threading.Lock()
_TLS = threading.local()


class F32Geom(ctypes.Structure):
    """By-value geometry of an f32 launch; mirrors ``struct F32Geom``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "L", "k0", "kmax", "nmax", "n_out", "v", "depth", "kpad", "regs",
        "width", "kstride")] + [("ks", ctypes.c_int * MAX_L)]


class Q8Geom(ctypes.Structure):
    """By-value geometry of an int8 launch; mirrors ``struct Q8Geom``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "L", "k0", "kmax", "nmax", "n_out", "v", "depth", "width", "kstride",
        "rows", "nchunks", "nstages", "nfills", "slot_bytes")]


def reset_launches() -> None:
    with _COUNT_LOCK:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` — or, inside :func:`recording` on this
    thread, one kernel node of the graph being captured."""
    tally = getattr(_TLS, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def add_launches(tally: dict[str, int]) -> None:
    """Count the launches of one replay of a graph whose capture recorded
    ``tally``."""
    with _COUNT_LOCK:
        for name, n in tally.items():
            LAUNCHES[name] += n


@contextlib.contextmanager
def recording():
    """Tally this thread's kernel launches into the yielded dict instead of
    :data:`LAUNCHES` (around a CUDA graph capture, which launches nothing)."""
    tally: dict[str, int] = {}
    _TLS.tally = tally
    try:
        yield tally
    finally:
        _TLS.tally = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(path, os.X_OK):
        raise RuntimeError("nvcc not found: the fuzzy-LUT CUDA kernels are "
                           "built from source at first use")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name], *HEADERS):
        h.update((CSRC / fname).read_bytes())
    return BUILD_DIR / f"libfuzzy_lut_{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every source not yet built, all in parallel.

    Returns seconds per library built (empty when all were current);
    raises ``RuntimeError`` with the compiler's output on a failure.
    """
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    secs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        _LOG[name] = log
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def build_log() -> dict[str, str]:
    """The compiler's output (``-Xptxas -v`` register/shared-memory report)
    of each library built by this process."""
    return dict(_LOG)


_ARGTYPES = {
    "fuzzy_lut_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int, F32Geom] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p],
    "fuzzy_lut_q8": [ctypes.c_void_p] * 8 + [ctypes.c_int, Q8Geom] + [ctypes.c_int] * 3
                    + [ctypes.c_void_p],
    "fuzzy_lut_stack_f32": [ctypes.c_void_p] * 7 + [ctypes.c_int, F32Geom]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "fuzzy_lut_stack_q8": [ctypes.c_void_p] * 9 + [ctypes.c_int, Q8Geom]
                          + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
_LIB_OF = {"fuzzy_lut_f32": "bank", "fuzzy_lut_q8": "q8_bank",
           "fuzzy_lut_stack_f32": "stack", "fuzzy_lut_stack_q8": "q8_stack",}


def library(fn_name: str):
    """The C entry point ``fn_name`` with its ``argtypes`` set, building and
    loading its library on first use. Raises ``RuntimeError`` without CUDA,
    without ``nvcc``, or off a Hopper (sm_90) card."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the fuzzy-LUT kernels "
                           "run only on an NVIDIA GPU")
    name = _LIB_OF[fn_name]
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            major, minor = torch.cuda.get_device_capability()
            if (major, minor) != (9, 0):
                raise RuntimeError(
                    f"the fuzzy-LUT kernels are built for sm_90a (H100/H200); "
                    f"this card is sm_{major}{minor}")
            if not _target(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            for fn, lib_name in _LIB_OF.items():
                if lib_name == name:
                    getattr(lib, fn).argtypes = _ARGTYPES[fn]
                    getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return getattr(lib, fn_name)


# CUgraphNodeType (cuda.h): a kernel node; copies (1), memsets (2) and the
# other kinds are not kernels the graph launches
_KERNEL_NODE = 0


def _driver() -> ctypes.CDLL:
    """The CUDA driver library, which a process that uses CUDA has loaded."""
    with _LOCK:
        drv = _LIBS.get("driver")
        if drv is None:
            drv = ctypes.CDLL("libcuda.so.1")
            drv.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                            ctypes.POINTER(ctypes.c_size_t)]
            drv.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
            for fn in (drv.cuGraphGetNodes, drv.cuGraphNodeGetType):
                fn.restype = ctypes.c_int
            _LIBS["driver"] = drv
    return drv


def graph_kernel_nodes(raw_graph: int) -> int:
    """Kernel nodes of a captured CUDA graph (``raw_graph``: the
    ``cudaGraph_t`` of ``torch.cuda.CUDAGraph(keep_graph=True)
    .raw_cuda_graph()``, before or after ``instantiate``): the kernels one
    replay launches, the port's and torch's alike. Copy and memset nodes
    are not counted."""
    drv = _driver()

    def call(fn, *args):
        status = fn(*args)
        if status != 0:
            raise RuntimeError(f"{fn.__name__} failed with CUDA driver error {status}")

    n = ctypes.c_size_t(0)
    call(drv.cuGraphGetNodes, raw_graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call(drv.cuGraphGetNodes, raw_graph, nodes, ctypes.byref(n))
    kind = ctypes.c_int()
    kernels = 0
    for node in nodes[:n.value]:
        call(drv.cuGraphNodeGetType, node, ctypes.byref(kind))
        kernels += kind.value == _KERNEL_NODE
    return kernels


def check_status(status: int, fn_name: str) -> None:
    """Raise if a launch reported a CUDA error (a refused launch — too many
    threads or too much shared memory — reports only here)."""
    if status != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {status}")
