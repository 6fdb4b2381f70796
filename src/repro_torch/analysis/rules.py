"""Rule registry and policy tables of the port's analysis (port of the JAX
package's ``analysis/rules.py``).

Pure data: rule IDs, the comment grammar, the call tables the AST passes
in :mod:`repro_torch.analysis.lint` consult, and the thresholds of the plan
audit (:mod:`repro_torch.analysis.planaudit`). The lock hierarchy is not
restated here: PG003 ranks a lock by the name it was created under
(``make_lock("<name>")``) in :data:`repro_torch.analysis.sanitizer.LOCK_RANKS`,
the table the runtime sanitizer checks, so the static and the dynamic
checks share one hierarchy. The kernel limits the audit prices against are
imported from the kernels' own modules, never restated as numbers.

Comment grammar (parsed by regex out of the token stream):

``# guarded-by: <lock>``
    On (or directly above) a ``self.<attr> = ...`` assignment: every later
    touch of ``<attr>`` anywhere in the module must happen under a ``with``
    on a lock whose attribute name matches ``<lock>`` (PG002).

``# holds: <lock>``
    On (or directly above) a ``def``: the function's contract is that the
    CALLER already holds ``<lock>`` — its body is checked as if the lock
    were held.

``# pegasus-lint: disable=PG001,PG004 <reason>``
    Suppress those rules on this line (or the line below, when the comment
    stands alone). The reason is MANDATORY — a bare disable is itself a
    finding (PG000).

``# pegasus-lint: disable-block=PG004 <reason>``
    Same, but on a compound statement's header line it suppresses the whole
    statement body.
"""

from __future__ import annotations

import re

from repro_torch.kernels.fuzzy_lut._lib import MAX_L
from repro_torch.kernels.fuzzy_lut.kernel import SMEM_PER_BLOCK, STACK_ROW_BYTES
from repro_torch.kernels.fuzzy_lut.quantized import BULK_ALIGN

from .sanitizer import LOCK_RANKS

RULES = {
    "PG000": "malformed suppression or annotation (disable= needs rule IDs "
             "and a written reason; guarded-by must sit on an attribute "
             "assignment)",
    "PG001": "plan build, blocking call or host sync (.cpu(), .item(), "
             ".numpy(), .tolist(), synchronize) inside a `with <lock>:` body",
    "PG002": "attribute annotated `# guarded-by: <lock>` touched without "
             "holding that lock",
    "PG003": "lock acquired against the declared hierarchy "
             "(sanitizer.LOCK_RANKS: registry -> scheduler -> counters)",
    "PG004": "impure operation inside a plan forward (`forward`/`_pure`) or "
             "a CUDA graph capture: a host sync, a host->device tensor from "
             "Python data, time/random/print/open, a lock, or a mutation of "
             "nonlocal state",
}

# Condition variables share their underlying lock: holding or acquiring the
# condition IS holding the lock (the scheduler's _space/_work and the device
# pool's _work are conditions on _lock).
LOCK_ALIASES = {
    "_space": "_lock",
    "_work": "_lock",
}

# The factory whose string argument names a lock in LOCK_RANKS.
LOCK_FACTORY = "make_lock"

# -- PG001 classification ---------------------------------------------------

# Plan construction entry points: a build under a lock stalls every other
# thread for as long as the build takes (the registry builds OUTSIDE its lock).
PLAN_CALLS = frozenset({"build_plan", "plan_for"})

# Dotted calls that block the calling thread outright.
BLOCKING_DOTTED = frozenset({"time.sleep", "concurrent.futures.wait"})

# Final attribute names that block: thread.join() and future.result().
# (str.join on a literal separator is exempted by the walker; Condition
# .wait() is NOT listed — it releases the lock while parked.)
BLOCKING_FINAL_ATTRS = frozenset({"join", "result"})

# Final attribute names that wait for the GPU: copies to the host and
# scalar reads wait for every queued kernel of the stream, and
# ``synchronize`` (torch.cuda, an Event or a Stream) waits outright.
HOST_SYNC_FINAL_ATTRS = frozenset({"cpu", "item", "numpy", "tolist", "synchronize"})

# Receiver-sensitive blocking methods: ``.get()``/``.put()`` block only on
# queue-like receivers and ``.wait()`` only on event-like ones — dict.get
# and Condition.wait stay exempt. The walker matches the receiver's final
# name component (case-insensitive substring) against these hints.
BLOCKING_RECEIVER_HINTS = {
    "get": ("queue", "inbox", "mailbox", "_q"),
    "put": ("queue", "inbox", "mailbox", "_q"),
    "wait": ("event", "evt", "done", "ready", "stopped", "barrier"),
}


def blocking_receiver(attr: str, receiver: str | None,
                      n_pos_args: int = 0) -> bool:
    """True when ``receiver.attr(...)`` matches the queue/event blocking
    table. A blocking ``Queue.get()`` takes no positional argument
    (``dict.get(key)`` always does), and a plural queue-like name
    (``_queues``) is a container of queues."""
    hints = BLOCKING_RECEIVER_HINTS.get(attr)
    if not hints or not receiver:
        return False
    if attr == "get" and n_pos_args:
        return False
    low = receiver.lower()
    if attr in ("get", "put") and low.endswith("s"):
        return False
    for h in hints:
        if h.startswith("_"):          # suffix hints: "work_q", or bare "q"
            if low == h.lstrip("_") or low.endswith(h):
                return True
        elif h in low:
            return True
    return False

# -- PG004 classification ---------------------------------------------------

# Plan forwards: every structural forward is a local function with one of
# these names; the with-body of a CUDA graph capture is checked alike.
PURE_FUNC_NAMES = frozenset({"forward", "_pure"})
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph"})

# A host->device tensor from Python data: torch.tensor always copies from
# the host; torch.as_tensor does when given a list, tuple or comprehension.
H2D_ALWAYS = frozenset({"torch.tensor"})
H2D_OF_PYTHON_DATA = frozenset({"torch.as_tensor"})

# Call roots that are side-effecting or nondeterministic in a forward.
IMPURE_ROOTS = frozenset({"time", "random"})
IMPURE_DOTTED_PREFIXES = (("np", "random"), ("numpy", "random"))
IMPURE_BUILTINS = frozenset({"print", "open", "input"})

# Method names that mutate their receiver — calling one on a NONLOCAL
# object from inside a forward is a side effect a graph replay skips.
MUTATOR_METHODS = frozenset({
    "add", "append", "appendleft", "extend", "extendleft", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "insert",
})

# Roots whose attribute calls are tensor/array ops, never receiver mutation
# (torch.add is addition, not set.add).
SAFE_MUTATOR_ROOTS = frozenset({"torch", "np", "numpy", "functools", "math", "F"})

# -- PGA1xx: plan-audit policy (repro_torch.analysis.planaudit) -------------

PGA_RULES = {
    "PGA101": "fixed-point overflow: the worst-case int32 accumulator bound "
              "of a bank's q8 tables (all groups rescaled to the finest "
              "group scale) exceeds int32 (error) or is within 2x of it "
              "(warning)",
    "PGA102": "quantization fidelity: a bank's worst-case q8 dequantization "
              "error vs its f32 LUT exceeds the configured per-group "
              "relative tolerance (stale/tampered q8 table)",
    "PGA103": "shared-memory footprint: a step's CUDA launch on either "
              "kernel design (plan_f32, plan_q8), at the rows per block of "
              "the largest bucket, needs more shared memory per block than "
              "the budget, or its planner refuses the geometry (error); the "
              "bytes, rows, ring slots and routes are an info note",
    "PGA104": "bulk-copy rule: an int8 column tile whose LUT row segments "
              "are no multiple of 16 bytes is copied a byte at a time by one "
              "warp instead of by bulk async copies (warning); other parts "
              "outside a stage's bulk mask are copied cooperatively (info)",
    "PGA105": "fusion rejection: an adjacent chained bank pair did not fuse "
              "(v/C mismatch, chaining break, nmax_cap split, fuse=False, "
              "or a family builder without the fusion pass)",
    "PGA106": "dataplane resource fit: the plan lowered to a MAT pipeline "
              "exceeds the declared switch target's SRAM/TCAM/bus/PHV "
              "budget (error); recirculation passes are a warning",
}

INT32_MAX = 2**31 - 1

# PGA101: warn when the overflow bound is within this factor of int32.
PGA101_MARGIN = 2.0

# PGA102: max per-group relative dequant error. Symmetric int8
# round-to-nearest guarantees err <= scale/2 = amax/254 (~0.4% of the
# group's amax); 1% only trips when the q8 table no longer matches the f32
# LUT it claims to quantize.
PGA102_REL_TOL = 1.0 / 100.0

# PGA103: the shared memory one block may opt into on Hopper, the budget
# both kernel designs plan against. No margin warning: plan_q8 sizes its
# two ring slots to fill the block, so every int8 launch sits within 1%.
PGA103_SMEM_BUDGET = SMEM_PER_BLOCK
# SMs a plan on the CPU is priced with (an H100 SXM); a CUDA plan uses its
# device's count.
H100_SXM_SMS = 132

# PGA104: the size and address multiple of a bulk async copy.
PGA104_BULK_ALIGN = BULK_ALIGN

# PGA105: the splits fuse_banks makes besides the reference's.
PGA105_MAX_L = MAX_L
PGA105_STACK_ROW_BYTES = STACK_ROW_BYTES

# -- comment grammar --------------------------------------------------------

GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w]*)")
HOLDS_RE = re.compile(r"#\s*holds:\s*([A-Za-z_][\w]*)")
SUPPRESS_RE = re.compile(
    r"#\s*pegasus-lint:\s*(disable|disable-block)=([A-Za-z0-9,]*)\s*(.*)")


def canonical_lock(name: str) -> str | None:
    """Canonical lock name for an attribute name, or None if it is not a
    lock: condition aliases map to their lock, and anything else must end
    in ``lock`` (``_lock``, ``_ctr_lock``, ``lock``, ...)."""
    name = LOCK_ALIASES.get(name, name)
    return name if name.lower().endswith("lock") else None


def lock_rank(qualified_name: str) -> int | None:
    """The hierarchy rank of a lock created as ``make_lock(qualified_name)``
    (None: unranked, cycle detection only)."""
    return LOCK_RANKS.get(qualified_name)
