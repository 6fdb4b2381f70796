"""Machine-checked invariants of the port (port of the JAX package's
``analysis/``), three layers over one policy module (:mod:`.rules`):

* :mod:`.lint` — the AST pass behind ``python -m repro_torch.analysis
  src/repro_torch`` (PG001-PG004, with torch's host syncs and graph
  captures in its tables);
* :mod:`.sanitizer` — the ``PEGASUS_SANITIZE=1`` runtime half:
  ``make_lock`` (lock-order cycle + hierarchy detection, the hierarchy
  PG003 shares) and ``ThreadAffinity`` assertions;
* :mod:`.planaudit` — the plan audit behind ``python -m
  repro_torch.analysis plan`` (PGA101-PGA106): numerics, shared memory per
  launch on Hopper, the bulk-copy rule, fusion splits and the dataplane
  fit of compiled plans, wired into ``build_plan(..., audit=...)`` and
  every server's ``stats()``.
"""

from .lint import Finding, lint_file, lint_paths, lint_source, main
from .planaudit import (AuditConfig, AuditFinding, AuditReport,
                        PlanAuditError, audit_plan)
from .rules import PGA_RULES, RULES
from .sanitizer import (InstrumentedLock, LockOrderError, ThreadAffinity,
                        ThreadAffinityError, enabled, make_lock,
                        reset_lock_graph)

__all__ = [
    "Finding", "lint_file", "lint_paths", "lint_source", "main", "RULES",
    "PGA_RULES", "AuditConfig", "AuditFinding", "AuditReport",
    "PlanAuditError", "audit_plan",
    "InstrumentedLock", "LockOrderError", "ThreadAffinity",
    "ThreadAffinityError", "enabled", "make_lock", "reset_lock_graph",
]
