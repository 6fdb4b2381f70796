"""PlanRegistry: named + memoized ExecutionPlans with weakref lifetimes
(port of ``repro.engine.registry``).

**Anonymous memo.** :meth:`PlanRegistry.plan_for` (and the module-level
:func:`plan_for` every ``pegasus_*_apply`` entry point goes through) is a
memoized :func:`~repro_torch.engine.plan.build_plan`:

  * Entries are *weakref-watched*: the registry never pins the caller's
    model (plans hold replicas of the banks, see ``CompiledBank``), and a
    weakref callback on each watched object evicts the entry once the model
    is garbage-collected, so a dropped model frees its plan and a recycled
    ``id()`` can never alias a stale one.
  * The memo is LRU-bounded (``max_plans``) and explicitly evictable
    (:meth:`discard` / :meth:`clear`).
  * A hit requires the same model identity, the same bank layers in plan
    order and an unchanged non-bank aux token (window, NAM flag, bias,
    logit LUT — ``plan._model_aux``); anything else rebuilds.
  * The key holds the build options: the device, the sharded ``devices``
    tuple, ``fuse``, ``fuse_nmax_cap``, the bucket ladder and the plan's
    default backend.

**Named entries** (:meth:`register` / :meth:`get`) are the serving
surface: ``register("rnn-ids", model)`` pins the model and its plan under
a stable name until :meth:`evict`. ``get`` revalidates against the live
model (bank swaps, aux reassignment) and recompiles, so a served name
never returns stale tables; :meth:`get_with_backend` is the fallback
ladder's entry (the same model built for another backend). A ``chaos``
hook (``None`` by default) fires ``plan_build`` at every named build.

**Thread safety:** the memo lives behind one lock, but plan builds run
outside it, so building a new model never stalls lookups of the others.
Racing first calls for one key are de-duplicated by a per-key in-flight
event: the first caller builds, later callers wait and take the memo hit.
A weakref callback never takes the lock (the collector may run it on a
thread that holds it); it queues the dead entry, and the next locked
operation drops it.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Any

from repro_torch.analysis.planaudit import audit_plan
from repro_torch.analysis.sanitizer import make_lock
from repro_torch.device import resolve_device

from .plan import (
    DEFAULT_FUSE_NMAX_CAP,
    STATS,
    ExecutionPlan,
    _aux_matches,
    _model_aux,
    _model_banks,
    _model_key,
    build_plan,
    resolve_devices,
)

__all__ = ["PlanRegistry", "plan_for", "reset_plan_cache", "default_registry"]


class _Entry:
    """One memoized plan + weakrefs to every object whose death evicts it."""

    __slots__ = ("key", "plan", "wrapper_ref", "bank_refs", "__weakref__")

    def __init__(self, key: tuple, model: Any, plan: ExecutionPlan, on_death) -> None:
        self.key = key
        self.plan = plan
        watch = list(_model_banks(model))
        # identity check, not `in`: dataclass __eq__ on tensor fields is
        # elementwise and has no truth value
        self.wrapper_ref = None
        if not isinstance(model, (list, tuple)) and all(model is not w for w in watch):
            try:
                self.wrapper_ref = weakref.ref(model, on_death)
            except TypeError:
                pass  # slotted wrappers: the bank refs carry eviction
        self.bank_refs = tuple(weakref.ref(b, on_death) for b in watch)

    def is_fresh(self, model: Any) -> bool:
        if self.wrapper_ref is not None and self.wrapper_ref() is not model:
            return False
        banks_now = _model_banks(model)
        if len(banks_now) != len(self.bank_refs):
            return False
        if any(r() is not b for r, b in zip(self.bank_refs, banks_now)):
            return False
        return _aux_matches(self.plan._aux_token, _model_aux(model))


class PlanRegistry:
    """Owns ExecutionPlans: a bounded weakref-watched memo plus named,
    strongly-pinned serving entries. See the module docstring."""

    def __init__(self, max_plans: int = 64):
        self.max_plans = max_plans
        # fault-injection hook (repro_torch.launch.chaos), assigned by
        # MultiModelServer.install_chaos() or directly in tests; duck-typed
        # so the engine never imports the launch layer
        self.chaos = None
        self._lock = make_lock("registry._lock")
        self._memo: OrderedDict[tuple, _Entry] = OrderedDict()   # guarded-by: _lock
        self._named: dict[str, dict] = {}                        # guarded-by: _lock
        # key → Event: a build in progress; later same-key callers wait for
        # it instead of compiling a duplicate (builds run OUTSIDE _lock)
        self._building: dict[tuple, threading.Event] = {}        # guarded-by: _lock
        # entries whose model died; appended by weakref callbacks without
        # the lock (list.append is atomic), dropped by _purge under it
        self._dead: list[tuple[tuple, _Entry]] = []

    # holds: _lock
    def _purge(self) -> None:
        """Drop the entries of dead models. Call with ``_lock`` held."""
        while self._dead:
            key, entry = self._dead.pop()
            if self._memo.get(key) is entry:
                del self._memo[key]

    def plan_for(self, model: Any, **kw) -> ExecutionPlan:
        """Memoized :func:`build_plan`. The build options are part of the
        key, so one model may hold e.g. fused and unfused, or CPU and GPU,
        plans side by side. The audit mode does not change the compiled
        plan: it is popped before keying, so ``audit="off"`` and the
        default share one plan (audited or not by whichever built it)."""
        audit = kw.pop("audit", "warn")
        if kw.get("bucket_sizes") is not None:
            kw["bucket_sizes"] = tuple(kw["bucket_sizes"])
        # an absent knob keys like its build_plan default
        kw["fuse"] = bool(kw.get("fuse", True))
        cap = kw.get("fuse_nmax_cap", DEFAULT_FUSE_NMAX_CAP)
        kw["fuse_nmax_cap"] = None if cap is None else int(cap)
        # devices keys as its resolved tuple, so devices=2 and the equal
        # device tuple share one plan, and an absent knob keys as None
        kw["devices"] = resolve_devices(kw.get("devices"))
        dev = kw.get("device")
        kw["device"] = (kw["devices"][0] if kw["devices"] is not None and dev is None
                        else resolve_device(dev))
        key = _model_key(model, kw)
        while True:
            with self._lock:
                self._purge()
                entry = self._memo.get(key)
                if entry is not None:
                    if entry.is_fresh(model):
                        STATS.plan_cache_hits += 1
                        self._memo.move_to_end(key)
                        return entry.plan
                    self._memo.pop(key, None)  # stale: bank/aux reassignment
                inflight = self._building.get(key)
                if inflight is None:
                    done = self._building[key] = threading.Event()
                    break                      # this thread builds
            # same-key build in progress elsewhere: wait, then re-check the
            # memo (a hit on success; after a failed build, build here)
            inflight.wait()
        try:
            plan = build_plan(model, audit=audit, **kw)
        except BaseException:
            with self._lock:
                self._building.pop(key, None)
            done.set()
            raise
        holder: list = []

        def on_death(_ref, registry=weakref.ref(self)):
            reg = registry()
            if reg is not None and holder:
                reg._dead.append((key, holder[0]))

        entry = _Entry(key, model, plan, on_death)
        holder.append(entry)
        with self._lock:
            self._purge()
            self._building.pop(key, None)
            while len(self._memo) >= self.max_plans:
                self._memo.popitem(last=False)
            self._memo[key] = entry
        done.set()
        return plan

    def discard(self, model: Any) -> int:
        """Explicitly evict every memo entry built for ``model`` (any build
        options). Returns the number of entries dropped."""
        banks = _model_banks(model)
        with self._lock:
            self._purge()
            doomed = [k for k, e in list(self._memo.items())
                      if (e.wrapper_ref is not None and e.wrapper_ref() is model)
                      or (banks and len(banks) == len(e.bank_refs)
                          and all(r() is b for r, b in zip(e.bank_refs, banks)))]
            for k in doomed:
                del self._memo[k]
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._memo.clear()
            self._named.clear()
            self._dead.clear()

    def __len__(self) -> int:
        with self._lock:
            self._purge()
            return len(self._memo)

    def cache_info(self) -> dict:
        with self._lock:
            self._purge()
            return {"entries": len(self._memo), "capacity": self.max_plans,
                    "named": sorted(self._named)}

    # -- named serving entries ----------------------------------------------

    def _fire(self, name: str, backend: str) -> None:
        chaos = self.chaos
        if chaos is not None:
            chaos.fire("plan_build", model=name, backend=backend)

    def register(self, name: str, model: Any, *, backend: str = "onehot",
                 **build_kw) -> ExecutionPlan:
        """Compile (or reuse) a plan for ``model`` and pin it under ``name``.
        Re-registering a name replaces its entry and discards the replaced
        model's memo entries — unless old and new wrap the SAME bank
        objects, whose memo entry is the new model's too."""
        t0 = time.perf_counter()
        self._fire(name, backend)
        plan = self.plan_for(model, backend=backend, **build_kw)
        build_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            old = self._named.get(name)
            self._named[name] = {
                "model": model,
                # the named store carries its own freshness watcher: a
                # named plan survives memo LRU churn without recompiling
                "entry": _Entry(None, model, plan, lambda _ref: None),
                "backend": backend,
                "build_kw": dict(build_kw),
                "plan_build_ms": build_ms,
                "recompiles": 0,
            }
        if (old is not None and old["model"] is not model
                and tuple(map(id, _model_banks(old["model"])))
                != tuple(map(id, _model_banks(model)))):
            self.discard(old["model"])
        return plan

    def get(self, name: str) -> ExecutionPlan:
        """The plan serving ``name`` — revalidated against the live model
        and rebuilt (outside the lock) on a bank or aux reassignment; a
        rebuild re-times ``plan_build_ms`` and counts in ``recompiles``."""
        with self._lock:
            ent = self._named[name]
            if ent["entry"].is_fresh(ent["model"]):
                return ent["entry"].plan
            model = ent["model"]
            backend, build_kw = ent["backend"], dict(ent["build_kw"])
        self._fire(name, backend)
        t0 = time.perf_counter()
        plan = self.plan_for(model, backend=backend, **build_kw)
        with self._lock:
            ent = self._named.get(name)
            if ent is None or ent["model"] is not model:
                return plan              # evicted or re-registered meanwhile
            ent["entry"] = _Entry(None, model, plan, lambda _ref: None)
            ent["plan_build_ms"] = (time.perf_counter() - t0) * 1e3
            ent["recompiles"] += 1
            return plan

    def get_with_backend(self, name: str, backend: str) -> ExecutionPlan:
        """A plan for the model serving ``name`` built for ``backend``
        instead of the registered one — the server's fallback-ladder entry.
        A memo hit once built (the backend is part of the key); the named
        entry keeps its preferred backend."""
        with self._lock:
            ent = self._named[name]
            model = ent["model"]
            build_kw = dict(ent["build_kw"])
        self._fire(name, backend)
        return self.plan_for(model, backend=backend, **build_kw)

    def plans(self) -> list[ExecutionPlan]:
        """Every plan the registry holds, named or memoized (a fallback
        backend's too), each once."""
        with self._lock:
            held = [ent["entry"].plan for ent in self._named.values()]
            held += [ent.plan for ent in self._memo.values()]
        return list({id(plan): plan for plan in held}.values())

    def backend_of(self, name: str) -> str:
        """The registered (preferred) backend serving ``name``."""
        with self._lock:
            return self._named[name]["backend"]

    def model(self, name: str) -> Any:
        with self._lock:
            return self._named[name]["model"]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._named)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._named

    def evict(self, name: str) -> bool:
        """Drop a named entry and its memo entries."""
        with self._lock:
            ent = self._named.pop(name, None)
        if ent is None:
            return False
        self.discard(ent["model"])
        return True

    def audit_report(self, name: str):
        """The plan-audit report of the plan serving ``name``
        (:class:`repro_torch.analysis.planaudit.AuditReport`). A plan built
        with ``audit="off"`` is audited here, once, and the report cached
        on the plan, so ``stats()`` reports counts from then on. Runs
        outside the registry lock."""
        plan = self.get(name)
        if plan.audit_report is None:
            plan.audit_report = audit_plan(plan)
        return plan.audit_report

    def stats(self) -> dict:
        """Per-name compile-cache + build stats (the serving ops surface)."""
        with self._lock:
            entries = sorted(self._named.items())
            return {
                name: {
                    "backend": ent["backend"],
                    "plan_build_ms": ent["plan_build_ms"],
                    "recompiles": ent["recompiles"],
                    "num_banks": ent["entry"].plan.num_banks,
                    "table_bytes": ent["entry"].plan.table_bytes(),
                    **ent["entry"].plan.compile_stats(),
                }
                for name, ent in entries
            }


# ---------------------------------------------------------------------------
# Default (module-global) registry — the plan_for every entry point hits.
# ---------------------------------------------------------------------------

_DEFAULT = PlanRegistry()


def default_registry() -> PlanRegistry:
    return _DEFAULT


def plan_for(model: Any, **kw) -> ExecutionPlan:
    """Memoized build_plan against the default registry. Pass the backend
    per call (``plan(x, backend=...)``); the build options (``device``,
    ``fuse``, ``fuse_nmax_cap``, ``bucket_sizes``) are part of the key."""
    return _DEFAULT.plan_for(model, **kw)


def reset_plan_cache() -> None:
    _DEFAULT.clear()
