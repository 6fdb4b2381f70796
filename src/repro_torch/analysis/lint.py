"""AST lint pass for the port's concurrency and capture invariants (port of
the JAX package's ``analysis/lint.py``, with torch in its tables).

Four rules (policy tables in :mod:`repro_torch.analysis.rules`):

PG001
    No plan builds (``build_plan``/``plan_for``), blocking calls
    (``time.sleep``, ``thread.join``, ``future.result``,
    ``concurrent.futures.wait``, queue/event waits) or host syncs
    (``.cpu()``, ``.item()``, ``.numpy()``, ``.tolist()``,
    ``torch.cuda.synchronize`` and ``Event``/``Stream.synchronize``)
    inside a ``with <lock>:`` body: each stalls every waiter for as long
    as the GPU or the other thread takes. ``Condition.wait`` is exempt
    because it releases the lock while parked. Kernel launches and graph
    replays under a lock are not findings: they enqueue work and return.

PG002
    An attribute assignment annotated ``# guarded-by: <lock>`` makes every
    later touch of that attribute (module-wide, by attribute name — locks
    are matched by NAME, the repo's one-lock-per-name convention) illegal
    outside a ``with`` on that lock. ``__init__`` bodies are exempt
    (construction precedes sharing); helpers whose contract is
    "caller holds the lock" carry ``# holds: <lock>``.

PG003
    Syntactically nested lock acquisitions must respect the declared
    hierarchy, outer->inner by ascending rank. A lock's rank is that of
    the name it was created under (``X = make_lock("<name>")``) in the
    runtime sanitizer's ``LOCK_RANKS``, so both checks read one table.
    Cross-function nesting is the runtime sanitizer's job.

PG004
    Plan forwards (functions named ``forward``/``_pure``) are captured into
    CUDA graphs and replayed: no host sync, no host->device tensor from
    Python data (``torch.tensor``, ``torch.as_tensor`` of a list), no
    ``time.*``/``random.*`` calls, no ``print``/``open``, no lock, no
    mutation of nonlocal state — a replay repeats the device work only.
    The body of a ``with torch.cuda.graph(...)`` capture may make no host
    sync and no host->device tensor from Python data either.

Findings are suppressed by ``# pegasus-lint: disable=PGxxx <reason>``
(same line or the line above) or ``disable-block=`` on a compound
statement's header; a suppression without a reason is itself a finding
(PG000).
"""

from __future__ import annotations

import ast
import io
import tokenize
from dataclasses import dataclass
from pathlib import Path

from . import rules as R

__all__ = ["Finding", "lint_source", "lint_file", "lint_paths", "main"]


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _final_name(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _with_locks(node: ast.With) -> list[str]:
    """Canonical lock names acquired by a with statement's items."""
    out = []
    for item in node.items:
        name = _final_name(item.context_expr)
        if name is None and isinstance(item.context_expr, ast.Call):
            # `with lock:` not `with open(...)` — but `with self._lock:`
            # is a bare attribute; a Call context (e.g. `with cond_for(x):`)
            # is not a lock by this convention
            continue
        if name is None:
            continue
        lock = R.canonical_lock(name)
        if lock is not None:
            out.append(lock)
    return out


class _Linter:
    def __init__(self, src: str, path: str, *,
                 lock_ranks: dict[str, int] | None = None):
        self.src = src
        self.path = path
        self.findings: list[Finding] = []
        self.comments = self._collect_comments(src)
        self.tree = ast.parse(src)
        self.ranks = (self._collect_lock_ranks(self.tree)
                      if lock_ranks is None else dict(lock_ranks))
        self.assign_attr_at = self._collect_attr_assign_lines(self.tree)
        self.guarded = self._collect_guarded()
        self.holds = self._collect_holds(self.tree)
        self.pure_defs = self._collect_pure_defs(self.tree)
        self.captures = self._collect_captures(self.tree)

    # -- plumbing -----------------------------------------------------------

    def _emit(self, rule: str, line: int, message: str) -> None:
        self.findings.append(Finding(self.path, line, rule, message))

    @staticmethod
    def _collect_comments(src: str) -> dict[int, str]:
        out: dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(src).readline):
                if tok.type == tokenize.COMMENT:
                    out[tok.start[0]] = tok.string
        except tokenize.TokenError:  # pragma: no cover - defensive
            pass
        return out

    @staticmethod
    def _collect_lock_ranks(tree: ast.Module) -> dict[str, int]:
        """canonical lock attribute -> rank, from ``X = make_lock("<name>")``
        assignments whose name the sanitizer's ``LOCK_RANKS`` ranks."""
        out: dict[str, int] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or not isinstance(node.value, ast.Call):
                continue
            call = node.value
            if _final_name(call.func) != R.LOCK_FACTORY or not call.args:
                continue
            arg = call.args[0]
            if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                continue
            rank = R.lock_rank(arg.value)
            for t in node.targets:
                lock = R.canonical_lock(_final_name(t) or "")
                if rank is not None and lock is not None:
                    out[lock] = rank
        return out

    @staticmethod
    def _collect_attr_assign_lines(tree: ast.Module) -> dict[int, str]:
        """line -> attribute name, for `self.x = ...` style assignments."""
        out: dict[int, str] = {}
        for node in ast.walk(tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute):
                    out.setdefault(t.lineno, t.attr)
        return out

    def _collect_guarded(self) -> dict[str, str]:
        """attribute name -> required lock name, from guarded-by comments
        (on the assignment line, or on a standalone line directly above)."""
        out: dict[str, str] = {}
        for line, comment in self.comments.items():
            m = R.GUARDED_BY_RE.search(comment)
            if not m:
                continue
            attr = (self.assign_attr_at.get(line)
                    or self.assign_attr_at.get(line + 1))
            if attr is None:
                self._emit("PG000", line,
                           "guarded-by comment is not attached to an "
                           "attribute assignment")
                continue
            out[attr] = m.group(1)
        return out

    def _collect_holds(self, tree: ast.Module) -> dict[ast.AST, list[str]]:
        """FunctionDef -> lock names the caller is contracted to hold."""
        out: dict[ast.AST, list[str]] = {}
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            locks = []
            for line in (node.lineno, node.lineno - 1):
                comment = self.comments.get(line)
                if comment:
                    m = R.HOLDS_RE.search(comment)
                    if m:
                        lock = R.canonical_lock(m.group(1)) or m.group(1)
                        locks.append(lock)
            if locks:
                out[node] = locks
        return out

    # -- PG004 prep ---------------------------------------------------------

    @staticmethod
    def _collect_pure_defs(tree: ast.Module) -> list[ast.FunctionDef]:
        """Every def named by convention is a plan forward (the structural
        forwards are all local functions named ``forward``)."""
        return [node for node in ast.walk(tree)
                if isinstance(node, ast.FunctionDef)
                and node.name in R.PURE_FUNC_NAMES]

    @staticmethod
    def _collect_captures(tree: ast.Module) -> list[ast.With]:
        """``with torch.cuda.graph(...)`` statements: their bodies run
        under a CUDA graph capture."""
        out = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    isinstance(item.context_expr, ast.Call)
                    and _dotted(item.context_expr.func) in R.CAPTURE_CONTEXTS
                    for item in node.items):
                out.append(node)
        return out

    # -- main walk (PG001 + PG002 + PG003) ----------------------------------

    def run(self) -> list[Finding]:
        self._walk_body(self.tree.body, held=(), fname=None)
        for fn in self.pure_defs:
            self._check_pure(fn)
        for cap in self.captures:
            self._check_capture(cap)
        return self.findings

    def _walk_body(self, stmts, held: tuple, fname: str | None) -> None:
        for node in stmts:
            self._walk_stmt(node, held, fname)

    def _walk_stmt(self, node: ast.AST, held: tuple,
                   fname: str | None) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            base = tuple(self.holds.get(node, ()))
            self._walk_body(node.body, held=base, fname=node.name)
            return
        if isinstance(node, ast.ClassDef):
            self._walk_body(node.body, held=(), fname=None)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            locks = _with_locks(node)
            for lock in locks:
                self._check_pg003(lock, held, node.lineno)
            inner = held + tuple(lk for lk in locks if lk not in held)
            for item in node.items:
                self._check_exprs(item.context_expr, held, fname)
            self._walk_body(node.body, held=inner, fname=fname)
            return
        # compound statements: recurse into child statement lists, check
        # the expression parts at the current held set
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(node, field, None)
            if sub:
                self._walk_body(sub, held, fname)
        for h in getattr(node, "handlers", []) or []:
            self._walk_body(h.body, held, fname)
        self._check_exprs(node, held, fname, skip_stmts=True)

    def _check_exprs(self, node: ast.AST, held: tuple, fname: str | None,
                     *, skip_stmts: bool = False) -> None:
        """PG001 + PG002 over the expression parts of one statement."""
        for child in self._expr_walk(node, skip_stmts=skip_stmts):
            if isinstance(child, ast.Call) and held:
                self._check_pg001(child, held)
            if isinstance(child, ast.Attribute):
                self._check_pg002(child, held, fname)

    def _expr_walk(self, node: ast.AST, *, skip_stmts: bool):
        """Walk expressions, skipping nested statement bodies (already
        visited with their own held sets) and nested function defs.
        Lambdas ARE descended into: they execute where they appear in
        this codebase's hot paths (min(key=...), sort(key=...))."""
        stack = [node]
        first = True
        while stack:
            n = stack.pop()
            if not first and isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if not first and skip_stmts and isinstance(n, ast.stmt):
                continue  # nested statements are visited with their own
                # held sets by _walk_body; only this statement's own
                # expression parts belong to this check
            first = False
            yield n
            stack.extend(ast.iter_child_nodes(n))

    def _check_pg001(self, call: ast.Call, held: tuple) -> None:
        dotted = _dotted(call.func)
        lockset = ", ".join(sorted(set(held)))
        if isinstance(call.func, ast.Name) and call.func.id in R.PLAN_CALLS:
            self._emit("PG001", call.lineno,
                       f"plan build `{call.func.id}` inside `with "
                       f"{lockset}:` (compiles run OUTSIDE locks)")
            return
        if dotted in R.BLOCKING_DOTTED or (
                dotted and dotted.endswith("futures.wait")):
            self._emit("PG001", call.lineno,
                       f"blocking call `{dotted}` inside `with {lockset}:`")
            return
        final = _final_name(call.func)
        if final in R.BLOCKING_FINAL_ATTRS:
            recv = (call.func.value
                    if isinstance(call.func, ast.Attribute) else None)
            if isinstance(recv, ast.Constant) and isinstance(recv.value, str):
                return  # ", ".join(...) — string formatting, not a thread
            self._emit("PG001", call.lineno,
                       f"blocking `.{final}()` inside `with {lockset}:`")
            return
        if final in R.HOST_SYNC_FINAL_ATTRS and isinstance(call.func, ast.Attribute):
            self._emit("PG001", call.lineno,
                       f"host sync `{dotted or '.' + final}()` inside `with "
                       f"{lockset}:` (waits for the GPU while holding the lock)")
            return
        # receiver-sensitive: queue.Queue.get/put and Event.wait block too,
        # but only on queue/event-like receivers (dict.get and the
        # lock-releasing Condition.wait stay exempt) — matched by the
        # receiver's name, the lint's usual convention contract
        if final is not None and isinstance(call.func, ast.Attribute):
            recv_name = _final_name(call.func.value)
            if R.blocking_receiver(final, recv_name, len(call.args)):
                self._emit(
                    "PG001", call.lineno,
                    f"blocking `{recv_name}.{final}()` (queue/event wait) "
                    f"inside `with {lockset}:`")

    def _check_pg002(self, attr: ast.Attribute, held: tuple,
                     fname: str | None) -> None:
        required = self.guarded.get(attr.attr)
        if required is None:
            return
        if fname is None or fname in ("__init__", "__new__"):
            return  # module/class level defaults and construction
        if R.canonical_lock(required) in held or required in held:
            return
        self._emit("PG002", attr.lineno,
                   f"`{_dotted(attr) or attr.attr}` is guarded-by "
                   f"`{required}` but no `with {required}:` (or "
                   f"`# holds: {required}` contract) is in effect here")

    def _check_pg003(self, lock: str, held: tuple, line: int) -> None:
        my_rank = self.ranks.get(lock)
        for h in held:
            if h == lock:
                continue
            h_rank = self.ranks.get(h)
            if my_rank is not None and h_rank is not None \
                    and h_rank > my_rank:
                self._emit("PG003", line,
                           f"`{lock}` (rank {my_rank}) acquired while "
                           f"holding `{h}` (rank {h_rank}); declared "
                           "hierarchy is outer->inner by ascending rank")

    # -- PG004 --------------------------------------------------------------

    def _check_pure(self, fn: ast.FunctionDef) -> None:
        locals_: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                a = node.args
                for arg in (a.posonlyargs + a.args + a.kwonlyargs
                            + ([a.vararg] if a.vararg else [])
                            + ([a.kwarg] if a.kwarg else [])):
                    locals_.add(arg.arg)
            elif isinstance(node, ast.Name) and isinstance(
                    node.ctx, (ast.Store, ast.Del)):
                locals_.add(node.id)
        where = f"plan forward `{fn.name}`"
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for lock in _with_locks(node):
                    self._emit("PG004", node.lineno,
                               f"lock `{lock}` acquired inside {where} "
                               "(a graph replay never takes it)")
            elif isinstance(node, ast.Call):
                if not self._check_device_call(node, where):
                    self._check_pure_call(node, locals_, where)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if not isinstance(t, ast.Attribute):
                        continue
                    root = (_dotted(t) or "").split(".", 1)[0]
                    if root and root not in locals_:
                        self._emit("PG004", t.lineno,
                                   f"mutation of nonlocal `{_dotted(t)}` "
                                   f"inside {where} (a graph replay skips "
                                   "it)")

    def _check_capture(self, node: ast.With) -> None:
        where = "a CUDA graph capture"
        for stmt in node.body:
            for child in ast.walk(stmt):
                if isinstance(child, ast.Call):
                    self._check_device_call(child, where)

    def _check_device_call(self, call: ast.Call, where: str) -> bool:
        """Host syncs and host->device tensors from Python data; True when
        the call was reported."""
        dotted = _dotted(call.func)
        final = _final_name(call.func)
        if final in R.HOST_SYNC_FINAL_ATTRS and isinstance(call.func, ast.Attribute):
            self._emit("PG004", call.lineno,
                       f"host sync `{dotted or '.' + final}()` inside {where} "
                       "(no sync may sit in a capture)")
            return True
        python_data = bool(call.args) and isinstance(
            call.args[0], (ast.List, ast.Tuple, ast.ListComp, ast.GeneratorExp))
        if dotted in R.H2D_ALWAYS or (dotted in R.H2D_OF_PYTHON_DATA and python_data):
            self._emit("PG004", call.lineno,
                       f"host->device tensor `{dotted}(...)` from Python data "
                       f"inside {where} (a pageable copy; a replay would "
                       "reuse the captured values)")
            return True
        return False

    def _check_pure_call(self, call: ast.Call, locals_: set,
                         where: str) -> None:
        dotted = _dotted(call.func)
        if dotted:
            parts = tuple(dotted.split("."))
            if parts[0] in R.IMPURE_ROOTS and parts[0] not in locals_:
                self._emit("PG004", call.lineno,
                           f"impure call `{dotted}` inside {where}")
                return
            for prefix in R.IMPURE_DOTTED_PREFIXES:
                if parts[:len(prefix)] == prefix:
                    self._emit("PG004", call.lineno,
                               f"nondeterministic call `{dotted}` inside "
                               f"{where}")
                    return
            if (len(parts) > 1 and parts[-1] in R.MUTATOR_METHODS
                    and parts[0] not in locals_
                    and parts[0] not in R.SAFE_MUTATOR_ROOTS):
                self._emit("PG004", call.lineno,
                           f"mutating call `{dotted}` on nonlocal state "
                           f"inside {where}")
                return
        if isinstance(call.func, ast.Name) \
                and call.func.id in R.IMPURE_BUILTINS \
                and call.func.id not in locals_:
            self._emit("PG004", call.lineno,
                       f"side-effecting builtin `{call.func.id}` inside "
                       f"{where}")

    # -- suppressions -------------------------------------------------------

    def apply_suppressions(self, findings: list[Finding]) -> list[Finding]:
        line_sup: dict[int, set] = {}
        block_spans: list[tuple[int, int, set]] = []
        meta: list[Finding] = []
        header_lines = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.stmt) and hasattr(node, "end_lineno"):
                header_lines.setdefault(node.lineno, node.end_lineno)
        for line, comment in self.comments.items():
            m = R.SUPPRESS_RE.search(comment)
            if not m:
                continue
            kind, ids, reason = m.group(1), m.group(2), m.group(3).strip()
            ruleset = {r for r in ids.split(",") if r}
            if not ruleset or not all(r in R.RULES for r in ruleset) \
                    or not reason:
                meta.append(Finding(
                    self.path, line, "PG000",
                    "suppression needs valid rule IDs and a written "
                    f"justification: {comment.strip()!r}"))
            if not ruleset:
                continue
            if kind == "disable-block":
                # inline on the header, or standalone directly above it
                end = header_lines.get(line) or header_lines.get(
                    line + 1, line + 1)
                block_spans.append((line, end, ruleset))
            else:
                line_sup.setdefault(line, set()).update(ruleset)

        def suppressed(f: Finding) -> bool:
            for at in (f.line, f.line - 1):
                if f.rule in line_sup.get(at, ()):
                    return True
            return any(start <= f.line <= end and f.rule in ruleset
                       for start, end, ruleset in block_spans)

        kept = [f for f in findings if not suppressed(f)]
        kept.extend(meta)
        return kept


def lint_source(src: str, path: str = "<string>", *,
                lock_ranks: dict[str, int] | None = None) -> list[Finding]:
    """Lint one module's source; returns unsuppressed findings sorted by
    line. ``lock_ranks`` overrides the module's PG003 rank table (fixture
    tests declare their own hierarchies)."""
    try:
        linter = _Linter(src, path, lock_ranks=lock_ranks)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "PG000",
                        f"file does not parse: {e.msg}")]
    findings = linter.run()
    findings = linter.apply_suppressions(findings)
    return sorted(findings, key=lambda f: (f.line, f.rule, f.message))


def lint_file(path, *, lock_ranks: dict[str, int] | None = None
              ) -> list[Finding]:
    p = Path(path)
    return lint_source(p.read_text(), str(p), lock_ranks=lock_ranks)


def lint_paths(paths) -> list[Finding]:
    """Lint every ``*.py`` under the given files/directories."""
    files: list[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    out: list[Finding] = []
    for f in files:
        out.extend(lint_file(f))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Concurrency and capture invariant lint for the port "
                    "(PG001-PG004; see repro_torch/analysis/rules.py)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint "
                         "(default: src/repro_torch)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule, desc in sorted({**R.RULES, **R.PGA_RULES}.items()):
            print(f"{rule}: {desc}")
        return 0
    findings = lint_paths(args.paths or ["src/repro_torch"])
    for f in findings:
        print(f)
    n = len(findings)
    print(f"pegasus-lint: {n} unsuppressed finding{'s' if n != 1 else ''}")
    return 1 if findings else 0
