"""One run of one cell: set-up, the measured window, the check against the
plain reference, the metrics.

The cell's configuration (``configs/<config>.json`` and the module it
names), its traffic mix (``mixes/<traffic>.json``) and each of its metrics
(``metrics/<metric>.py``) are found by the names ``BENCHMARK.json`` gives
them. What the program contributes is the system under test,
``repro_torch.launch.serve.AsyncMultiModelServer``, with one model
registered under the configuration's name, and its counters; every
request enters by ``submit`` and is waited on through its future.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np

from bench import traffic

__all__ = ["Cell", "FORBIDDEN", "run_cell", "forbidden_modules", "log"]

ROOT = Path(__file__).resolve().parents[1]
# top-level module names the run may not hold once the window has closed
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})
WARM_S = 1.0                 # the cell's own traffic before the window
GRACE_S = 30.0               # how long requests due in the window are followed after it
CHECK_FLOWS = 1 << 20        # about this many served flows are checked
FORCED_LARGEST = 2           # requests of the mix's largest size always checked
TRACE_FOR_S = 2.0            # the traced sub-window: the window's last 2 s


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modname(name: str) -> str:
    return "".join(ch if ch.isalnum() else "_" for ch in name)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, mix and
    metrics loaded."""

    def __init__(self, name: str, root: Path = ROOT, overrides: dict | None = None,
                 mix_overrides: dict | None = None, workload: dict | None = None):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        by_name = {w["name"]: w for w in spec["workloads"]}
        if workload is None and name not in by_name:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(by_name)}")
        self.name, self.workload = name, workload or by_name[name]
        self.chips = int(self.workload["chips"])
        entry = next(c for c in spec["configs"] if c["name"] == self.workload["config"])
        self.config = {**json.loads((root / entry["file"]).read_text()), **(overrides or {})}
        module = self.config.get("module", entry["name"])
        self.model = _load(root / "bench" / "configs" / f"{module}.py",
                           f"bench.configs.{_modname(module)}")
        self.mix = {**json.loads((root / "bench" / "mixes" / f"{self.workload['traffic']}.json")
                                 .read_text()), **(mix_overrides or {})}
        self.end_to_end = [m for m in spec["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if _applies(m, name)]
        self.root = root

    def reader(self, metric: dict):
        return _load(self.root / "bench" / "metrics" / f"{metric['name']}.py",
                     f"bench.metrics.{_modname(metric['name'])}")

    @classmethod
    def of(cls, config: str, traffic: str, root: Path = ROOT, **kw) -> "Cell":
        """A one-chip cell of a configuration and a mix that ``BENCHMARK.json``
        need not list (the knee sweep, the tests)."""
        name = f"{config}.{traffic}"
        return cls(name, root, workload={"name": name, "config": config, "traffic": traffic,
                                         "chips": 1}, **kw)

    @property
    def int8(self) -> bool:
        return self.config["backend"] == "kernel_q8"


class _Phase:
    """Requests of one stretch of traffic (the warm-up or the window) and
    their completions."""

    def __init__(self, srv, cell: Cell, pool: tuple, rng: np.random.Generator,
                 keep_p: float, n_hint: int = 1 << 12, mix: dict | None = None):
        from repro_torch.launch.serve import InferRequest

        self.srv, self.cell, self.pool, self.rng = srv, cell, pool, rng
        self.mix = cell.mix if mix is None else mix
        self.Request, self.keep_p = InferRequest, keep_p
        self.log = traffic.Log()
        self.pool_rows = pool[0].shape[0]
        self.largest, self.forced = max(self.mix["sizes"]), 0
        self.closed = self.mix["type"] == "closed"
        self.stop_at = 0.0
        # the first sends of a closed loop race the first completions' sends
        self._lock = threading.Lock()
        self._draw(n_hint)

    def _draw(self, n: int) -> None:
        self.sizes, self.offsets, self.u = traffic.request_draws(self.mix, self.rng, n,
                                                                 self.pool_rows)
        self.next = 0

    def send(self, client: int, due: float | None = None) -> None:
        with self._lock:
            if self.next == len(self.sizes):
                self._draw(len(self.sizes))
            j = self.next
            self.next += 1
            size, off = int(self.sizes[j]), int(self.offsets[j])
            keep = bool(self.u[j] < self.keep_p)
            if self.keep_p > 0 and size == self.largest and self.forced < FORCED_LARGEST:
                keep, self.forced = True, self.forced + 1
            now = time.perf_counter()
            i = self.log.new(size, off, now if due is None else due, now, keep)
        fut = self.srv.submit(self.Request(self.cell.name,
                                           tuple(a[off:off + size] for a in self.pool)))
        fut.add_done_callback(lambda f, i=i, c=client: self._done(f, i, c))

    def _done(self, fut, i: int, client: int) -> None:
        L = self.log
        L.set("done", i, time.perf_counter())
        try:
            res = fut.result()
        except Exception as e:         # a failed request: counted, never raised here
            L.errors.append(e)
        else:
            L.set("ok", i, True)
            if res.queue_wait_ms is not None:
                L.set("qwait", i, res.queue_wait_ms)
            if L.get("keep", i):
                L.outputs[i] = np.asarray(res.output)
        if self.closed and time.perf_counter() < self.stop_at:
            self.send(client)           # the client's next request, at once

    def drive(self, t0: float, seconds: float) -> None:
        mix = self.mix
        if mix["type"] == "closed":
            self.stop_at = t0 + seconds
            traffic.drive_closed(self.send, int(mix["clients"]), self.stop_at)
        elif mix["type"] == "open":
            due = traffic.open_schedule(mix, self.rng, seconds)
            self._draw(len(due))
            traffic.drive_open(lambda j: self.send(0, t0 + due[j]), due, t0)
        else:
            raise ValueError(f"unknown mix type {mix['type']!r}")

    def wait(self, grace: float) -> int:
        """Wait up to ``grace`` seconds for every request; returns how many
        never completed."""
        end = time.perf_counter() + grace
        while np.isnan(self.log.view("done")).any() and time.perf_counter() < end:
            time.sleep(0.005)
        return int(np.isnan(self.log.view("done")).sum())


def freeze_setup() -> None:
    """Collect, then move every object set-up made out of the cyclic
    collector's reach (``gc.freeze``): a generation-2 collection walked
    torch's ~170k import-time objects for about 100 ms, stalling every
    request in flight. Objects made in the window are collected as usual."""
    gc.collect()
    gc.freeze()


def _pool(arrays: tuple, rows: int) -> tuple:
    """The flows tiled to ``rows`` rows."""
    reps = -(-rows // arrays[0].shape[0])
    return tuple(np.ascontiguousarray(np.concatenate([a] * reps)[:rows]) for a in arrays)


def check_outputs(cell: Cell, drawn: dict, pool: tuple, log_: traffic.Log, idx, device,
                  *, control: bool = False) -> dict:
    """The program's outputs of requests ``idx`` against the plain reference,
    in blocks of flows: ``logit_gap`` is the widest |program - reference|
    over every checked logit, over the spread (standard deviation) of the
    reference's logits; with ``control``, ``control_gap`` is the same for
    the reference computed in bfloat16 in the program's place."""
    import torch

    block = int(cell.config["check_block_flows"])
    sizes, offsets = log_.view("size"), log_.view("offset")
    gap = ctl = 0.0
    s1 = s2 = 0.0
    n = 0
    idx = sorted(idx)
    start = 0
    while start < len(idx):
        blk, flows = [], 0
        while start < len(idx) and (not blk or flows + sizes[idx[start]] <= block):
            blk.append(idx[start])
            flows += int(sizes[idx[start]])
            start += 1
        inputs = tuple(torch.as_tensor(np.concatenate(
            [a[offsets[i]:offsets[i] + sizes[i]] for i in blk]), device=device) for a in pool)
        want = cell.model.reference(cell.config, drawn, inputs, int8=cell.int8)
        got = torch.as_tensor(np.concatenate([log_.outputs[i] for i in blk]), device=device)
        diff = torch.nan_to_num((got.to(torch.float32) - want).abs(), nan=float("inf"))
        gap = max(gap, float(diff.max()))
        w64 = want.to(torch.float64)
        s1, s2, n = s1 + float(w64.sum()), s2 + float((w64 * w64).sum()), n + w64.numel()
        if control:
            low = cell.model.reference(cell.config, drawn, inputs, dtype=torch.bfloat16)
            d = torch.nan_to_num((low - want).abs(), nan=float("inf"))
            ctl = max(ctl, float(d.max()))
    spread = max((s2 / n - (s1 / n) ** 2) ** 0.5, 1e-30) if n else 1.0
    out = {"logit_gap": gap / spread, "flows": n // max(int(cell.config["classes"]), 1),
           "requests": len(idx), "spread": spread}
    if control:
        out["control_gap"] = ctl / spread
    return out


class Setup:
    """A cell made ready to serve: its banks and flow pool drawn from the
    seed, the server started with its one model, and a graph captured at
    every bucket of the plan. ``split`` holds the seconds of each step."""

    def __init__(self, cell: Cell, seed: int, device: str = "cuda"):
        import torch

        self.split: dict[str, float] = {}
        self._mark = time.perf_counter()
        self.cell, self.seed, self.dev = cell, int(seed), torch.device(device)
        cfg, model, dev = cell.config, cell.model, self.dev
        from repro_torch.kernels.fuzzy_lut import _lib
        from repro_torch.launch.serve import AsyncMultiModelServer, InferRequest

        self.lib = _lib
        torch.set_num_threads(1)      # one process, few threads: the host path is the load
        if dev.type == "cuda":
            torch.cuda.init()
            torch.zeros(1, device=dev)
        self._phase("import_and_device_init_s")
        if dev.type == "cuda":
            built = _lib.build_all()
            for fn in ("fuzzy_lut_f32", "fuzzy_lut_stack_f32", "fuzzy_lut_q8",
                       "fuzzy_lut_stack_q8"):
                _lib.library(fn)
            if built:
                log(f"bench: built {sorted(built)} in {max(built.values()):.1f} s")
        self._phase("kernel_load_s")

        flows = model.flows(cfg, self.seed)
        calib = tuple(torch.as_tensor(a, device=dev) for a in flows)
        self.drawn = model.draw(cfg, calib, self.seed)
        self.pool = _pool(flows, int(cfg["pool_flows"]) + max(cell.mix["sizes"]))
        del calib
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self._phase("banks_and_traffic_s")

        self.srv = AsyncMultiModelServer(backend=cfg["backend"], device=dev,
                                         fuse=cfg.get("fuse", True))
        self.plan = self.srv.add_model(cell.name, model.program_model(cfg, self.drawn))
        self.srv.start()
        self._phase("plan_build_and_audit_s")
        for b in self.plan.buckets:
            self.srv.submit(InferRequest(cell.name, tuple(a[:b] for a in self.pool))
                            ).result(timeout=300)
        self.captures = self.plan.compile_stats()["traces"]
        self._phase("graph_captures_s")

    def _phase(self, label: str) -> None:
        now = time.perf_counter()
        self.split[label] = now - self._mark
        self._mark = now

    def phase(self, rng: np.random.Generator, keep_p: float = 0.0, mix: dict | None = None):
        """A stretch of traffic of the cell's mix (or ``mix``)."""
        return _Phase(self.srv, self.cell, self.pool, rng, keep_p, mix=mix)

    def close(self) -> None:
        """Stop the server and free the plan."""
        import torch

        self.srv.stop(drain=True, timeout=GRACE_S)
        if self.srv.running:
            raise RuntimeError("the server's dispatch thread did not stop")
        self.srv.close()
        del self.srv, self.plan
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(name: "str | Cell", seed: int, seconds: float, trace: bool, *, t_start: float,
             root: Path = ROOT, device: str = "cuda", overrides: dict | None = None,
             mix_overrides: dict | None = None,
             check_flows: int = CHECK_FLOWS, warm_s: float = WARM_S,
             control: bool = False) -> dict:
    """Run cell ``name`` (or a :class:`Cell`) once; returns the result line's
    object (with the set-up split and the check under ``"detail"``, which the
    caller prints apart)."""
    import torch

    cell = name if isinstance(name, Cell) else Cell(name, root, overrides, mix_overrides)
    cfg, model = cell.config, cell.model
    su = Setup(cell, seed, device)
    srv, plan, pool, drawn, dev, _lib = su.srv, su.plan, su.pool, su.drawn, su.dev, su.lib
    split, captures = su.split, su.captures
    phase = su._phase

    rng = np.random.default_rng([int(seed), 1])
    warm = su.phase(np.random.default_rng([int(seed), 2]))
    warm.drive(time.perf_counter(), warm_s)
    if warm.wait(GRACE_S) or not warm.log.view("ok").all():
        raise RuntimeError(f"warm-up requests failed: {warm.log.errors[:3]}")
    warm_flows = float(warm.log.view("size").sum())
    freeze_setup()
    phase("warm_traffic_s")
    if trace and dev.type == "cuda":
        from bench.tracing import warm_profiler

        warm_profiler()
    phase("profiler_warm_s")

    win = su.phase(rng)
    if cell.mix["type"] == "open":
        expected = cell.mix["rate"] * seconds * float(np.mean(cell.mix["sizes"]))
    else:
        expected = warm_flows / warm_s * seconds
    win.keep_p = min(1.0, check_flows / max(expected, 1.0))

    def counters():
        return srv.stats()["serving"], sum(_lib.LAUNCHES.values())

    st0, l0 = counters()
    traces0 = plan.compile_stats()["traces"]
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    tracer = None
    if trace and dev.type == "cuda":
        from bench.tracing import Tracer

        tracer = Tracer(t0 + max(seconds - TRACE_FOR_S, 0.0), TRACE_FOR_S, "pegasus-drain",
                        counters)
        tracer.start()
    win.drive(t0, seconds)
    t1 = t0 + seconds
    missing = win.wait(GRACE_S)
    t_end = time.perf_counter()
    if tracer is not None:
        tracer.window_over.set()
    st1, l1 = counters()
    traces1 = plan.compile_stats()["traces"]
    if traces1 != traces0:
        raise RuntimeError(f"a plan traced inside the window ({traces0} -> {traces1})")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if tracer is not None:
        tracer.join()
    traced = tracer.result() if tracer is not None else None
    if tracer is not None and traced is None:
        log(f"bench: the traced sub-window holds no device activity: {tracer.diagnostics}")
    # counters are read up to the traced sub-window: the profiler slows the host
    upto, (st1, l1) = ((tracer.t_a, tracer.at_start) if tracer is not None
                       else (t_end, (st1, l1)))

    del srv, plan
    su.close()

    L = win.log
    n = L.n
    if cell.mix["type"] == "closed":
        in_window = L.view("sent") < t1
    else:
        in_window = np.ones(n, bool)
    attempted = int(in_window.sum())
    ok = L.view("ok") & in_window
    failed = attempted - int(ok.sum())
    t_check = time.perf_counter()
    chk = check_outputs(cell, drawn, pool, L, list(np.flatnonzero(L.view("keep") & ok)), dev,
                        control=control)
    chk["seconds"] = time.perf_counter() - t_check

    done = L.view("done")
    lat = np.where(ok, done - L.view("due"), np.inf)[in_window] * 1e3
    ctx = types.SimpleNamespace(
        cell=cell, config=cfg, mix=cell.mix, seconds=seconds, setup_s=setup_s,
        t0=t0, t1=t1, upto=upto, log=L, in_window=in_window, ok=ok, latency_ms=lat,
        flows_done_in_window=int(L.view("size")[ok & (done >= t0) & (done <= t1)].sum()),
        serving=(st0, st1), launches=(l0, l1), trace=traced,
        work=lambda flows: model.work(cfg, drawn, flows, cell.int8))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    lateness = (L.view("sent") - L.view("due"))[in_window]
    result = {
        "correct": None, "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if traced is not None:
        result["device"]["busy_s"] = traced["busy"]
        result["device"]["window_s"] = traced["window"]
        result["breakdown"] = {
            "device_ops": [[k[:160], v] for k, v in list(traced["by_name"].items())[:10]],
            "idle_gaps": [[k, v] for k, v in list(traced["idle_by_host"].items())[:10]]}
    limit = (cfg.get("check") or {}).get("logit_gap")
    check = {"logit_gap": {"value": chk["logit_gap"], "limit": limit},
             "unanswered": {"value": failed, "limit": 0}}
    result["correct"] = bool(limit is not None and chk["logit_gap"] <= limit
                             and failed == 0 and chk["requests"] > 0)
    result["check"] = check
    result["detail"] = {
        "setup_split_s": split, "captures": captures, "traces_before": traces0,
        "traces_after": traces1, "missing_after_grace": missing,
        "generator_late_ms": {"p50": float(np.percentile(lateness, 50)) * 1e3,
                              "p99": float(np.percentile(lateness, 99)) * 1e3,
                              "max": float(lateness.max()) * 1e3} if len(lateness) else None,
        "followed_s": t_end - t1, "keep_p": win.keep_p, "check": chk,
        "flows_per_second_of_window": np.histogram(
            done[ok] - t0, bins=max(int(round(seconds)), 1), range=(0, seconds),
            weights=L.view("size")[ok])[0].tolist(),
        "serving": {k: st1[k] - st0[k] for k in ("flows_served", "batches_dispatched",
                                                   "requests_served")},
        "trace": None if tracer is None else {
            **tracer.diagnostics, **({} if traced is None else {
                "flows": traced["flows"], "samples": traced["samples"],
                "idle_share": traced["idle_share"]})},
    }
    return result
