"""What one rank of a DTensor program computes, moves and holds (the port's
counterpart of ``repro.launch.hlo_analysis`` and ``dryrun.collective_bytes``).

The reference reads its numbers from compiled HLO: ``cost_analysis()`` for
FLOPs and a scrape of the collectives, corrected by the trip counts of the
``while`` loops that ``lax.scan`` leaves. The port runs the program eagerly
(on real tensors, or fake ones under ``FakeTensorMode`` over a fake process
group), and :class:`LocalOpCounter`, a ``TorchDispatchMode``, watches the
ops each rank runs on its LOCAL shards:

  * FLOPs of the matrix products (``torch.utils.flop_counter``'s
    formulas: mm, bmm, addmm, baddbmm, convolutions, attention) at the
    local shapes, so per device, and those the shape-only loops of
    :mod:`repro_torch.models.shape_only` report on the meta device. A mode entered outside DTensor would see
    the global shapes: DTensor ops are passed down (``NotImplemented``)
    and only the local ops they run are counted, and the global-shape ops
    DTensor runs to propagate shardings are skipped.
  * Bytes of every functional collective (``_c10d_functional.*``) by kind
    (all-gather, all-reduce, reduce-scatter, all-to-all,
    collective-permute) and by mesh axis, counted at the output's size as
    the reference counts the HLO op's output shape: the gathered tensor of
    an all-gather, the shard of a reduce-scatter.
  * Peak bytes: the local storages alive at once, from the bytes held when
    the counter starts (parameters, optimizer state, inputs) plus every op
    output kept alive, freed when its last tensor is collected.

Python loops over layers (and over chunks and time steps) run every
iteration, so every collective is counted as often as it runs: the
reference's while-trip correction has no counterpart here.
"""

from __future__ import annotations

import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models.shape_only import FLOP_SINKS

__all__ = ["COLLECTIVES", "LocalOpCounter", "collective_kind"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("permute", "collective-permute"), ("send", "collective-permute"),
          ("recv", "collective-permute"))

_IN_PROPAGATION = threading.local()


def collective_kind(func) -> str | None:
    """The collective kind of a ``_c10d_functional`` op, None for others
    (``wait_tensor`` moves nothing)."""
    name = str(func)
    if not name.startswith(("_c10d_functional", "c10d_functional")):
        return None
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def _group_axes(mesh) -> dict[str, str]:
    """{process-group name: mesh axis name} for every dim of ``mesh``."""
    if mesh is None:
        return {}
    names = mesh.mesh_dim_names or tuple(str(i) for i in range(mesh.ndim))
    return {mesh.get_group(i).group_name: names[i] for i in range(mesh.ndim)}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class LocalOpCounter(TorchDispatchMode):
    """Count one rank's local FLOPs, collective bytes and peak live bytes
    while entered (see the module docstring). ``held`` are the tensors
    (DTensors count their local shards) that exist before the counted
    region and stay alive through it."""

    def __init__(self, mesh=None, held=()):
        super().__init__()
        self.flops = 0
        self.collective_bytes = {k: 0 for k in COLLECTIVES}
        self.collective_by_axis: dict[str, dict[str, int]] = defaultdict(
            lambda: {k: 0 for k in COLLECTIVES})
        self.collective_calls = 0
        self._axes = _group_axes(mesh)
        seen = set()
        self.held_bytes = 0
        for t in _tensors(held):
            st = _local(t).untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                self.held_bytes += st.nbytes()
        self._live: dict[int, list] = {}     # storage → [bytes, tensors alive]
        self._live_bytes = 0
        self.peak_bytes = self.held_bytes
        self._held = seen
        self._patched = None

    # -- the sharding propagator runs ops at global shapes: not counted --
    def __enter__(self):
        from torch.distributed.tensor import DTensor

        prop = DTensor._op_dispatcher.sharding_propagator
        orig = prop._propagate_tensor_meta_non_cached

        def skipping(*args, **kwargs):
            depth = getattr(_IN_PROPAGATION, "depth", 0)
            _IN_PROPAGATION.depth = depth + 1
            try:
                return orig(*args, **kwargs)
            finally:
                _IN_PROPAGATION.depth = depth

        prop._propagate_tensor_meta_non_cached = skipping
        self._patched = (prop, orig)
        FLOP_SINKS.append(self._add_flops)
        return super().__enter__()

    def __exit__(self, *exc):
        prop, orig = self._patched
        prop._propagate_tensor_meta_non_cached = orig
        FLOP_SINKS.remove(self._add_flops)
        return super().__exit__(*exc)

    def _add_flops(self, n: int) -> None:
        self.flops += n

    @property
    def collective_total(self) -> int:
        return sum(self.collective_bytes.values())

    def _track(self, out) -> None:
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self._held:
                continue
            entry = self._live.get(key)
            if entry is None:
                entry = self._live[key] = [st.nbytes(), 0]
                self._live_bytes += entry[0]
                self.peak_bytes = max(self.peak_bytes, self.held_bytes + self._live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live_bytes -= entry[0]
            del self._live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs its local ops below
        out = func(*args, **kwargs)
        if getattr(_IN_PROPAGATION, "depth", 0):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        kind = collective_kind(func)
        if kind is not None:
            nbytes = sum(t.numel() * t.element_size() for t in _tensors(out))
            self.collective_bytes[kind] += nbytes
            group = next((a for a in args if isinstance(a, str) and a in self._axes), None)
            self.collective_by_axis[self._axes.get(group, "?")][kind] += nbytes
            self.collective_calls += 1
        self._track(out)
        return out

    def report(self) -> dict:
        return {
            "flops": self.flops,
            "collective_bytes": dict(self.collective_bytes),
            "collective_by_axis": {a: {k: v for k, v in d.items() if v}
                                   for a, d in self.collective_by_axis.items()},
            "collective_total": self.collective_total,
            "collective_calls": self.collective_calls,
            "held_bytes": self.held_bytes,
            "peak_bytes": self.peak_bytes,
        }
