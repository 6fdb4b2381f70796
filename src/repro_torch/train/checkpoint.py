"""Checkpointing with atomic commit and keep-last-k GC (port of
``repro.train.checkpoint``), in the reference's layout on disk, so a
directory written by either package restores into the other.

Layout:  <dir>/step_<N>/
           manifest.json            keys, shapes, dtypes, step
           <flat-key>.npy           one file per leaf (on the host)
         <dir>/step_<N>.COMMITTED   commit marker (after the atomic rename)

A tree is any nesting of tuples (a ``NamedTuple`` too), lists, dicts,
modules and tensors. Keys are the reference's: path components joined by
``::``, a ``NamedTuple`` field written ``.<field>``, a dict's keys as they
are. Two kinds of node hold parameters under their PyTorch names: a module
(its ``named_parameters()``) and the ``m``/``v`` dicts of an
:class:`~repro_torch.train.optimizer.AdamWState`. Their names are split at
the dots and each per-layer tensor (``layers.3.attn.wq``) is stacked over a
leading ``[L, ...]`` axis under the key without its layer index
(``layers::attn::wq``), as the reference's nested parameter dicts store
them. bf16 is stored as its raw 16-bit words (``<V2``, dtype ``bfloat16``
in the manifest), as the reference's numpy writes it.

Fault model: a crash mid-save leaves no COMMITTED marker, so restore picks
the last committed step. :class:`AsyncCheckpointer` copies the tree to the
host before it hands off to its thread, so the training loop may update the
tensors in place while the previous step is written.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch import distributed as dist
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamWState

__all__ = ["save", "restore", "latest_step", "latest_steps", "async_save",
           "AsyncCheckpointer", "split_name", "stack_named"]

_SEP = "::"


def split_name(name: str) -> tuple[tuple[str, ...], int | None]:
    """A parameter name (``"layers.3.attn.wq"``) as the reference's key path
    (``("layers", "attn", "wq")``) and its layer index (3; None for a tensor
    outside the layer stacks)."""
    parts = name.split(".")
    idx = [int(p) for p in parts if p.isdigit()]
    if len(idx) > 1:
        raise ValueError(f"{name!r}: more than one layer index")
    return tuple(p for p in parts if not p.isdigit()), (idx[0] if idx else None)


def stack_named(named: dict) -> dict:
    """Nested dicts of host tensors from a flat dict under parameter names
    (a model's ``named_parameters()``, its gradients or Adam moments), each
    per-layer tensor stacked over a leading ``[L, ...]`` axis as the
    reference stores it. Every tensor is a fresh copy, never a view of
    ``named``."""
    groups: dict[tuple, dict] = {}
    for name, t in named.items():
        path, l = split_name(name)
        groups.setdefault(path, {})[l] = _full(t.detach())
    out: dict = {}
    for path, by_layer in groups.items():
        if None in by_layer:
            if len(by_layer) > 1:
                raise ValueError(f"{'.'.join(path)!r} is both stacked and not")
            host = torch.empty(by_layer[None].shape, dtype=by_layer[None].dtype)
            host.copy_(by_layer[None])
        else:
            if sorted(by_layer) != list(range(len(by_layer))):
                raise ValueError(f"{'.'.join(path)!r}: layers {sorted(by_layer)}")
            first = by_layer[0]
            host = torch.empty((len(by_layer), *first.shape), dtype=first.dtype)
            for l, t in by_layer.items():
                host[l].copy_(t)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = host
    return out


def _full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor: a DTensor is all-gathered (every rank must call)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _named(named: dict, prefix: tuple):
    """(key path, host tensor) for a flat dict under parameter names."""
    def items(tree: dict, path: tuple):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from items(value, path + (key,))
            else:
                yield path + (key,), value
    yield from items(stack_named(named), prefix)


def _walk(node, prefix: tuple = ()):
    """(key path, host tensor) for every leaf of ``node``; each tensor is a
    fresh host copy."""
    if isinstance(node, nn.Module):
        yield from _named(dict(node.named_parameters()), prefix)
    elif isinstance(node, AdamWState):
        yield from _walk(node.step, prefix + (".step",))
        yield from _named(node.m, prefix + (".m",))
        yield from _named(node.v, prefix + (".v",))
    elif _is_namedtuple(node):
        for field in node._fields:
            yield from _walk(getattr(node, field), prefix + ("." + field,))
    elif isinstance(node, (tuple, list)):
        for i, value in enumerate(node):
            yield from _walk(value, prefix + (str(i),))
    elif isinstance(node, dict):
        for key, value in node.items():
            yield from _walk(value, prefix + (str(key),))
    else:
        yield prefix, _full(torch.as_tensor(node).detach()).to("cpu", copy=True)


def _flatten(tree: Any) -> dict[str, torch.Tensor]:
    return {_SEP.join(path): t for path, t in _walk(tree)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _write(ckpt_dir: str, step: int, flat: dict, keep: int) -> str:
    stepdir = os.path.join(ckpt_dir, f"step_{step}")
    tmpdir = stepdir + ".tmp"
    if os.path.exists(tmpdir):
        shutil.rmtree(tmpdir)
    os.makedirs(tmpdir, exist_ok=True)

    manifest = {"step": step, "keys": {}}
    for key, t in flat.items():
        fname = key.replace("/", "_") + ".npy"
        arr = _to_numpy(t)
        np.save(os.path.join(tmpdir, fname), arr)
        dtype = "bfloat16" if t.dtype == torch.bfloat16 else str(arr.dtype)
        manifest["keys"][key] = {"file": fname, "shape": list(t.shape), "dtype": dtype}
    with open(os.path.join(tmpdir, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(stepdir):                      # same-step re-save
        shutil.rmtree(stepdir)
    os.replace(tmpdir, stepdir)                      # atomic on POSIX
    open(stepdir + ".COMMITTED", "w").close()

    _gc(ckpt_dir, keep)
    return stepdir


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous checkpoint save with atomic commit marker. Under a
    process group every rank calls it (DTensors are gathered whole), rank
    0 writes, and all ranks return after a barrier that follows the write."""
    flat = _flatten(tree)
    stepdir = os.path.join(ckpt_dir, f"step_{step}")
    if _writer():
        _write(ckpt_dir, step, flat, keep)
    if dist.is_initialized():
        dist.barrier()
    return stepdir


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
        try:
            os.remove(os.path.join(ckpt_dir, f"step_{s}.COMMITTED"))
        except OSError:
            pass


def latest_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.endswith(".COMMITTED"):
            out.append(int(name[len("step_"):-len(".COMMITTED")]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, target: Any, *, step: int | None = None,
            device: str | torch.device | None = None,
            shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``target``: ``(tree, step)``.

    Each leaf takes its target's dtype and lands on ``device`` (None: the
    target leaf's own device); a DTensor target leaf keeps its mesh and
    placements. ``shardings`` (the tree of
    :class:`~repro_torch.launch.mesh.NamedSharding` that
    ``train_state_shardings`` gives, a module's entry a dict under its
    parameter names, ``None`` for a leaf left as above) places each leaf on
    a mesh instead: the files hold whole tensors, so a checkpoint saved on
    one mesh restores onto any other (elastic restore). A module in
    ``target`` is restored in place, its parameters taking the stored
    values, and returned; every other leaf is a new tensor.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import NamedSharding, distribute

    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    stepdir = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(stepdir, "manifest.json")) as f:
        manifest = json.load(f)
    dev = None if device is None else resolve_device(device)
    files: dict[str, np.ndarray] = {}

    def load(path: tuple, like, layer: int | None = None, sh=None) -> torch.Tensor:
        key = _SEP.join(path)
        if key not in files:
            info = manifest["keys"][key]
            files[key] = np.load(os.path.join(stepdir, info["file"]), mmap_mode="r")
        arr = np.array(files[key] if layer is None else files[key][layer])
        if manifest["keys"][key]["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        like = torch.as_tensor(like)
        if sh is None and isinstance(like, DTensor):
            sh = NamedSharding(like.device_mesh, tuple(like.placements))
        if sh is not None:
            return distribute(t.to(like.dtype), sh)
        return t.to(device=like.device if dev is None else dev, dtype=like.dtype)

    def load_named(prefix: tuple, name: str, like, sh=None) -> torch.Tensor:
        path, layer = split_name(name)
        return load(prefix + path, like, layer, sh)

    def fill(node, prefix: tuple, sh):
        if isinstance(node, nn.Module):
            sh = sh or {}
            for name, p in list(node.named_parameters()):
                t = load_named(prefix, name, p, sh.get(name))
                if isinstance(t, DTensor) or isinstance(p, DTensor):
                    owner, _, leaf = name.rpartition(".")
                    module = node.get_submodule(owner) if owner else node
                    setattr(module, leaf, nn.Parameter(t, requires_grad=p.requires_grad))
                else:
                    p.data = t
            return node
        if isinstance(node, AdamWState):
            sh = sh or AdamWState(None, {}, {})
            return AdamWState(
                fill(node.step, prefix + (".step",), sh.step),
                *({k: load_named(prefix + ("." + f,), k, t, getattr(sh, f).get(k))
                   for k, t in getattr(node, f).items()} for f in ("m", "v")))
        if _is_namedtuple(node):
            sh = sh or (None,) * len(node._fields)
            return type(node)(*(fill(getattr(node, f), prefix + ("." + f,), s)
                                for f, s in zip(node._fields, sh)))
        if isinstance(node, (tuple, list)):
            sh = sh or (None,) * len(node)
            return type(node)(fill(v, prefix + (str(i),), s)
                              for i, (v, s) in enumerate(zip(node, sh)))
        if isinstance(node, dict):
            sh = sh or {}
            return {k: fill(v, prefix + (str(k),), sh.get(k)) for k, v in node.items()}
        return load(prefix, node, sh=sh)

    return fill(target, (), shardings), step


class AsyncCheckpointer:
    """Background-thread checkpointing: training blocks only on the PREVIOUS
    save (bounded staleness of one). A failed write raises from the next
    :meth:`wait` or :meth:`save`. Under a process group every rank calls
    :meth:`save` (DTensors are gathered whole, in the reference's layout),
    rank 0 writes, and :meth:`wait` returns on every rank after a barrier
    that follows the write."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pending_barrier = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending_barrier:
            self._pending_barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _run(self, step: int, flat: dict) -> None:
        try:
            _write(self.ckpt_dir, step, flat, self.keep)
        except Exception as e:     # handed to the caller's next wait()
            self._error = e

    def save(self, step: int, tree: Any):
        self.wait()
        # copies on the host BEFORE backgrounding: on the CPU a tensor's
        # numpy view shares its storage, and the next step updates in place
        flat = _flatten(tree)
        self._pending_barrier = dist.is_initialized()
        if _writer():
            self._thread = threading.Thread(target=self._run, args=(step, flat), daemon=True)
            self._thread.start()


def async_save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> AsyncCheckpointer:
    ck = AsyncCheckpointer(ckpt_dir, keep)
    ck.save(step, tree)
    return ck
