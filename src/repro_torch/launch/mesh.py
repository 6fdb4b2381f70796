"""Production mesh and sharding rules for the ten-architecture LM stack
(port of ``repro.launch.mesh``), priced for NVIDIA H100 nodes.

Mesh shapes (HGX H100 nodes of 8 cards each):
  256 ranks:  (32, 8)      axes ("data", "model")
  512 ranks:  (2, 32, 8)   axes ("pod", "data", "model"); "pod" is an outer
              data-parallel axis whose collectives cross the InfiniBand
              fabric between two 256-card groups.

``MODEL_AXIS_SIZE = 8``: tensor parallelism stays inside one HGX node's
NVLink domain (8 cards, all to all); "data" and "pod" cross nodes over
InfiniBand. The reference's TPU mesh is (16, 16) with a 16-wide model axis.

Sharding policy (the reference's):
  * TP: one matrix axis on "model" (heads / d_ff / vocab).
  * FSDP/ZeRO-3: the other matrix axis on ("pod", "data"); params, grads
    and Adam m/v shard over the whole mesh.
  * Activations: batch on ("pod", "data").
  * KV caches: batch on data; kv-heads on "model" when divisible, else
    head_dim.

A spec is a :class:`P`: the reference's ``PartitionSpec`` entries as a
tuple, one per tensor dim (``None``, an axis name, or a tuple of names).
The port keeps each layer as a module where the reference stacks layers
over a leading axis, so a layer leaf's spec drops the reference's leading
``None``; decode states stay stacked and keep it. The spec functions read
only a mesh's ``shape`` and ``mesh_dim_names`` (a ``DeviceMesh`` or a
:class:`MeshShape`) and need no process group; :func:`named` turns specs
into DTensor placements, one per mesh dim.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, NamedTuple

import numpy as np

__all__ = ["MODEL_AXIS_SIZE", "MeshShape", "NamedSharding", "P", "batch_specs",
           "decode_state_specs", "distribute", "distribute_params", "fsdp_axes",
           "make_production_mesh", "mesh_device", "named", "param_spec", "param_specs",
           "placements", "production_mesh_shape", "world_mesh"]

MODEL_AXIS_SIZE = 8


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name or a tuple of names (the tensor dim splits over those axes,
    the first outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's shape and axis names, without devices or a process group:
    what the spec functions read from a ``DeviceMesh``."""

    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 32, MODEL_AXIS_SIZE), ("pod", "data", "model"))
    return MeshShape((32, MODEL_AXIS_SIZE), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group, which
    must hold 256 ranks (512 with ``multi_pod``)."""
    from torch.distributed.device_mesh import init_device_mesh

    m = production_mesh_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type, m.shape, mesh_dim_names=m.mesh_dim_names)


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def fsdp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _fsdp(mesh):
    f = fsdp_axes(mesh)
    return f if len(f) > 1 else f[0]


def _div(n: int, mesh, axis) -> bool:
    sizes = _sizes(mesh)
    axes = axis if isinstance(axis, tuple) else (axis,)
    return n % int(np.prod([sizes[a] for a in axes])) == 0


def _maybe(n: int, mesh, axis):
    """Shard a dim of size n on ``axis`` if divisible, else replicate."""
    return axis if _div(n, mesh, axis) else None


def param_spec(name: str, shape, mesh) -> P:
    """The spec of one parameter from its name (``layers.3.attn.wq``; only
    the last component is read) and shape, as the reference's ``spec_for``."""
    dims = tuple(shape)
    leaf = name.rsplit(".", 1)[-1]
    fsdp = _fsdp(mesh)

    def out(*spec):
        return P(*spec, *([None] * (len(dims) - len(spec))))

    if leaf == "embed":
        return out(_maybe(dims[0], mesh, "model"), _maybe(dims[1], mesh, fsdp))
    if leaf == "lm_head":
        return out(_maybe(dims[0], mesh, fsdp), _maybe(dims[1], mesh, "model"))
    if len(dims) == 0 or leaf.startswith("ln") or leaf == "a_log":
        return out()
    if leaf in ("wq", "wk", "wv", "wz", "wi", "wf", "wo_gate", "w_in", "w_gate",
                "w_dt", "w_B", "w_C"):
        if len(dims) == 3:  # MoE [E, D, F]: EP on experts when divisible
            if _div(dims[0], mesh, "model"):
                return out("model", _maybe(dims[1], mesh, fsdp), None)
            return out(None, _maybe(dims[1], mesh, fsdp), _maybe(dims[2], mesh, "model"))
        if len(dims) == 1:
            return out(_maybe(dims[0], mesh, "model"))
        return out(_maybe(dims[0], mesh, fsdp), _maybe(dims[1], mesh, "model"))
    if leaf in ("wo", "w_out", "r"):
        if len(dims) == 3:  # MoE [E, F, D]
            if _div(dims[0], mesh, "model"):
                return out("model", None, _maybe(dims[2], mesh, fsdp))
            return out(None, _maybe(dims[1], mesh, "model"), _maybe(dims[2], mesh, fsdp))
        return out(_maybe(dims[0], mesh, "model"), _maybe(dims[1], mesh, fsdp))
    if leaf == "router":
        return out(_maybe(dims[0], mesh, fsdp), None)
    if leaf in ("bq", "bk", "bv"):
        return out(_maybe(dims[0], mesh, "model"))
    return out()


def param_specs(cfg, params, mesh) -> dict[str, P]:
    """``{name: spec}`` over ``params.named_parameters()`` (TP × FSDP)."""
    return {name: param_spec(name, p.shape, mesh) for name, p in params.named_parameters()}


def batch_specs(cfg, batch: dict, mesh, *, batch_size: int) -> dict[str, P]:
    """Batch inputs: the batch dim on ("pod", "data") when divisible, else
    replicated (long_500k has a global batch of 1: model-parallel only)."""
    bspec = _maybe(batch_size, mesh, _fsdp(mesh))
    return {k: P(bspec, *([None] * (x.ndim - 1))) if x.ndim >= 1 else P()
            for k, x in batch.items()}


def decode_state_specs(cfg, state: dict, mesh, *, batch_size: int,
                       cache_seq_shard: bool = False) -> dict[str, P]:
    """Caches and states, stacked ``[L, B, ...]``: B on the fsdp axes;
    kv-heads or head_dim on "model".

    ``cache_seq_shard`` shards the KV cache over the sequence on "model"
    instead (split-KV, flash-decoding style): scores and PV reduce locally
    per shard, and only the softmax statistics and the [B, 1, D] output
    cross devices.
    """
    bspec = _maybe(batch_size, mesh, _fsdp(mesh))

    def spec_for(leaf: str, dims) -> P:
        if leaf in ("cache_k", "cache_v"):            # [L, B, S, kv, hd]
            if cache_seq_shard and _div(dims[2], mesh, "model"):
                return P(None, bspec, "model", None, None)
            kv_spec = _maybe(dims[3], mesh, "model")
            hd_spec = _maybe(dims[4], mesh, "model") if kv_spec is None else None
            return P(None, bspec, None, kv_spec, hd_spec)
        if leaf == "mlstm_S":                         # [L, B, H, hd, hd]
            return P(None, bspec, None, _maybe(dims[3], mesh, "model"), None)
        if leaf == "mlstm_n":                         # [L, B, H, hd]
            return P(None, bspec, None, _maybe(dims[3], mesh, "model"))
        if leaf == "mamba_h":                         # [L, B, di, N]
            return P(None, bspec, _maybe(dims[2], mesh, "model"), None)
        if leaf.startswith("slstm"):                  # [L, B, D]
            return P(None, bspec, _maybe(dims[2], mesh, "model"))
        return P(*([None] * len(dims)))

    return {k: spec_for(k, tuple(x.shape)) for k, x in state.items()}


def placements(mesh, spec: P) -> tuple:
    """One DTensor placement per mesh dim for ``spec``: a tensor dim on
    ("pod", "data") is ``Shard(d)`` on both mesh dims, in that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A mesh and one DTensor placement per mesh dim (the reference's
    ``NamedSharding``)."""

    mesh: Any
    placements: tuple


def named(mesh, specs: Any) -> Any:
    """``specs`` (a :class:`P`, or dicts, lists and named tuples of them)
    with every spec turned into a :class:`NamedSharding` on ``mesh``."""
    if isinstance(specs, P):
        return NamedSharding(mesh, placements(mesh, specs))
    if isinstance(specs, dict):
        return {k: named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(named(mesh, v) for v in specs))
    if isinstance(specs, (list, tuple)):
        return type(specs)(named(mesh, v) for v in specs)
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def mesh_device(mesh):
    """The device a mesh's local shards live on."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute(t, sharding: NamedSharding | None, device=None):
    """``t`` placed by ``sharding`` (a DTensor), or moved to ``device`` when
    ``sharding`` is None. Every rank passes the same full tensor. A tensor
    on the meta device gives a DTensor whose local shard is on the meta
    device too (shapes only, as the dry-run needs)."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.models.sharding import shard_offset

    if sharding is None:
        return t.to(device)
    mesh, pl = sharding.mesh, sharding.placements
    if t.is_meta:
        local, _ = shard_offset(t.shape, mesh, pl)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
                                  run_check=False, shape=t.shape, stride=t.stride())
    return distribute_tensor(t.to(mesh_device(mesh)), mesh, pl)


def distribute_params(params, shardings: dict[str, NamedSharding]):
    """Replace each parameter of the module ``params`` by a DTensor placed
    by ``shardings[name]``, keeping its ``requires_grad``; returns
    ``params``."""
    import torch
    from torch import nn

    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = params.get_submodule(owner) if owner else params
        with torch.no_grad():
            dt = distribute(p.detach(), shardings[name])
        setattr(module, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return params


def world_mesh(device: str = "cuda"):
    """Under ``torchrun`` (``WORLD_SIZE`` set): the default process group
    (NCCL on the card, gloo on the CPU) and a ``(1, world)`` ("data",
    "model") mesh over it, as the reference builds ``(1, n_dev)``; None
    otherwise."""
    if "WORLD_SIZE" not in os.environ:
        return None
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return init_device_mesh(dev.type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))
