"""Execution engine of the port: compiled plans over the fuzzy-LUT kernels.

:func:`build_plan` compiles any pegasusified model (MLP-B and AutoEncoder
bank lists, ``PegasusRNN``, ``PegasusCNN``, ``PegasusCNNL``) into an
:class:`ExecutionPlan`; :func:`plan_for` memoizes it in a weakref-watched,
LRU-bounded :class:`PlanRegistry`.
"""

from .plan import (
    BACKENDS,
    DEFAULT_BUCKETS,
    DEFAULT_FUSE_NMAX_CAP,
    STATS,
    CompiledBank,
    EngineStats,
    ExecutionPlan,
    FusedBankStack,
    bucket_batch,
    bucket_chunks,
    build_plan,
    fuse_banks,
    resolve_devices,
)
from .registry import PlanRegistry, default_registry, plan_for, reset_plan_cache

__all__ = [
    "BACKENDS",
    "DEFAULT_BUCKETS",
    "DEFAULT_FUSE_NMAX_CAP",
    "STATS",
    "CompiledBank",
    "EngineStats",
    "ExecutionPlan",
    "FusedBankStack",
    "PlanRegistry",
    "bucket_batch",
    "bucket_chunks",
    "build_plan",
    "default_registry",
    "fuse_banks",
    "plan_for",
    "reset_plan_cache",
    "resolve_devices",
]
