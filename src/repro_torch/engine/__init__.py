"""Execution engine of the port: compiled plans over the fuzzy-LUT kernels.

Exports the sequential-family plan of :mod:`repro_torch.engine.plan`; the
plan registry comes with a later slice.
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
)

__all__ = [
    "BACKENDS",
    "DEFAULT_BUCKETS",
    "DEFAULT_FUSE_NMAX_CAP",
    "STATS",
    "CompiledBank",
    "EngineStats",
    "ExecutionPlan",
    "FusedBankStack",
    "bucket_batch",
    "bucket_chunks",
    "build_plan",
    "fuse_banks",
]
