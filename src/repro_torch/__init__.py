"""Pegasus on an NVIDIA H100 — the PyTorch/CUDA port of :mod:`repro`.

The package mirrors the JAX package's module names (``core``, ``kernels``,
``engine``, ``launch`` ...) so each port sits beside its reference. It
imports torch, numpy and the standard library only — never ``jax`` and
nothing of ``repro``.

Entry points run on the GPU unless the caller asks for the CPU with
``device="cpu"``; without CUDA they raise instead of falling back (see
:func:`repro_torch.device.resolve_device`). On the CPU every hand-written
CUDA kernel is replaced by its plain PyTorch version, chosen only because
the tensors lie on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
