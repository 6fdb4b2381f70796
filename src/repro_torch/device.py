"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU. A CUDA
    device always carries its index (``"cuda"`` is the current card).

    Raises ``RuntimeError`` for a CUDA device when CUDA is missing: the
    port never drops to the CPU unless the caller asked for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the port on "
                "the CPU (the kernels then run as their plain PyTorch versions)")
        if dev.index is None:   # one name per card: plans and graphs key on it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
