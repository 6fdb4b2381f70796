"""Fuzzy-LUT Map+SumReduce kernels: hand-written CUDA for Hopper, each with
its plain PyTorch version beside it (see ``kernel.py``, ``quantized.py``)."""
