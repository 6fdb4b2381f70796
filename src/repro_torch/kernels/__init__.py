"""Kernels of the port."""
