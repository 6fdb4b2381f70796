"""Offline core of the port: fuzzy trees, LUTs, quantization, PegasusLinear."""
