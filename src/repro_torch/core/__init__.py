"""Offline core of the port: fuzzy trees, LUTs, quantization, PegasusLinear,
backprop refinement, and the Partition/Map/SumReduce IR with its fusion
passes."""
