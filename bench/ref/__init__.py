"""Frozen copies of the yardstick: the traffic generator, the bound
arithmetic and the profiler reduction. Later changes to the program's
own copies do not move them."""
