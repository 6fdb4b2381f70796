"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python bench/run.py --workload <name> --seed <n> --seconds <s> --trace 0|1``
runs one cell of ``BENCHMARK.json``. Configurations, traffic mixes and
metrics are files under ``configs/``, ``mixes/`` and ``metrics/``, found
by the names ``BENCHMARK.json`` gives them.
"""
