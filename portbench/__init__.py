"""The benchmark of the simulator's PyTorch and CUDA port (``repro_torch``).

``run.py`` is the entry: it reads ``BENCHMARK.json`` at the root of the
checkout, finds the cell's configuration under ``configs/`` and its
traffic mix under ``traffic/`` by name, drives one public entry of the
port for a measured window, and holds every statistic the window
produced against ``reference/``, a plain PyTorch simulator frozen here.
Each per-layer metric is a reader under ``metrics/`` with the metric's
name.  Nothing here imports JAX or the JAX package.
"""
