"""Benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python graftbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything a cell needs is found by name: its model
configuration in ``configs/``, its traffic mix in ``traffic/``, its
output limits in ``limits/`` and each per-layer metric's reader in
``metrics/``. The yardstick (traffic generation, FLOP and byte counts,
percentiles, the profile reduction and the float32 reference) lives
here; nothing here imports ``jax`` or the JAX package ``repro``.
"""
