"""The port's benchmarks (counterparts of ``scripts/bench_*.py``).

Each module runs as ``python -m merv_tpu_torch.bench.<name>`` on the card,
or at the tiny size with ``--device cpu``; each reads ``merv_tpu``'s
``BENCH_*`` environment names with its defaults and prints its kernel launch
counts (``{"launches": ...}``) and then one JSON result line with the
``merv_tpu`` script's keys and the device it ran on.
"""
