"""The benchmark of sradsgan_tpu_torch on an NVIDIA H100.

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything of one configuration, traffic mix, per-layer metric
or cell's limits sits in a file of its own under ``configs/``,
``traffic/``, ``metrics/`` and ``limits/``, found by its name.
"""
