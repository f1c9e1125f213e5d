"""The benchmark of spair_pytorch_tpu_torch on NVIDIA cards.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Configurations, traffic mixes,
limits and per-layer metrics are files found by the names the manifest
gives them (``registry.py``).
"""
