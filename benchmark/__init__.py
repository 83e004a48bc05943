"""The benchmark of the PyTorch and CUDA port (``smallvcm_tpu_torch``).

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line; README.md says how cells, configurations, traffic mixes and metrics
are added as files.
"""
