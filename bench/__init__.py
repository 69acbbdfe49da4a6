"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of madupite.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on an NVIDIA GPU and
prints one JSON line; ``bench/README.md`` says how it is laid out and how
a cell, a configuration or a metric is added.  Nothing here imports the
JAX package or JAX.
"""
