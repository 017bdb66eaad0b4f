"""The benchmark of the PyTorch and CUDA port on one NVIDIA H100.

``python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. The package
imports nothing of the JAX package, and its reference (``reference/``)
nothing of the measured one.
"""
