"""The benchmark of ``cugp_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA H100 cards. ``run.py`` runs one cell once; ``BENCHMARK.json`` at
the root of the repository lists the cells and metrics. Nothing here
imports JAX or the JAX package, and the reference (``reference/``)
imports nothing of the program.
"""
