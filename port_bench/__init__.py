"""The benchmark of the PyTorch and CUDA port (``mkg_analogy_tpu_torch``):
one cell a run, found by name from ``BENCHMARK.json``; see ``run.py``."""
