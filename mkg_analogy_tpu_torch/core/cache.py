"""Build the native code a CLI run launches before its first step
(``mkg_analogy_tpu/core/cache.py``).

The JAX CLIs call ``enable_compilation_cache`` first, so that compiled
programs are kept on disk and a run does not pay for a compile inside its
first step. In the port the compiled code is the CUDA kernels of
``csrc/`` (``kernels/build.py``, nvcc, libraries kept under
``build/kernels/``) and the KGE silos' sampler (``native/build.py``, g++,
under ``build/native/``): this builds what the run will launch, each
library once, so no step includes a compile. A build failure raises.
"""

from __future__ import annotations

import torch


def enable_compilation_cache(device="cuda", kernels: bool = True,
                             native_sampler: bool = False) -> None:
    """Build, before the first step, the native libraries a run on
    ``device`` launches: with ``kernels``, every ``csrc/*.cu`` (one nvcc
    process each, all started together), only where ``device`` is a CUDA
    device; with ``native_sampler``, the OpenKE sampler. Libraries already
    built are reused."""
    if kernels and torch.device(device).type == "cuda":
        from ..kernels import build

        build.build()
    if native_sampler:
        from ..native import build as native_build

        native_build.build()
