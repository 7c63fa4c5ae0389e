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
                             native_sampler: bool = False, head_dims=()) -> None:
    """Build, before the first step, the native libraries a run on
    ``device`` launches: with ``kernels``, every ``csrc/*.cu`` (one nvcc
    process each, all started together), and for ``head_dims`` the
    attention libraries of each width other than 64 and 128
    (``kernels/build.py:build_widths``), only where ``device`` is a CUDA
    device; with ``native_sampler``, the OpenKE sampler. Libraries already
    built are reused."""
    if torch.device(device).type == "cuda" and (kernels or head_dims):
        from ..kernels import build

        if kernels:
            build.build()
        if head_dims:
            build.build_widths(head_dims)
    if native_sampler:
        from ..native import build as native_build

        native_build.build()
