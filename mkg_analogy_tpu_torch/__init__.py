"""mkg_analogy_tpu_torch — the PyTorch and CUDA port of ``mkg_analogy_tpu``
for one NVIDIA H100 (Hopper, sm_90a).

It keeps the JAX package's module paths and names, so each piece has an
obvious counterpart there, and imports nothing of it (nor JAX). Ported so
far: fine-tuning, MarKG pre-training and evaluation of ``MKGformerKGC``.

- ``models``   — UniMo (MKGformer) as ``nn.Module``s, the Flax weight map.
- ``kernels``  — hand-written CUDA kernels (``csrc/``): the single-block
                 fused-attention forward and backward, the flash (K-blocked)
                 forward, dK/dV and dQ, each with its plain PyTorch version;
                 the build and ``ctypes`` loader.
- ``data``     — MarKG/MARS readers, fine-tune and pre-train prompts,
                 batching.
- ``text``     — self-contained WordPiece tokenizer (offline-first).
- ``ops``      — analogy masks, losses and ranking metrics.
- ``train``    — the MarT trainer (fine-tune, pre-train, evaluation), AdamW with its
                 schedule, checkpoints.
- ``utils``    — metric logging, step timing and ``torch.profiler`` traces.
- ``cli``      — ``python -m mkg_analogy_tpu_torch.cli.main``.

Entry points run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
