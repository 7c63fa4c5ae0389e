"""The OpenKE-ABI sampler (``kgsampler.cpp``), the port's own copy, built
with ``g++`` at first use and loaded with ``ctypes``."""

from .api import KGSamplerLib, NativeTrainLoader, NativeTestLoader

__all__ = ["KGSamplerLib", "NativeTrainLoader", "NativeTestLoader"]
