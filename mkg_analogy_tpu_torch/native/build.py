"""Build the port's OpenKE-ABI sampler (``kgsampler.cpp``) with ``g++``.

Plain C++, no CUDA: it compiles with the host compiler into a shared
library that ``native.api`` loads with ``ctypes``. The build runs at first
use, never at import. Its output goes to ``build/native/`` beside the
package (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused. It
compiles into a temporary file that is renamed into place, so a process
building it at the same time (a pytest-xdist worker) never loads a
half-written library. The name differs from the JAX package's
``libkgsampler.so``: each library keeps global state, and a process may
load both.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "kgsampler.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libkgsampler_port_{digest.hexdigest()[:12]}.so"


def build() -> str:
    """The library's path, built first if needed."""
    lib = library_path()
    if lib.exists():
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", *FLAGS, "-o", tmp, str(SRC)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return str(lib)


if __name__ == "__main__":
    print(build())
