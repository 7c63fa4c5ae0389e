"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), which ``ctypes`` loads. The build runs at first use, never
at import; its output goes to ``build/kernels/`` beside the package (listed
in ``.gitignore``), named by a hash of the source, of every header under
``csrc/`` and of the flags, so an edited source or shared header rebuilds
and an unchanged one is reused. A failed build raises with the compiler's
output; a successful one keeps it beside the library (``-Xptxas -v``: each
kernel's registers, spills and static shared memory, see
:func:`resource_usage`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for nvcc in candidates:
        if nvcc and os.path.exists(nvcc):
            return nvcc
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from mkg_analogy_tpu_torch/csrc at "
        "first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: its name carries a
    hash of that source, of every header under ``csrc/`` (a source may
    include any of them) and of the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(p for ext in ("*.cuh", "*.h") for p in CSRC.glob(ext)):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def resource_usage(name: str) -> List[dict]:
    """What ``ptxas -v`` said of each kernel of the built ``csrc/<name>.cu``:
    entry, registers a thread, spill bytes and static shared memory (dynamic
    shared memory is the launcher's and not in it)."""
    log = library_path(name).with_suffix(".log").read_text()
    entries = re.findall(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes spill "
        r"loads.*?Used (\d+) registers(?:[^\n]*?(\d+) bytes smem)?", log, flags=re.S)
    return [dict(entry=e, registers=int(r), spill_store_bytes=int(ss),
                 spill_load_bytes=int(sl), static_smem_bytes=int(sm or 0))
            for e, ss, sl, r, sm in entries]


def build(names: Iterable[str] = ()) -> None:
    """Build the named kernels (default: every ``csrc/*.cu``) that are not
    built yet, one nvcc process per source, all started together. Each
    compiles into a temporary file that is renamed into place, so a
    concurrent builder never loads a half-written library."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, tmp, proc))
    errors = []
    for name, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            library_path(name).with_suffix(".log").write_text(log)
            os.replace(tmp, library_path(name))
        else:
            os.unlink(tmp)
            errors.append(f"nvcc failed to build {name}.cu:\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib
