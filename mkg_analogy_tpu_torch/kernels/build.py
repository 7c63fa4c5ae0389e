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

The eleven libraries: the eight attention sources (``ATTENTION_SOURCES``),
``resize_normalize``, ``gelu_poly`` and ``adamw``; the last three have no
head-width instances.

Head widths (``csrc/attention_width.cuh``): the eight attention libraries
among the eleven carry their kernels at head_dim 64 and 128. Any other width
d up to 256 runs the instance of its padded width ``Dp`` (d rounded up to
a multiple of 16 up to 128, of 64 above: 192 or 256), compiled from the
same attention sources with ``-DMKG_ATTN_DP=<Dp>`` into a library of its own,
``lib<name>_d<Dp>_<hash>.so`` (the define in the hash), built at the first
call that needs it or by :func:`build_widths` (the CLI, through
``core/cache.py``, before its first batch).
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
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the attention sources, each also built at the padded widths of other heads
ATTENTION_SOURCES = ("flash_attention_bwd", "flash_attention_bwd_mma", "flash_attention_fwd",
                     "flash_attention_fwd_mma", "fused_attention_bwd",
                     "fused_attention_bwd_mma", "fused_attention_fwd",
                     "fused_attention_fwd_mma")
BASE_HEAD_DIMS = (64, 128)  # the attention instances of the eleven libraries
MAX_HEAD_DIM = 256

_LOADED: Dict[tuple, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def padded_width(head_dim: int) -> int:
    """The tile width of the attention kernels for a head of ``head_dim``
    columns: ``head_dim`` rounded up to a multiple of 16 up to 128, and to a
    multiple of 64 above (every block of a head wider than 128 owns 64 of
    its result columns, so 192 and 256 are the only tiles there). Above
    :data:`MAX_HEAD_DIM` (or below 1) it raises."""
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"the attention kernels take head_dim 1 to {MAX_HEAD_DIM}, "
                         f"got {head_dim}")
    step = 16 if head_dim <= 128 else 64
    return -(-head_dim // step) * step


def library_width(head_dim: int) -> Optional[int]:
    """The padded width whose library carries the attention kernels of a
    call of ``head_dim``: None for 64 and 128 (the eleven libraries' own
    attention instances), else :func:`padded_width`."""
    width = padded_width(head_dim)
    return None if head_dim in BASE_HEAD_DIMS else width


def _flags(width: Optional[int]) -> tuple:
    return NVCC_FLAGS + (() if width is None else (f"-DMKG_ATTN_DP={width}",))


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


def library_path(name: str, width: Optional[int] = None) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built (at the padded head
    ``width``, or as it stands for None): its name carries a hash of that
    source, of every header under ``csrc/`` (a source may include any of
    them) and of the flags, the width's define among them."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(p for ext in ("*.cuh", "*.h") for p in CSRC.glob(ext)):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_flags(width)).encode())
    tag = "" if width is None else f"_d{width}"
    return BUILD_DIR / f"lib{name}{tag}_{digest.hexdigest()[:12]}.so"


def resource_usage(name: str, width: Optional[int] = None) -> List[dict]:
    """What ``ptxas -v`` said of each kernel of the built ``csrc/<name>.cu``
    (at the padded head ``width``, or as it stands): entry, registers a
    thread, spill bytes and static shared memory (dynamic shared memory is
    the launcher's and not in it)."""
    log = library_path(name, width).with_suffix(".log").read_text()
    entries = re.findall(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes spill "
        r"loads.*?Used (\d+) registers(?:[^\n]*?(\d+) bytes smem)?", log, flags=re.S)
    return [dict(entry=e, registers=int(r), spill_store_bytes=int(ss),
                 spill_load_bytes=int(sl), static_smem_bytes=int(sm or 0))
            for e, ss, sl, r, sm in entries]


def build(names: Iterable[str] = ()) -> None:
    """Build the named kernels (default: every ``csrc/*.cu``) that are not
    built yet; see :func:`build_jobs`."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    build_jobs([(name, None) for name in names])


def build_widths(head_dims: Iterable[int], names: Iterable[str] = ATTENTION_SOURCES) -> None:
    """Build the attention libraries of each head width's padded width
    (none for 64 and 128, which the eleven libraries carry), all together."""
    widths = sorted({w for w in map(library_width, head_dims) if w is not None})
    build_jobs([(name, w) for w in widths for name in names])


def build_jobs(jobs: Iterable[tuple]) -> None:
    """Build each (source name, padded width or None) that is not built yet,
    one nvcc process per library, all started together. Each compiles into
    a temporary file that is renamed into place, so a concurrent process
    never loads a half-written library."""
    todo = [(n, w) for n, w in jobs if not library_path(n, w).exists()]
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, width in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *_flags(width), "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((name, width, tmp, proc))
    errors = []
    for name, width, tmp, proc in procs:
        log, _ = proc.communicate()
        path = library_path(name, width)
        if proc.returncode == 0:
            path.with_suffix(".log").write_text(log)
            os.replace(tmp, path)
        else:
            os.unlink(tmp)
            at = "" if width is None else f" at MKG_ATTN_DP={width}"
            errors.append(f"nvcc failed to build {name}.cu{at}:\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, width: Optional[int] = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (at the padded head
    ``width``, or as it stands), built first if needed."""
    with _LOCK:
        lib = _LOADED.get((name, width))
        if lib is None:
            build_jobs([(name, width)])
            lib = ctypes.CDLL(str(library_path(name, width)))
            _LOADED[(name, width)] = lib
        return lib
