"""Device mesh construction (``mkg_analogy_tpu/core/mesh.py``).

Axes:
- ``dp`` — data parallel (batch dimension).
- ``tp`` — tensor parallel (vocab/MLP/head dimensions).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
(dp, tp) over the ranks of the default process group, with dim names
``("dp", "tp")``; ``mesh.get_group("dp")`` and ``mesh.get_group("tp")`` are
the groups the collectives run on. One process drives one device: the
devices are the ranks' devices, in rank order. A list that repeats
``cuda:0`` puts several ranks on one card (the counterpart of JAX's virtual
CPU devices); on the CPU the devices are the processes, any count.

The backend follows the devices (``backend_for``): NCCL where each rank has
a GPU of its own, gloo where ranks share a GPU (NCCL refuses two ranks on
one device) and on the CPU. A 1x1 mesh needs no process group: without one,
``make_mesh`` returns None, the single-device path, which calls no
collective. The helpers ``axis_size``, ``axis_rank`` and ``axis_group``
read a mesh or None alike; an axis of size 1 has no group, so a mesh of
size 1 runs no collective either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshAxes:
    dp: str = "dp"
    tp: str = "tp"


AXES = MeshAxes()


def default_devices() -> List[torch.device]:
    """The visible CUDA devices; without one, the CPU once a process (the
    world size of the default group, else 1)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = dist.get_world_size() if dist.is_initialized() else 1
    return [torch.device("cpu")] * n


def backend_for(devices: Sequence) -> str:
    """"nccl" where every rank has a CUDA device of its own, else "gloo"
    (ranks sharing a card, or the CPU)."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence] = None):
    """Build a (dp, tp) mesh over ``devices`` (default: ``default_devices()``),
    one rank each, in rank order.

    ``dp`` defaults to ``len(devices) // tp``; ``dp * tp`` must equal the
    device count. With one device and no process group this is None (the
    single-device path); otherwise the default group must hold one rank per
    device."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    n = len(devices)
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices do not split into tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    if not dist.is_initialized():
        if n == 1:
            return None
        raise RuntimeError(
            f"a mesh of {n} devices needs a process group of {n} ranks "
            "(torch.distributed.init_process_group, or parallel/launch.py)")
    if dist.get_world_size() != n:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, "
                         f"the mesh {n} devices")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(devices[0].type, torch.arange(n).reshape(dp, tp),
                      mesh_dim_names=(AXES.dp, AXES.tp))


def _dim(mesh, axis: str) -> int:
    return list(mesh.mesh_dim_names).index(axis)


def axis_size(mesh, axis: str) -> int:
    """The mesh's extent along ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(mesh.mesh.shape[_dim(mesh, axis)])


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    if mesh is None:
        return 0
    return int(mesh.get_coordinate()[_dim(mesh, axis)])


def axis_group(mesh, axis: str):
    """The process group along ``axis``, or None where the axis has one
    rank: no collective runs there."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def is_main(mesh) -> bool:
    """Rank 0 of the mesh (every process without one): the one that logs,
    dumps ranks and writes checkpoints."""
    return mesh is None or dist.get_rank() == 0
