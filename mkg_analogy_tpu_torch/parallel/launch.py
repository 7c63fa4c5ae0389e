"""One process a rank: start the processes of a mesh, or join a group.

``spawn(fn, devices, rendezvous_dir, args)`` runs ``fn(rank, *args)`` in
``len(devices)`` processes (``torch.multiprocessing``, start method
``spawn``), rank r on ``devices[r]``, each in a default process group of
the backend the devices call for (``core/mesh.backend_for``: NCCL where
each rank has a GPU of its own, gloo where ranks share one, and on the
CPU). The ranks meet through a file under ``rendezvous_dir``, so that
concurrent runs never share a port. A rank that raises fails the spawn.

``join_from_env(devices)`` joins the group that a launcher such as
``torchrun`` describes in the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``).
"""

from __future__ import annotations

import os
import uuid
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.mesh import backend_for


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is ``cuda:0``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", 0)
    return device


def _run(rank: int, fn: Callable, devices, init_method: str, backend: str, args,
         threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=len(devices))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, devices: Sequence, rendezvous_dir: str, args=(),
          threads: Optional[int] = None) -> None:
    """Run ``fn(rank, *args)`` on each of ``devices``, one process a rank,
    and wait for all of them. ``threads``: ``torch.set_num_threads`` in
    every process."""
    devices = [str(_indexed(d)) for d in devices]
    os.makedirs(rendezvous_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(rendezvous_dir), f"rendezvous-{uuid.uuid4().hex}")
    try:
        mp.spawn(_run, args=(fn, devices, f"file://{path}", backend_for(devices), args,
                             threads), nprocs=len(devices), join=True)
    finally:
        if os.path.exists(path):
            os.remove(path)


def launched_by_env() -> bool:
    """Whether the environment describes a process group to join."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join_from_env(devices: Sequence) -> int:
    """Join the environment's process group (``env://``), on
    ``devices[RANK]``; returns the rank."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != len(devices):
        raise ValueError(f"WORLD_SIZE={world}, but the mesh has {len(devices)} devices")
    device = _indexed(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(devices), init_method="env://", rank=rank,
                            world_size=world)
    return rank
