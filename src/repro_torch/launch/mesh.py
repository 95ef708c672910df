"""Device meshes, the port of ``repro.launch.mesh``.

Functions, not module-level constants, so importing this module never
starts a process group.

``make_production_mesh`` builds the production meshes over a *fake*
process group: torch's ``"fake"`` backend, registered by
``torch.testing._internal.distributed.fake_pg`` (private API), whose
collectives return at once without moving data.  This process plays rank
0 of 512; the single-pod mesh is ranks 0–255 of them.  It is what the
meta-device dry-run traces over, and it refuses to run in a process that
already holds a real process group.

``make_host_mesh`` builds a mesh over the ranks that really exist: NCCL
on the card by default, gloo only when ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

FAKE_WORLD = 512


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init_fake() -> None:
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "make_production_mesh needs a process without a real "
                f"process group (this one runs {dist.get_backend()!r})")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=FAKE_WORLD)


def make_fake_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A mesh over the first ranks of the fake process group (this
    process is rank 0): for planning and tracing only."""
    from torch.distributed.device_mesh import DeviceMesh
    _init_fake()
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 256 ranks as (16, 16) ("data", "model").
    Multi-pod: 2 pods = 512 ranks as (2, 16, 16) ("pod", "data", "model").
    Over the fake process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes)


def make_host_mesh(shape: Sequence[int] = (1, 1),
                   axes: Sequence[str] = ("data", "model"),
                   device: Optional[str] = None):
    """A mesh over the ranks that exist: NCCL over the GPUs (``device``
    None or "cuda"), gloo over CPU processes (``device="cpu"``).  Starts
    the process group if the caller has not: rank and world size from
    ``RANK`` / ``WORLD_SIZE`` (default a world of one), the rendezvous
    from ``MASTER_ADDR`` / ``MASTER_PORT`` (default a free localhost
    port)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"make_host_mesh: no process group for {dev}")
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT") or str(_free_port())
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world)
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))
