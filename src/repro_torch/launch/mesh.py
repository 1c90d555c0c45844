"""Training meshes, and the GPUs the planning backend shards its grid
scans over (the port of ``repro.launch.mesh``).

``make_mesh`` builds a ``DeviceMesh`` with named dims (the reference's
``("pod", "data", "model")``) over the ranks of the default process
group, one process per device (``torchrun``); ``mesh_axes`` and
``data_parallel_size`` read one.  ``make_production_mesh`` builds the
reference's production meshes, (16, 16) ("data", "model") a pod and (2,
16, 16) ("pod", "data", "model") for two, over the default group.  No
GPU host holds such a slice: the dry run (``launch.dryrun``) builds them
in one process over ``fake_world``, a "fake" process group of 256 or 512
ranks whose collectives move nothing.  Nothing here initialises a
process group at import.

``plan_device_count`` / ``plan_devices`` serve the planning backend's
sharded scans.  ``REPRO_PLAN_DEVICES`` caps how many visible GPUs
planning uses; ``1`` turns sharding off.  One process drives every plan
device, so there is no mesh object there: ``plan_devices()`` is the
ordered device list whose order is the flat-row order of the shards.
"""
from __future__ import annotations

import contextlib
import os
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.sharding import mesh_axes, mesh_shape  # noqa: F401

PLAN_DEVICES_ENV = "REPRO_PLAN_DEVICES"


def plan_device_count() -> int:
    """Visible GPUs the planning backend shards its scans over, capped by
    ``REPRO_PLAN_DEVICES`` (a malformed value is ignored); never below 1,
    and 1 on a host without a GPU.  1 means the sharded code paths are
    bypassed, so ``REPRO_PLAN_DEVICES=1`` is the rollback switch."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    cap = os.environ.get(PLAN_DEVICES_ENV, "").strip()
    if cap:
        try:
            n = min(n, int(cap))
        except ValueError:
            pass
    return max(1, n)


def plan_devices(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first ``n_devices`` GPUs (``plan_device_count()`` of them by
    default), in shard order."""
    n = plan_device_count() if n_devices is None else max(1, int(n_devices))
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over ranks
    ``0 .. prod(shape) - 1`` of the default process group, in row-major
    order (the reference's device order).  Every rank of the world calls
    it; a rank outside a mesh smaller than the world gets no coordinate
    (``mesh.get_coordinate()`` is None).  Raises, as the reference's does,
    when the world is smaller than the mesh.  Its devices are the process
    group's: GPUs under NCCL, else the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed's default "
                           "process group (torchrun, or "
                           "init_process_group)")
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, the world has {world} — "
            f"launch one process per device with torchrun "
            f"--nproc_per_node {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 devices a pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """The default process group as rank ``rank`` of a "fake" world of
    ``world_size`` (``torch.testing._internal.distributed.fake_pg``: every
    collective returns at once and moves nothing), destroyed on exit, so
    one process can trace a rank of a 256-device mesh and then of a
    512-device one.  Raises if a process group is already initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def data_parallel_size(mesh) -> int:
    n = 1
    for a, size in mesh_shape(mesh).items():
        if a in ("pod", "data"):
            n *= size
    return n
