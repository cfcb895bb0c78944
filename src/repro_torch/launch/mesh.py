"""Production mesh construction: the port of ``repro/launch/mesh.py`` on
``torch.distributed``'s ``DeviceMesh`` (a FUNCTION: importing this module
starts no process group).

The mesh is built over the default process group, which the caller
opens: ``init_process_group`` on the cluster (NCCL, ``device_type="cuda"``)
or ``fake_world(n)`` for the dry run, where this one process is rank 0 of
``n`` and collectives move nothing.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 GPUs.  Multi-pod:
    (pod=2, data=16, model=16) = 512 GPUs.  The default process group must
    have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes carrying the batch (and FSDP parameter sharding)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh: DeviceMesh) -> str:
    return "model"


def mesh_device_count(mesh: DeviceMesh) -> int:
    return int(mesh.size())


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks, this process rank 0,
    for the span of the ``with``: DTensor shards and plans collectives as
    on ``n`` GPUs, and no collective moves data.  Raises if a default
    group is already open."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
