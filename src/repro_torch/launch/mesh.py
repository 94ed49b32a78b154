"""Meshes; counterpart of `repro.launch.mesh`.

`make_production_mesh` describes the production layouts, (16, 16) over
('data', 'model') and (2, 16, 16) over ('pod', 'data', 'model'), as an
`AbstractMesh` (shape and names, no devices): what the sharding rules, the
input specs and the dry-run read.

`make_local_mesh` is the mesh a process runs on: a `DeviceMesh` of
(world, 1) over ('data', 'model') on the default process group, one rank
per device (NCCL on CUDA, gloo on the CPU). With no process group it
initialises a world of one over an in-process store, so one card is a
(1, 1) mesh.

`make_counting_mesh` is a production-sized mesh with no devices behind
it: a `DeviceMesh` over a fake process group of prod(shape) ranks, seen
from rank 0, on which the dry-run runs the real sharded step on meta
tensors and counts what rank 0 computes and sends. All three are
functions: importing this module touches no device and no process group.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.utils import resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


# whether `make_local_mesh` initialised the default process group (so
# `close_local_mesh` may tear it down)
_OWNS_GROUP = False


def make_local_mesh(device=None, shape=None):
    """A DeviceMesh over the default process group: (world, 1) over
    ('data', 'model'), or `shape` (data, model) with data * model = world.
    With no process group up it starts a world of one, which
    `close_local_mesh` ends. `device` defaults to CUDA and raises where
    there is none; pass "cpu" for a gloo mesh. Each rank of a CUDA mesh
    uses the card its `torch.cuda.current_device()` names."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    global _OWNS_GROUP
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        _OWNS_GROUP = True
    world = dist.get_world_size()
    shape = (world, 1) if shape is None else tuple(shape)
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh {shape} does not cover a world of {world}")
    return DeviceMesh(dev.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=("data", "model"))


def close_local_mesh() -> None:
    """Tear down the default process group if `make_local_mesh` started
    it; a group that the caller (or a launcher such as torchrun) started
    stays up for its owner."""
    global _OWNS_GROUP
    import torch.distributed as dist
    if _OWNS_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _OWNS_GROUP = False


@contextlib.contextmanager
def make_counting_mesh(shape):
    """A DeviceMesh of `shape` over the production meshes' axis names
    ('data', 'model', with 'pod' before them for three dimensions) on a
    fake process group of prod(shape) ranks, seen from rank 0: collectives
    run and move nothing. For shape-only steps (meta
    tensors) and their counts; rank 0 holds the largest chunk of an uneven
    shard. Raises if a process group is up, so it never counts against a
    real one, and destroys its group on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = tuple(shape)
    axes = ("pod", "data", "model")[-len(shape):]
    if dist.is_initialized():
        raise RuntimeError("make_counting_mesh: a process group is up; the counting "
                           "mesh takes a fake one of its own")
    world = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield DeviceMesh("cpu", torch.arange(world).reshape(shape), mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


# NVIDIA H100 SXM5 (80 GB HBM3) constants for the roofline, per card, from
# the card's datasheet: dense bf16 tensor-core peak, HBM3 bandwidth, and
# NVLink 4 bandwidth per direction.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 450e9             # B/s per direction
