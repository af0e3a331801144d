"""The meshes of the port (``repro.launch.mesh`` in torch).

The LM meshes: ``make_host_mesh`` is a ``torch.distributed`` ``DeviceMesh``
over the initialised default process group, one process a device
(``nccl`` on cards, ``gloo`` on the CPU); ``make_production_mesh`` names
the reference's (16, 16) ``("data", "model")`` and (2, 16, 16)
``("pod", "data", "model")`` meshes, as a device-free ``AbstractMesh``
unless a process group of that size is up, so the sharding rules can be
evaluated without 256 ranks.

The ISLA cell mesh (``route="mesh"``): the devices a ``MeshDeviceStack``
splits its stacked (store, group, block) cell axis over, by block runs.

A mesh is an explicit tuple of ``torch.device``s, one entry a shard, with
the name of its one axis (``"cells"``).  One host program drives every
shard: the executor plans, draws and composes once, and each shard runs
the tick kernels on its own rows on its own device.  Several shards may
sit on one device (``devices=["cuda:0"] * 4``, ``["cpu"] * 3``).

Functions (never module-level meshes), so importing this module touches
no device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core.distributed import resolve_device


@dataclasses.dataclass(frozen=True)
class CellMesh:
    """A 1-D mesh: ``devices[s]`` holds shard ``s``."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "cells"

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices (the reference's
    ``compat.make_abstract_mesh``): what the sharding rules read."""

    axis_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order (as ``jax`` ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_shape))

    @property
    def size(self) -> int:
        return math.prod(self.axis_shape)


def make_abstract_mesh(shape: Sequence[int],
                       axes: Sequence[str]) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def _world_size() -> int:
    """The default process group's size, 0 when none is up."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_world_size()


def make_host_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    default process group (rank r at the r-th place in row-major order;
    ``cuda`` for an ``nccl`` group, each rank on its current card, else
    ``cpu``).  Raises when no group is up or its world is not
    ``prod(shape)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    world = _world_size()
    if world != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh over {tuple(axes)} needs "
            f"{n} ranks; the process group has {world or 'none'}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_rank_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` ranks
    of the process group (the elastic recovery's smaller mesh; the whole
    world is ``make_host_mesh``).  Every rank of the new mesh calls it; a
    rank outside it that calls it gets a mesh in which it has no place
    (``in_mesh`` is False)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    world = _world_size()
    if world == n:
        return make_host_mesh(shape, axes)
    if not 1 <= n < world:
        raise RuntimeError(f"a {n}-rank mesh from a process group of "
                           f"{world or 'no'} ranks")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def in_mesh(mesh) -> bool:
    """Whether this process holds a place in ``mesh``."""
    return mesh.get_coordinate() is not None


def mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for every other (a barrier along each
    mesh dim in turn reaches them all)."""
    import torch.distributed as dist
    for d in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(d))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) data x model = 256 devices.  Multi-pod: (2, 16,
    16) pod x data x model = 512.  A ``DeviceMesh`` when a process group
    of that size is up, else the ``AbstractMesh``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if _world_size() == math.prod(shape):
        return make_host_mesh(shape, axes)
    return make_abstract_mesh(shape, axes)


def mesh_devices(mesh) -> int:
    """How many devices (an LM mesh) or shards (a ``CellMesh``) ``mesh``
    has."""
    if isinstance(mesh, CellMesh):
        return len(mesh.devices)
    if isinstance(mesh, AbstractMesh):
        return mesh.size
    return int(mesh.size())


def _shard_device(device) -> torch.device:
    """A shard's device, checked: a card that is not there raises."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = (torch.cuda.current_device() if dev.index is None
                 else dev.index)
        if not 0 <= index < torch.cuda.device_count():
            raise RuntimeError(
                f"no CUDA device {index}: {torch.cuda.device_count()} "
                f"visible")
        dev = torch.device("cuda", index)
    return dev


def make_cell_mesh(n_shards: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> CellMesh:
    """The 1-D ``"cells"`` mesh of ``route="mesh"``.

    By default one shard on each visible card (``n_shards`` of them, at
    most as many as there are).  ``devices`` names the shards' devices
    one entry a shard instead (several shards on one card, or on the
    CPU).  Without a card and without ``devices`` it raises; it never
    drops to the CPU on its own."""
    if devices is not None:
        devs = tuple(_shard_device(d) for d in devices)
        if not devs:
            raise ValueError("a cell mesh needs at least one shard")
        if n_shards is not None and int(n_shards) != len(devs):
            raise ValueError(f"n_shards={n_shards} but {len(devs)} devices")
        return CellMesh(devs)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] * n to run "
            "the mesh's shards on the CPU")
    n_cards = torch.cuda.device_count()
    n = n_cards if n_shards is None else int(n_shards)
    if not 1 <= n <= n_cards:
        raise ValueError(f"{n} shards, one a card, but {n_cards} cards are "
                         f"visible; pass devices= to put several shards on "
                         f"one card")
    return CellMesh(tuple(torch.device("cuda", i) for i in range(n)))
