"""The ISLA cell mesh (``route="mesh"``): the devices a ``MeshDeviceStack``
splits its stacked (store, group, block) cell axis over, by block runs.

A mesh is an explicit tuple of ``torch.device``s, one entry a shard, with
the name of its one axis (``"cells"``).  One host program drives every
shard: the executor plans, draws and composes once, and each shard runs
the tick kernels on its own rows on its own device.  Several shards may
sit on one device (``devices=["cuda:0"] * 4``, ``["cpu"] * 3``).

Functions (never module-level meshes), so importing this module touches
no device.  The production meshes of the LM's sharding
(``make_production_mesh``, ``make_host_mesh``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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


def mesh_devices(mesh) -> int:
    """How many shards ``mesh`` has."""
    return len(mesh.devices)


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
