"""Placement table of the ISLA mesh (``route="mesh"``).

The reference's ``isla_cell_specs`` gives a ``PartitionSpec`` for each
operand family of ``MeshDeviceStack``; here a ``Placement`` says whether
the operand is split on dim 0 by shard or held whole by every shard, and
``distributed.mesh_h2d`` places host arrays by it.  The LM's sharding
rules (``param_specs`` and the rest) are not ported yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

ISLA_CELL_AXIS = "cells"


class Placement(NamedTuple):
    """``axis``: the mesh axis dim 0 splits over (in equal parts, shard
    order), or None for an operand every shard holds whole."""

    axis: Optional[str]

    @property
    def split(self) -> bool:
        return self.axis is not None


def isla_cell_specs(mesh) -> Dict[str, Placement]:
    """Placements of the ISLA mesh, keyed by operand family:

      cells        (N,)   per-cell vectors (ledger, sketch0, inv_scale,
                          quota rows) and the tagged stream, each shard its
                          own part — split on the cell axis
      cell_rows    (N, k) per-cell matrices (moments, totals, register
                          plane, per-cell cuts, dense block panes) — split
                          on dim 0
      replicated   (...)  small anchor tables (the shared cuts, the dense
                          bound rows) — whole on every shard
      stat_rows    (G, 9) the reduced group-stat rows — whole, one copy on
                          the mesh's first device (``mesh_all_reduce``)
      active_cells (M,)   zone-pruned compacted-launch scatter indices,
                          each shard's LOCAL cell / ledger targets — split
                          like the compact panes they route

    The axis name comes from the mesh, so a mesh with another axis name
    places the same way."""
    ax = mesh.axis_names[0]
    return {
        "cells": Placement(ax),
        "cell_rows": Placement(ax),
        "replicated": Placement(None),
        "stat_rows": Placement(None),
        "active_cells": Placement(ax),
    }
