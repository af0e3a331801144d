"""Placements of the port: the LM's sharding rules on DTensor and the
ISLA cell axis of ``route="mesh"``."""
from .specs import (ISLA_CELL_AXIS, MeshSharding, PartitionSpec, Placement,
                    activation_constraint, batch_specs, cache_specs,
                    dp_axes, isla_cell_specs, opt_state_specs, param_specs,
                    shardings)

__all__ = ["ISLA_CELL_AXIS", "MeshSharding", "PartitionSpec", "Placement",
           "activation_constraint", "batch_specs", "cache_specs", "dp_axes",
           "isla_cell_specs", "opt_state_specs", "param_specs", "shardings"]
