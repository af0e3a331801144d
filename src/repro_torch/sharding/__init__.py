"""Placements of the port: the ISLA cell axis of ``route="mesh"``."""
from .specs import ISLA_CELL_AXIS, Placement, isla_cell_specs

__all__ = ["ISLA_CELL_AXIS", "Placement", "isla_cell_specs"]
