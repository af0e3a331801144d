"""Role-based activation constraints inside model code (the port's copy
of ``repro.sharding.context``, MoE part only).

The reference asks GSPMD for an expert-parallel layout of the MoE
dispatch tensors when a mesh is active and returns its input otherwise.
The port has no GSPMD mesh: one device holds every expert, so the
constraint is the identity.  Its DTensor placements (experts over the
model axis, groups over the data axes) come with the LM sharding rules
(ROADMAP Queue A item 12).
"""
from __future__ import annotations

import torch


def constrain_expert_parallel(xe: torch.Tensor, expert_dim: int = 0,
                              group_dim: int = 1) -> torch.Tensor:
    """(E', G, C, d) activations: experts on ``expert_dim``, groups on
    ``group_dim``.  Without a mesh, ``xe`` itself."""
    return xe
