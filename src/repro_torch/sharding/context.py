"""Role-based activation constraints inside model code (the port's copy
of ``repro.sharding.context``: the helpers the models call).

The reference asks GSPMD for an expert-parallel layout of the MoE
dispatch tensors, and a head-parallel one of the SSD activations, when a
mesh is active and returns its input otherwise.  The port has no GSPMD
mesh: one device holds every expert and every head, so each constraint
is the identity.  Their DTensor placements (experts and heads over the
model axis, groups and batch over the data axes) come with the LM
sharding rules (ROADMAP Queue A item 12).
"""
from __future__ import annotations

import torch


def constrain_expert_parallel(xe: torch.Tensor, expert_dim: int = 0,
                              group_dim: int = 1) -> torch.Tensor:
    """(E', G, C, d) activations: experts on ``expert_dim``, groups on
    ``group_dim``.  Without a mesh, ``xe`` itself."""
    return xe


def constrain_heads(x: torch.Tensor, head_dim: int,
                    batch_dim: int = 0) -> torch.Tensor:
    """(..., H, ...) Mamba/attention head-parallel activations: heads on
    ``head_dim``, batch on ``batch_dim``.  Without a mesh, ``x`` itself."""
    return x
