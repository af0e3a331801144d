"""Ambient mesh context for intra-module sharding constraints (the port's
copy of ``repro.sharding.context``).

Model code (MoE dispatch, SSD heads) asks for explicit activation
layouts: the reference's with GSPMD, here a DTensor ``redistribute``.
Modules call the role-based helpers; without an active mesh, or on a
plain tensor, they return their input, so single-device code is
untouched.  The mesh is thread-local, as the reference's.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .specs import (PartitionSpec, fit_placements, mesh_shape,
                    spec_placements)

_STATE = threading.local()

MODEL_AXIS = "model"


def active_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def _dp(shape) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in shape)


def constrain(x, spec: PartitionSpec):
    """``x`` redistributed to ``spec`` on the active mesh; ``x`` itself
    without a mesh or when ``x`` is not a DTensor."""
    mesh = active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, fit_placements(spec_placements(mesh, spec),
                                               x.shape))


def unshard_dim(x, dim: int):
    """A DTensor split on ``dim`` gathered on it (its other placements
    kept); anything else as it is."""
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim
            for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim
        else p for p in x.placements])


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a region's
    input gradient becomes a DTensor again, whose metadata says
    contiguous, and DTensor's later views run on the local strides."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _GradInLayout(torch.autograd.Function):
    """Identity whose backward redistributes the gradient to the forward
    value's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_in_layout(x):
    """``x``, whose gradient arrives in ``x``'s own placements when ``x``
    is a DTensor on a mesh of three or more dims: there DTensor has no
    rule for a product's weight gradient over a token dim split by
    ``_StridedShard`` (the (pod, data, model) mesh); on fewer dims it
    has, and the gradient keeps the cheaper layout autograd gives it.
    Anything else as it is."""
    if isinstance(x, DTensor) and x.device_mesh.ndim >= 3:
        return _GradInLayout.apply(x)
    return x


def run_local(fn, mesh, args, in_placements, out_placements):
    """``fn`` on this rank's shards of ``args`` (each DTensor redistributed
    to its ``in_placements``, a plain tensor -- the same on every rank --
    split by them), its outputs DTensors in ``out_placements``: a region
    run on local tensors, for ops DTensor has no rule for.  The region
    splits work along each mesh dim on which some input is ``Shard``;
    there an input held whole (``Replicate``) gets its gradient back as
    ``Partial`` (each rank's share), elsewhere as it was placed."""
    from torch.distributed.tensor import Partial, distribute_tensor
    split = [any(isinstance(pl[i], Shard) for pl in in_placements)
             for i in range(mesh.ndim)]
    local = []
    for a, pl in zip(args, in_placements):
        if isinstance(a, DTensor):
            grad = [p if isinstance(p, Shard)
                    else (Partial() if split[i] else Replicate())
                    for i, p in enumerate(pl)]
            local.append(_ContiguousGrad.apply(a.redistribute(
                mesh, pl).to_local(grad_placements=grad)))
        else:
            local.append(distribute_tensor(a, mesh, pl,
                                           src_data_rank=None).to_local())
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    res = tuple(DTensor.from_local(o.contiguous(), mesh, pl,
                                   run_check=False)
                for o, pl in zip(outs, out_placements))
    return res if isinstance(out, tuple) else res[0]


def local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    """A rank's shard shape of a tensor of ``shape`` in ``placements`` on
    ``mesh``, each split dividing its dim, as every rule does (computed
    here, as DTensor's own helper makes a tensor on the mesh's device)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            d = p.dim % len(shape)
            if out[d] % mesh.size(i):
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split over {placements}")
            out[d] //= mesh.size(i)
    return tuple(out)


def local_rows(x, dim: int) -> Tuple[int, int]:
    """The global index range ``[start, stop)`` of ``x``'s dim ``dim``
    that this rank holds (``x`` a DTensor split on ``dim`` over mesh dims
    in mesh order, major first, each dividing it, as every rule does; the
    whole dim where it is not split)."""
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    idx, parts = 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim:
            idx, parts = idx * mesh.size(i) + coord[i], parts * mesh.size(i)
    n = x.shape[dim]
    if n % parts:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is split {parts} "
                         f"ways unevenly")
    return idx * (n // parts), (idx + 1) * (n // parts)


def write_local(dst, src) -> None:
    """``dst.copy_(src)``; on DTensors ``src`` first redistributed to
    ``dst``'s placements, so each rank writes its own shard in place."""
    dst.copy_(like_layout(src, dst) if isinstance(dst, DTensor) else src)


def like_layout(y, x):
    """``y`` in ``x``'s placements when both are DTensors (the residual
    add's two operands in one layout, so that the add's backward hands
    each branch a gradient it can reshape: a (B, S, d) gradient split on
    S cannot be flattened by DTensor); anything else as it is."""
    if not (isinstance(y, DTensor) and isinstance(x, DTensor)) or \
            tuple(y.placements) == tuple(x.placements):
        return y
    return y.redistribute(x.device_mesh, x.placements)


def head_plan(x, batch_dim: int, heads: Tuple[int, ...]):
    """How a head-parallel region splits each dim of ``x``'s mesh:
    ``"batch"`` where ``x`` is split on ``batch_dim``, ``"heads"`` on the
    "model" axis when it divides every count in ``heads``, else None
    (held whole).  The reference's ``constrain_heads`` layout."""
    mesh = x.device_mesh
    plan = []
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == batch_dim:
            plan.append("batch")
        elif mesh.mesh_dim_names[i] == MODEL_AXIS and all(
                h % mesh.size(i) == 0 for h in heads):
            plan.append("heads")
        else:
            plan.append(None)
    return plan


def plan_placements(plan, batch_dim=None, head_dim=None) -> tuple:
    """A tensor's placements in a ``head_plan``: ``Shard(batch_dim)``
    where the plan splits the batch, ``Shard(head_dim)`` where it splits
    heads, ``Replicate()`` elsewhere and for a dim the tensor lacks
    (None)."""
    out = []
    for kind in plan:
        dim = {"batch": batch_dim, "heads": head_dim}.get(kind)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def _model_spec(x, model_dim: int, dp_dim: int) -> Optional[PartitionSpec]:
    """``model_dim`` over "model" and ``dp_dim`` over the dp axes (when
    they divide it), or None when there is no mesh with a "model" axis or
    it does not divide ``model_dim``."""
    mesh = active_mesh()
    if mesh is None:
        return None
    shape = mesh_shape(mesh)
    if MODEL_AXIS not in shape or x.shape[model_dim] % shape[MODEL_AXIS]:
        return None
    dp = _dp(shape)
    spec = [None] * x.ndim
    spec[model_dim] = MODEL_AXIS
    if dp and x.shape[dp_dim] % math.prod(shape[a] for a in dp) == 0:
        spec[dp_dim] = dp if len(dp) > 1 else dp[0]
    return PartitionSpec(*spec)


def constrain_expert_parallel(xe: torch.Tensor, expert_dim: int = 0,
                              group_dim: int = 1) -> torch.Tensor:
    """(E', G, C, d) activations: experts over "model", groups over dp —
    keeps the expert FFN products comm-free and all-gathers the (small)
    FSDP weight shards instead of the (huge) token tensors.  Without a
    mesh, ``xe`` itself."""
    spec = _model_spec(xe, expert_dim, group_dim)
    return xe if spec is None else constrain(xe, spec)


def constrain_heads(x: torch.Tensor, head_dim: int,
                    batch_dim: int = 0) -> torch.Tensor:
    """(..., H, ...) Mamba/attention head-parallel activations: heads over
    "model", batch over dp.  Without a mesh, ``x`` itself."""
    spec = _model_spec(x, head_dim, batch_dim)
    return x if spec is None else constrain(x, spec)
