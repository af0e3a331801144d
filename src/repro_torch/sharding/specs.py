"""Partitioning rules: param/cache/batch trees -> spec trees, and the
placements of the ISLA mesh (``repro.sharding.specs`` in torch).

Strategy (the reference's):
 * TP over "model": vocab (embed/lm_head), attention flat feature dims, MLP
   hidden, MoE experts (or expert-ff when n_experts isn't divisible), mamba
   projections.
 * FSDP over ("pod","data") for >= FSDP_THRESHOLD-param archs: weights are
   additionally sharded on the first remaining divisible dim; the step
   all-gathers them at use and reduce-scatters their gradients.
 * Optimizer state is ALWAYS FSDP-sharded (ZeRO) regardless of param FSDP.
 * Small archs (< TP_THRESHOLD) replicate everything (pure DP).

A spec (``PartitionSpec``) is a tuple with one entry a tensor dim: None,
a mesh axis name, or a tuple of names.  Every rule reads only a mesh's
axis names and sizes (``mesh_shape``), so a ``DeviceMesh`` and the
device-free ``launch.mesh.AbstractMesh`` give the same answer; every rule
is divisibility-checked, falling back to the next candidate (ultimately
replicated).  ``shardings`` turns specs into DTensor placements on a
mesh.

The ISLA mesh (``route="mesh"``) has its own table: the reference's
``isla_cell_specs`` gives a ``PartitionSpec`` for each operand family of
``MeshDeviceStack``; here a ``Placement`` says whether the operand is
split on dim 0 by shard or held whole by every shard, and
``distributed.mesh_h2d`` places host arrays by it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

from ..configs.base import ArchConfig

TP_THRESHOLD = 1_000_000_000      # < 1B params: replicate (pure DP)
FSDP_THRESHOLD = 8_000_000_000    # >= 8B params: FSDP the weights too
FSDP_MIN_ELEMENTS = 1 << 20       # smaller leaves are never FSDP-sharded

MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """One entry a tensor dim: None (whole), an axis name, or a tuple of
    names (the dim split over their product, the first axis major), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, an ``AbstractMesh`` or a
    ``CellMesh``, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # torch DeviceMesh
        return dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    shape = getattr(mesh, "shape", None)
    if shape is None:                           # CellMesh: one axis
        return {mesh.axis_names[0]: len(mesh.devices)}
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.axis_names, shape))


def mesh_axis_size(mesh, name) -> int:
    shape = mesh_shape(mesh)
    if isinstance(name, tuple):
        return int(math.prod(shape[n] for n in name))
    return int(shape[name])


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: ("pod","data") when pod exists."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _fits(dim: int, mesh, axes) -> bool:
    return dim % mesh_axis_size(mesh, axes) == 0


def _first_fit(shape, used_dims, mesh, axes) -> Optional[int]:
    """First dim (skipping used) divisible by the axis product; prefers the
    largest dim for better balance."""
    order = sorted((i for i in range(len(shape)) if i not in used_dims),
                   key=lambda i: -shape[i])
    for i in order:
        if shape[i] > 1 and _fits(shape[i], mesh, axes):
            return i
    return None


def _leaf_name(path) -> str:
    """``"blocks/0/attn/wq"``: the dict keys and sequence indices of a
    leaf's path (a NamedTuple's field names are left out, as the
    reference's ``GetAttrKey`` has neither ``key`` nor ``idx``)."""
    return "/".join(str(p) for p in path if p is not None)


def _map_named(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples (a ``PartitionSpec`` is a leaf), in its structure.
    ``path`` holds each dict key and sequence index, and None for a
    NamedTuple's field."""
    if isinstance(tree, PartitionSpec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, v, path + (None,))
                            for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _param_spec(cfg: ArchConfig, mesh, name: str, shape,
                fsdp: bool) -> PartitionSpec:
    """Rule table keyed on the leaf name suffix."""
    axes_of = mesh_shape(mesh)
    tp_on = cfg.n_params() >= TP_THRESHOLD and MODEL_AXIS in axes_of
    spec = [None] * len(shape)
    used: set = set()

    leaf = name.split("/")[-1]

    def put(dim, axes):
        spec[dim] = axes
        used.add(dim)

    if tp_on:
        if leaf in ("embedding", "lm_head"):
            if _fits(shape[0], mesh, MODEL_AXIS):
                put(0, MODEL_AXIS)
        elif leaf in ("wq", "wk", "wv", "w_gate", "w_up", "w_in",
                      "wz", "wx", "wdt"):
            d = len(shape) - 1
            if _fits(shape[d], mesh, MODEL_AXIS):
                put(d, MODEL_AXIS)
        elif leaf in ("wo", "w_down", "w_out", "out_proj"):
            d = len(shape) - 2
            if d >= 0 and _fits(shape[d], mesh, MODEL_AXIS):
                put(d, MODEL_AXIS)
        elif leaf in ("bq", "bk", "bv"):
            d = len(shape) - 1
            if _fits(shape[d], mesh, MODEL_AXIS):
                put(d, MODEL_AXIS)
        elif leaf in ("conv_x_w", "conv_x_b"):
            # the x-stream conv shards with the heads; B/C convs replicate
            d = len(shape) - 1
            if _fits(shape[d], mesh, MODEL_AXIS):
                put(d, MODEL_AXIS)
        elif leaf == "router":
            d = len(shape) - 1
            if _fits(shape[d], mesh, MODEL_AXIS):
                put(d, MODEL_AXIS)
        # norms / A_log / D / dt_bias / norm_scale: replicated

    # MoE expert stacks: prefer sharding the expert dim over "model"
    if tp_on and leaf in ("w_gate", "w_up", "w_down", "w_in", "w_out") \
            and len(shape) == 4:
        # (G, E, d, f) or (G, E, f, d)
        spec = [None] * len(shape)
        used = set()
        if _fits(shape[1], mesh, MODEL_AXIS):
            put(1, MODEL_AXIS)
        else:  # expert-internal TP (e.g. grok E=8): shard the ff dim
            d = len(shape) - 1 if leaf in ("w_gate", "w_up", "w_in") \
                else len(shape) - 2
            if _fits(shape[d], mesh, MODEL_AXIS):
                put(d, MODEL_AXIS)

    if fsdp and math.prod(shape) >= FSDP_MIN_ELEMENTS:
        for axes in (dp_axes(mesh), ("data",)):
            if not all(a in axes_of for a in axes):
                continue
            dim = _first_fit(shape, used, mesh, axes)
            if dim is not None:
                put(dim, axes if len(axes) > 1 else axes[0])
                break

    return PartitionSpec(*spec)


def param_specs(cfg: ArchConfig, mesh, params_tree,
                fsdp: Optional[bool] = None):
    """Spec tree matching ``params_tree`` (tensors, ``meta`` ones
    included)."""
    if fsdp is None:
        fsdp = cfg.n_params() >= FSDP_THRESHOLD

    def rule(path, leaf):
        return _param_spec(cfg, mesh, _leaf_name(path), tuple(leaf.shape),
                           fsdp)

    return _map_named(rule, params_tree)


def opt_state_specs(cfg: ArchConfig, mesh, params_tree):
    """ZeRO: optimizer moments always FSDP-sharded."""
    return param_specs(cfg, mesh, params_tree, fsdp=True)


def batch_specs(cfg: ArchConfig, mesh, batch_tree):
    """Shard the batch dim as widely as divisibility allows.

    TP archs keep "model" for tensor parallelism; DP-only archs (< 1B) fold
    "model" into the batch axes so no mesh dimension idles.
    """
    axes_of = mesh_shape(mesh)
    dp = dp_axes(mesh)
    tp_on = cfg.n_params() >= TP_THRESHOLD and MODEL_AXIS in axes_of
    candidates = []
    if not tp_on and MODEL_AXIS in axes_of:
        candidates.append(dp + (MODEL_AXIS,))
        candidates.append(("data", MODEL_AXIS))
    candidates.extend([dp, ("data",)])

    def rule(path, leaf):
        ndim = len(leaf.shape)
        b = leaf.shape[0] if ndim >= 1 else 0
        for axes in candidates:
            if not all(a in axes_of for a in axes):
                continue
            if b and b % mesh_axis_size(mesh, axes) == 0:
                ax = axes if len(axes) > 1 else axes[0]
                return PartitionSpec(ax, *([None] * (ndim - 1)))
        return PartitionSpec(*([None] * ndim))

    return _map_named(rule, batch_tree)


def cache_specs(cfg: ArchConfig, mesh, cache_tree):
    """KV cache: batch over dp if divisible; otherwise shard the sequence
    (attention) / heads (mamba) over everything available.

    Layouts: k/v (G, B, S, KV, hd); h (G, B, H, N, P); conv (G, B, K-1, C).
    """
    axes_of = mesh_shape(mesh)
    dp = dp_axes(mesh)
    dp_size = mesh_axis_size(mesh, dp)
    tp_on = MODEL_AXIS in axes_of

    def rule(path, leaf):
        name = _leaf_name(path).split("/")[-1]
        spec = [None] * len(leaf.shape)
        B = leaf.shape[1]
        batch_sharded = B % dp_size == 0
        if batch_sharded:
            spec[1] = dp if len(dp) > 1 else dp[0]
        if name in ("k", "v"):
            S = leaf.shape[2]
            if batch_sharded:
                if tp_on and S % axes_of[MODEL_AXIS] == 0:
                    spec[2] = MODEL_AXIS
            else:
                axes = (dp + (MODEL_AXIS,)) if tp_on else dp
                if S % mesh_axis_size(mesh, axes) == 0:
                    spec[2] = axes
        elif name == "h":
            H = leaf.shape[2]
            if tp_on and H % axes_of[MODEL_AXIS] == 0:
                spec[2] = MODEL_AXIS
        elif name == "conv":
            C = leaf.shape[3]
            if tp_on and C % axes_of[MODEL_AXIS] == 0:
                spec[3] = MODEL_AXIS
        return PartitionSpec(*spec)

    return _map_named(rule, cache_tree)


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A spec on a mesh, as DTensor placements: one ``Shard(d)`` or
    ``Replicate()`` a mesh dim (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec
    placements: tuple

    def place(self, t):
        """``t`` as a DTensor in these placements: a DTensor
        redistributed; a plain tensor, the same whole value on every rank,
        split without a collective (each rank keeps its own shard)."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        placements = fit_placements(self.placements, t.shape)
        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, placements)
        return distribute_tensor(t, self.mesh, placements,
                                 src_data_rank=None)


def spec_placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where that axis names tensor dim ``d``, ``Replicate()``
    elsewhere.  A dim split over several axes is split over them in
    mesh order, major first (the reference's order), so the axes of an
    entry must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_shape(mesh))
    out = [Replicate() for _ in order]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {names} out of the mesh's "
                             f"order {tuple(order)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def fit_placements(placements, shape) -> tuple:
    """``placements`` for a tensor of ``shape``: a ``Shard`` of a dim of
    size 1 (only ever over a mesh dim of size 1, as every rule divides)
    as ``Replicate()``, the same layout, since DTensor cannot view or
    flatten a sharded singleton dim (a batch of one)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Replicate() if isinstance(p, Shard) and shape[p.dim] == 1
                 else p for p in placements)


def shardings(mesh, spec_tree):
    """Each spec of ``spec_tree`` as a ``MeshSharding`` on ``mesh``."""
    return _map_named(lambda _, s: MeshSharding(
        mesh, s, spec_placements(mesh, s)), spec_tree)


def activation_constraint(cfg: ArchConfig, mesh):
    """Between-block residual-stream constraint used in the train path:
    shard sequence over "model" (Megatron-SP style) so the remat-saved
    carries are 1/tp of the naive size.  On a ``DeviceMesh`` it
    redistributes a (B, S, d) DTensor to ``(dp, "model", None)``."""
    axes_of = mesh_shape(mesh)
    if not cfg.seq_shard_activations or MODEL_AXIS not in axes_of:
        return None
    dp = dp_axes(mesh)
    ax = dp if len(dp) > 1 else dp[0]
    placements = spec_placements(mesh, PartitionSpec(ax, MODEL_AXIS, None))

    def constrain(x):
        if x.ndim != 3 or x.shape[1] % axes_of[MODEL_AXIS] != 0:
            return x
        return x.redistribute(mesh, fit_placements(placements, x.shape))

    return constrain


# -- ISLA cell-axis placements (route="mesh") -------------------------------

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
