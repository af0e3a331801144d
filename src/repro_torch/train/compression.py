"""Gradient compression for explicit data parallelism
(``repro.train.compression`` in torch).

int8 uniform quantization with error feedback (EF-SGD style): the
quantization residual is carried to the next step, so compression error
does not accumulate as bias.  The cross-shard sum runs over
int32-accumulated int8 payloads.

Where the reference takes ``axis_name`` (the data axis of a
``shard_map``), these take ``mesh`` (a ``launch.mesh.CellMesh``): with
one, ``grads`` and ``error_feedback`` are lists with one tree a shard, on
that shard's device, every cross-shard step is one
``distributed.mesh_all_reduce`` (counted), and the results are lists with
a tree a shard.  With ``mesh=None`` a call is the reference's
one-device ``shard_map``: the cross-shard sum is the identity.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.distributed import _div, _psum
from ..core.tree import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (q, scale)."""
    xf = x.to(F32)
    scale = _div(torch.clamp(xf.abs().max(), min=1e-12), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_tree(grads, error_feedback):
    """Quantize grads + EF; returns (payload tree of (q, scale), new EF)."""
    def one(g, ef):
        target = g.to(F32) + ef
        q, s = quantize_int8(target)
        return (q, s), target - dequantize_int8(q, s)

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                       tree_leaves(error_feedback))]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            tree_unflatten(grads, [p[1] for p in pairs]))


def _is_pair(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], torch.Tensor))


def _shards(x, mesh) -> list:
    return [x] if mesh is None else list(x)


def _unshard(xs: list, mesh):
    return xs[0] if mesh is None else xs


def psum_compressed(payload, mesh=None):
    """All-reduce int8 payloads (accumulated in int32) and their fp32
    scales: the mean of the dequantized values as (sum q) * (mean scale)
    / shards (per-tensor scales are near-identical across data-parallel
    replicas; the EF residual absorbs the approximation).  With a mesh,
    ``payload`` is a list with a payload tree a shard, and so is the
    result."""
    shards = _shards(payload, mesh)
    flat = [tree_leaves(p, is_leaf=_is_pair) for p in shards]
    means = [[] for _ in shards]
    for i in range(len(flat[0])):
        pairs = [f[i] for f in flat]
        acc = _psum([q.to(torch.int32) for q, _ in pairs], mesh)
        n = _psum([torch.ones((), dtype=F32, device=q.device)
                   for q, _ in pairs], mesh)
        s_sum = _psum([s for _, s in pairs], mesh)
        for k, m in enumerate(means):
            m.append(acc[k].to(F32) * (s_sum[k] / n[k]) / n[k])
    return _unshard([tree_unflatten(p, m, is_leaf=_is_pair)
                     for p, m in zip(shards, means)], mesh)


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def dp_allreduce_grads(grads, error_feedback, mesh=None,
                       compress: bool = True):
    """Data-parallel gradient mean with optional int8 + EF compression.
    Returns (mean grads, new EF); with a mesh each a list with a tree a
    shard."""
    shards = _shards(grads, mesh)
    if compress:
        pairs = [compress_tree(g, e) for g, e in
                 zip(shards, _shards(error_feedback, mesh))]
        return (psum_compressed(_unshard([p for p, _ in pairs], mesh), mesh),
                _unshard([e for _, e in pairs], mesh))
    flat = [tree_leaves(g) for g in shards]
    means = [[] for _ in shards]
    for i in range(len(flat[0])):
        total = _psum([f[i].to(F32) for f in flat], mesh)
        for k, t in enumerate(total):
            means[k].append(_div(t, float(len(shards))))
    return (_unshard([tree_unflatten(g, m) for g, m in zip(shards, means)],
                     mesh), error_feedback)
