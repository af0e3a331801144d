"""Training/serving telemetry built on distributed ISLA.

Per-token losses, gradient magnitudes and router probabilities are large
(and, across a mesh, sharded) tensors whose exact mean needs a full
reduction.  ISLA gives a precision-assured estimate while touching only
``rate`` of the elements and summing O(1) floats across shards
(``distributed.isla_mean``).

The gradient-magnitude monitor treats |g| as the aggregated value — its
heavy-tailed distribution is exactly the regime the paper's TL-region
handling (structural outlier exclusion) was designed for.

Where the reference takes ``axis_names`` (the mesh axes of a
``shard_map``), these take ``mesh`` (a ``launch.mesh.CellMesh``), and the
tensor argument is then a sequence with one tensor (one tree for
``grad_abs_stats``) a shard, on that shard's device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .distributed import exact_mean, isla_mean
from .tree import tree_leaves
from .types import IslaParams

DEFAULT_PARAMS = IslaParams(e=0.01, te=3.0)


def loss_stats(per_token_loss, mesh=None,
               params: Optional[IslaParams] = None, rate: float = 0.05,
               generator=None, include_exact: bool = False
               ) -> Dict[str, torch.Tensor]:
    """ISLA estimate of the global mean per-token loss (+ optional exact
    reference for validation runs)."""
    p = params or DEFAULT_PARAMS
    # per-token loss distributions are right-skewed; use the pilot-measured
    # geometry (ISLA-E) — still O(1) cross-shard payload.
    out = {"loss_mean_isla": isla_mean(per_token_loss, p, mesh=mesh,
                                       rate=rate, generator=generator,
                                       mode="empirical")}
    if include_exact:
        out["loss_mean_exact"] = exact_mean(per_token_loss, mesh)
    return out


def _quantile_points(n: int, q: float):
    """``jnp.quantile``'s ``linear`` rule for ``n`` sorted elements, in
    its fp32 arithmetic: the two indices and their weights."""
    f32 = np.float32
    pos = f32(q) * (f32(n) - f32(1))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = pos - low
    top = f32(n) - f32(1)
    return (int(min(max(low, 0), top)), int(min(max(high, 0), top)),
            float(f32(1) - w_high), float(w_high))


def _quantile(sorted_flat: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of a sorted flat fp32 tensor, bit for bit as
    ``jnp.quantile`` gives it: XLA fuses the interpolation into one
    multiply-add, ``high * w_high + (low * w_low)`` rounded once, which
    the float64 sum of the exact product reproduces."""
    low, high, w_low, w_high = _quantile_points(sorted_flat.shape[0], q)
    part = (sorted_flat[low] * w_low).double()
    return (sorted_flat[high].double() * w_high + part).float()


def loss_stats_trimmed_exact(per_token_loss: torch.Tensor,
                             lo_q: float = 0.023, hi_q: float = 0.977
                             ) -> Dict[str, torch.Tensor]:
    """The exact robust competitor to ISLA: a trimmed mean that excludes the
    same ~2.3% tails the TS/TL regions drop.  Needs a global sort — under
    sharding the full tensor would be gathered, against ISLA's O(1) floats.

    The quantiles come from one ``torch.sort`` of the flat fp32 tensor by
    ``jnp.quantile``'s default linear rule (``torch.quantile`` refuses
    inputs over 2^24 elements)."""
    flat = per_token_loss.to(torch.float32).reshape(-1)
    s = torch.sort(flat).values
    lo, hi = _quantile(s, lo_q), _quantile(s, hi_q)
    mask = ((flat >= lo) & (flat <= hi)).to(torch.float32)
    return {"loss_mean_trimmed": (flat * mask).sum()
            / mask.sum().clamp_min(1.0)}


def _grad_sample(grads, max_leaves: int) -> torch.Tensor:
    leaves = [l for l in tree_leaves(grads)
              if isinstance(l, torch.Tensor) and l.numel() > 0]
    leaves.sort(key=lambda l: l.numel(), reverse=True)   # stable on ties
    return torch.cat([l.reshape(-1)[:max(1, l.numel() // 16)].abs()
                      for l in leaves[:max_leaves]])


def grad_abs_stats(grads, mesh=None, params: Optional[IslaParams] = None,
                   rate: float = 0.01, max_leaves: int = 8
                   ) -> Dict[str, torch.Tensor]:
    """Approximate mean |g| over the largest gradient leaves.

    Uses merged semantics (leaves form one logical population).  Leaves are
    sliced before the absolute value and the concatenation, so the cost is
    rate-bounded.  With a mesh, ``grads`` is a sequence with a tree a
    shard."""
    p = params or DEFAULT_PARAMS
    if mesh is not None and not isinstance(grads, (list, tuple)):
        raise ValueError("with a mesh, grads is a sequence with a tree a "
                         "shard")
    flat = (_grad_sample(grads, max_leaves) if mesh is None
            else [_grad_sample(g, max_leaves) for g in grads])
    return {"grad_absmean_isla": isla_mean(flat, p, mesh=mesh, rate=rate,
                                           semantics="merged")}


def router_load_stats(router_probs, mesh=None,
                      params: Optional[IslaParams] = None,
                      rate: float = 0.05) -> Dict[str, torch.Tensor]:
    """MoE router health: approximate mean top-1 prob across the batch."""
    p = params or DEFAULT_PARAMS
    top1 = (router_probs.amax(-1)
            if mesh is None or isinstance(router_probs, torch.Tensor)
            else [r.amax(-1) for r in router_probs])
    return {"router_top1_isla": isla_mean(top1, p, mesh=mesh, rate=rate)}
