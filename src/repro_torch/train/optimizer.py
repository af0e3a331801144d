"""AdamW with global-norm clipping and a warmup + cosine schedule
(``repro.train.optimizer`` in torch).

Functional, as the reference's: ``adamw_update`` takes params, grads and
an ``OptState`` and returns new ones; nothing is updated in place.  The
moments are fp32 and the update is computed in fp32 and cast to the param
dtype.  The clip casts the grads back to their own dtype (bf16 grads are
rounded twice, as in the reference).  ``step`` is an int32 device scalar
and every metric stays on the device: nothing reads a value back to the
host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core.tree import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def init_opt_state(params) -> OptState:
    """Zero fp32 moments beside each param, ``step`` 0 (int32) on the
    params' device."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                           device=p.device), params)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zeros, v=tree_map(torch.clone, zeros))


def abstract_opt_state(abstract_params) -> OptState:
    """The optimizer state's shapes and dtypes as ``meta`` tensors."""
    def meta(p):
        return torch.empty(p.shape, dtype=F32, device="meta")

    return OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                    m=tree_map(meta, abstract_params),
                    v=tree_map(meta, abstract_params))


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(l.to(F32))) for l in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled to at most ``max_norm``, each leaf in its own
    dtype; the norm)."""
    norm = global_norm(tree)
    # a device divide (a host scalar over a tensor is taken as a
    # reciprocal times the scalar)
    limit = torch.full((), max_norm, dtype=F32, device=norm.device)
    scale = torch.clamp(limit / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), tree), norm


def adamw_update(cfg: OptimizerConfig, params, grads, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(F32)
    bc2 = 1.0 - b2 ** step.to(F32)

    def upd(p, g, m, v):
        g = g.to(F32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.to(F32)
        p_new = p.to(F32) - lr * delta
        return p_new.to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(step=step, m=new_m, v=new_v), metrics
