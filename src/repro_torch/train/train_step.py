"""The train step: loss -> grads -> clip -> AdamW, with ISLA telemetry and
optional microbatch gradient accumulation (``repro.train.train_step`` in
torch).

Gradients come from autograd through ``models.model.train_loss``.  The
step is functional, as the reference's: it returns new params and a new
optimizer state and leaves its inputs as they were.  Every metric is a
device scalar; nothing reads a value back to the host.  The telemetry
(``telemetry_mode="isla"``, the default) estimates the mean per-token
loss with ``core.metrics.loss_stats``, whose Phase 1 is one hand-written
``isla_fold`` launch a step on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..core.distributed import exact_mean
from ..core.metrics import loss_stats, loss_stats_trimmed_exact
from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..core.types import IslaParams
from ..models import model
from .optimizer import OptimizerConfig, OptState, adamw_update

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1            # gradient accumulation steps
    isla_telemetry: bool = True
    isla_rate: float = 0.02
    telemetry_exact: bool = False    # also compute the exact mean (validation)
    telemetry_mode: str = "isla"     # isla | off | exact | trimmed_exact


def _split_microbatches(batch, n: int):
    def sp(x):
        return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    return tree_map(sp, batch)


def _value_and_grad(cfg: ArchConfig, params, batch, constraint
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, aux, grads): the grads in each param's dtype, the loss and
    aux detached."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = model.train_loss(cfg, tree_unflatten(params, leaves),
                                     batch, constraint=constraint)
        grads = torch.autograd.grad(loss, leaves)
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, tree_unflatten(params, list(grads))


def train_step(cfg: ArchConfig, tcfg: TrainConfig, params,
               opt_state: OptState, batch, constraint=None
               ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step.  ``constraint`` is the activation sharding
    constraint (None on one device)."""
    if tcfg.microbatches > 1:
        n = tcfg.microbatches
        mb = _split_microbatches(batch, n)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                               device=p.device), params)
        loss_sum, per_tok = 0.0, []
        for i in range(n):
            loss, aux, g = _value_and_grad(
                cfg, params, tree_map(lambda x: x[i], mb), constraint)
            grads = tree_map(lambda a, x: a + x.to(F32), grads, g)
            loss_sum = loss_sum + loss
            per_tok.append(aux["per_token_loss"])
        grads = tree_map(lambda g: g / n, grads)
        loss = loss_sum / n
        per_token = torch.stack(per_tok)
        aux = {"per_token_loss": per_token.reshape(
            (-1,) + tuple(per_token.shape[2:]))}
    else:
        loss, aux, grads = _value_and_grad(cfg, params, batch, constraint)

    new_params, new_opt, metrics = adamw_update(
        tcfg.opt, params, grads, opt_state)
    metrics["loss"] = loss
    if cfg.moe is not None and "moe_lb_loss" in aux:
        metrics["moe_lb_loss"] = aux["moe_lb_loss"]

    mode = tcfg.telemetry_mode if tcfg.isla_telemetry else "off"
    per_token = aux["per_token_loss"]
    if mode == "isla":
        # O(1)-communication estimate of the global mean per-token loss;
        # no generator: the subsample is strided, as the reference's
        # key=None.
        metrics.update(loss_stats(
            per_token, params=IslaParams(e=0.01), rate=tcfg.isla_rate,
            include_exact=tcfg.telemetry_exact))
    elif mode == "exact":
        metrics["loss_mean_exact"] = exact_mean(per_token)
    elif mode == "trimmed_exact":
        metrics.update(loss_stats_trimmed_exact(per_token))
    return new_params, new_opt, metrics
