"""The train step: loss -> grads -> clip -> AdamW, with ISLA telemetry and
optional microbatch gradient accumulation (``repro.train.train_step`` in
torch), on one device or sharded over a ``DeviceMesh``
(``make_jit_train_step``).

Gradients come from autograd through ``models.model.train_loss``.  The
step is functional, as the reference's: it returns new params and a new
optimizer state and leaves its inputs as they were.  Every metric is a
device scalar; nothing reads a value back to the host.  The telemetry
(``telemetry_mode="isla"``, the default) estimates the mean per-token
loss with ``core.metrics.loss_stats``, whose Phase 1 is one hand-written
``isla_fold`` launch a step on the card.

The sharded step (the reference's GSPMD ``jit`` with in/out shardings)
runs the same function on DTensors: params, optimizer state and each
microbatch are placed by their ``sharding.specs`` placements, DTensor
propagates them through the model (TP over "model", the batch over the
dp axes), the gradients are reduce-scattered onto the optimizer state's
placements (ZeRO), AdamW runs on those shards, and the new params are
gathered back onto theirs.  The telemetry gathers the (B, S) per-token
losses and runs the one-device ``loss_stats`` on every rank (one
``isla_fold`` launch a rank a step, on a plain tensor), so it estimates
the global mean as the meshless step does.  Eager, as the one-device
step: no ``torch.compile``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import ArchConfig
from ..core.distributed import exact_mean
from ..core.metrics import loss_stats, loss_stats_trimmed_exact
from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..core.types import IslaParams
from ..models import model
from ..sharding.context import use_mesh
from ..sharding.specs import batch_specs, shardings
from ..trace import span
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


class StepPlacements(NamedTuple):
    """Where a sharded step's trees live: ``params`` and ``opt`` are trees
    of ``MeshSharding`` (the optimizer state's an ``OptState``);
    ``batch`` one for each batch leaf, or None to place each microbatch
    by ``batch_specs``."""

    mesh: Any
    params: Any
    opt: Any
    batch: Any = None


def place(tree, sh_tree):
    """Each leaf of ``tree`` in the placements of the ``MeshSharding`` at
    its place in ``sh_tree`` (a DTensor redistributed, a whole tensor
    split without a collective)."""
    return tree_map(lambda x, s: s.place(x), tree, sh_tree)


def local_value(x):
    """A DTensor's whole value as a plain tensor (a collective: every rank
    of its mesh calls it); anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


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
               opt_state: OptState, batch, constraint=None,
               placements: "StepPlacements | None" = None
               ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step.  ``constraint`` is the activation sharding
    constraint (None on one device).  ``placements`` (the sharded step:
    DTensor params and optimizer state in them, a whole batch on every
    rank) places each microbatch, runs AdamW on the optimizer state's
    shards and gives the new params back in theirs.  Records the spans
    ``train_step`` > ``forward_backward`` (a microbatch), ``adamw`` (clip
    included) and ``telemetry``, the three timed on the card too
    (``trace.span``)."""
    with span("train_step"):
        return _train_step(cfg, tcfg, params, opt_state, batch, constraint,
                           placements)


def _train_step(cfg, tcfg, params, opt_state, batch, constraint,
                placements):
    n = tcfg.microbatches
    dev = params["embedding"]       # the card the phases are timed on
    if placements is None:
        def batch_in(b):
            return b
    else:
        def batch_in(b):
            sh = placements.batch
            if sh is None:
                sh = shardings(placements.mesh,
                               batch_specs(cfg, placements.mesh, b))
            return place(b, sh)

    if n > 1:
        mb = _split_microbatches(batch, n)
        # the params' placements: the accumulation runs on DTensor params
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
        loss_sum, per_tok = 0.0, []
        for i in range(n):
            with span("forward_backward", device=dev, microbatch=i):
                loss, aux, g = _value_and_grad(
                    cfg, params, batch_in(tree_map(lambda x: x[i], mb)),
                    constraint)
            grads = tree_map(lambda a, x: a + x.to(F32), grads, g)
            loss_sum = loss_sum + loss
            per_tok.append(local_value(aux["per_token_loss"]))
        grads = tree_map(lambda g: g / n, grads)
        loss = loss_sum / n
        per_token = torch.stack(per_tok)
        aux = {"per_token_loss": per_token.reshape(
            (-1,) + tuple(per_token.shape[2:]))}
    else:
        with span("forward_backward", device=dev, microbatch=0):
            loss, aux, grads = _value_and_grad(cfg, params, batch_in(batch),
                                               constraint)

    if placements is not None:
        # ZeRO: gradients reduce-scattered and params split onto the
        # moments' shards; the update runs there
        grads = place(grads, placements.opt.m)
        with span("adamw", device=dev):
            new_params, new_opt, metrics = adamw_update(
                tcfg.opt, place(params, placements.opt.m), grads, opt_state)
        new_params = place(new_params, placements.params)
        metrics = {k: local_value(v) for k, v in metrics.items()}
        aux = {k: local_value(v) for k, v in aux.items()}
        loss = local_value(loss)
    else:
        with span("adamw", device=dev):
            new_params, new_opt, metrics = adamw_update(
                tcfg.opt, params, grads, opt_state)
    metrics["loss"] = loss
    if cfg.moe is not None and "moe_lb_loss" in aux:
        metrics["moe_lb_loss"] = aux["moe_lb_loss"]

    mode = tcfg.telemetry_mode if tcfg.isla_telemetry else "off"
    per_token = aux["per_token_loss"]
    with span("telemetry", device=dev, mode=mode):
        if mode == "isla":
            # O(1)-communication estimate of the global mean per-token
            # loss; no generator: the subsample is strided, as the
            # reference's key=None.
            metrics.update(loss_stats(
                per_token, params=IslaParams(e=0.01), rate=tcfg.isla_rate,
                include_exact=tcfg.telemetry_exact))
        elif mode == "exact":
            metrics["loss_mean_exact"] = exact_mean(per_token)
        elif mode == "trimmed_exact":
            metrics.update(loss_stats_trimmed_exact(per_token))
    return new_params, new_opt, metrics


def make_jit_train_step(cfg: ArchConfig, tcfg: TrainConfig, mesh,
                        param_sh, opt_sh, batch_sh=None, constraint=None):
    """The sharded step (the reference's ``jit`` with explicit in/out
    shardings): ``step(params, opt_state, batch)`` takes params and
    optimizer state (DTensors, or whole tensors on every rank) and places
    them by ``param_sh`` / ``opt_sh`` (trees of ``MeshSharding``), places
    the batch (whole on every rank) by ``batch_sh`` (None: each
    microbatch by ``batch_specs``), and returns the new params and
    moments as DTensors in those placements, the metrics as plain
    tensors.  The old trees are dropped, not updated in place; every
    rank of ``mesh`` calls it."""
    plc = StepPlacements(mesh, param_sh, opt_sh, batch_sh)

    def step(params, opt_state, batch):
        with use_mesh(mesh), implicit_replication():
            return train_step(cfg, tcfg, place(params, param_sh),
                              place(opt_state, opt_sh), batch,
                              constraint=constraint, placements=plc)

    return step
