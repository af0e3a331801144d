"""Public model API: init / abstract shapes / train loss / prefill /
decode / cache / abstract cache.

Batch contract (as in ``repro.models.model``):
  train:   {"tokens": (B, S_tok) integer, "labels": (B, S_tok) integer,
            optional "prefix_embeds": (B, F, d)} with F + S_tok = S
  prefill: {"tokens": (B, S_tok) integer, optional "prefix_embeds"}
  decode:  token (B, 1) integer, pos (B,) integer, plus the cache

Params are the reference's pytree as plain dicts of tensors:
``{"embedding", ["lm_head"], "blocks": [per period position, leaves
stacked over groups], "final_norm"}``; ``convert.params_from`` carries
the reference's own.  Loss = masked mean CE over the token positions
(+ the MoE aux terms); its per-token losses feed the ISLA telemetry
(``train.train_step``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import ArchConfig
from . import transformer
from .layers import (apply_norm, chunked_ce_loss, embed_tokens, init_embed,
                     init_norm, lm_logits)

Params = Dict[str, Any]

MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random params at the reference's init scales, drawn from ``gen`` on
    ``gen.device``."""
    return {
        **init_embed(cfg, gen),
        "blocks": transformer.init_stack(cfg, gen),
        "final_norm": init_norm(cfg, gen),
    }


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: ``init_params`` draws from
    it make shapes and dtypes only."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_params(cfg: ArchConfig) -> Params:
    """The param tree's shapes and dtypes as ``meta`` tensors (the
    reference's ``eval_shape`` of ``init_params``): nothing is
    allocated."""
    return init_params(cfg, _MetaGenerator())


def _assemble_inputs(cfg: ArchConfig, params: Params, batch
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Embed tokens (+ frontend prefix).  Returns (x, positions, loss_mask)
    over the FULL sequence; loss mask is 0 on prefix positions."""
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens)
    B, S_tok, _ = x.shape
    ones = torch.ones((B, S_tok), dtype=torch.float32, device=x.device)
    if cfg.frontend is not None:
        prefix = batch["prefix_embeds"].to(x.dtype)
        F = prefix.shape[1]
        x = torch.cat([prefix, x], dim=1)
        mask = torch.cat([torch.zeros((B, F), dtype=torch.float32,
                                      device=x.device), ones], dim=1)
    else:
        mask = ones
    S = x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions, mask


def train_loss(cfg: ArchConfig, params: Params, batch, constraint=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean CE loss + aux.  aux holds the per-token losses (B, S) over the
    full sequence (0 on prefix positions: ISLA telemetry reads them), the
    loss mask and, for MoE configs, the summed load-balance and z losses,
    which the loss adds at ``MOE_LB_COEF`` and ``MOE_Z_COEF``."""
    x, positions, mask = _assemble_inputs(cfg, params, batch)
    x, aux = transformer.forward_train(cfg, params, x, positions,
                                       constraint=constraint)
    x = transformer._seq_whole(apply_norm(cfg, params.get("final_norm", {}),
                                          x))
    # labels over the full sequence: prefix positions are masked anyway
    labels = batch["labels"]
    if cfg.frontend is not None:
        pad = torch.zeros((labels.shape[0], cfg.frontend_len),
                          dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    sum_loss, per_token = chunked_ce_loss(cfg, params, x, labels, mask)
    loss = sum_loss / mask.sum().clamp_min(1.0)
    if cfg.moe is not None:
        loss = loss + MOE_LB_COEF * aux.get("moe_lb_loss", 0.0) \
            + MOE_Z_COEF * aux.get("moe_z_loss", 0.0)
    aux = dict(aux)
    aux["per_token_loss"] = per_token
    aux["loss_mask"] = mask
    return loss, aux


def serve_prefill(cfg: ArchConfig, params: Params, batch, cache,
                  constraint=None):
    """Returns (last-position logits (B, 1, V), the cache with its first S
    rows, and each Mamba position's state and conv tail, written in
    place).  A config with a Mamba mixer takes the reference's prompt
    lengths only: at most the chunk or a multiple of it, and at least
    ``d_conv - 1`` tokens (else ``ValueError``).  ``constraint`` is the
    activation sharding constraint, applied before each period position
    (None on one device).

    Sharded (params, batch and cache DTensors in their ``sharding.specs``
    placements, under ``use_mesh``): the logits come back as a DTensor and
    each rank writes its own shard of the cache."""
    with implicit_replication():
        x, positions, _ = _assemble_inputs(cfg, params, batch)
        x, cache = transformer.forward_prefill(cfg, params, x, positions,
                                               cache, constraint=constraint)
        x = transformer._seq_whole(
            apply_norm(cfg, params.get("final_norm", {}), x))
        logits = lm_logits(cfg, params, x[:, -1:, :])
    return logits, cache


def serve_decode(cfg: ArchConfig, params: Params, token: torch.Tensor,
                 pos: torch.Tensor, cache):
    """One decode step: token (B, 1) -> logits (B, 1, V); the cache gets
    row ``pos`` (and each Mamba position its new state and conv tail) in
    place, sharded as ``serve_prefill``."""
    with implicit_replication():
        x = embed_tokens(cfg, params, token)
        x, cache = transformer.forward_decode(cfg, params, x, pos, cache)
        x = apply_norm(cfg, params.get("final_norm", {}), x)
        logits = lm_logits(cfg, params, x)
    return logits, cache


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """The serving cache, bf16 by default whatever the param dtype (as
    the reference's ``init_cache(dtype=jnp.bfloat16)``): attention k/v and
    Mamba conv tails in ``dtype``, Mamba states ``h`` always fp32."""
    return transformer.init_cache(cfg, batch, max_seq, dtype, device)


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16):
    """``init_cache``'s shapes and dtypes as ``meta`` tensors: attention
    k/v and Mamba conv tails in ``dtype``, Mamba states ``h`` fp32."""
    return transformer.abstract_cache(cfg, batch, max_seq, dtype)
