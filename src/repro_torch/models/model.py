"""Public model API, serving half: init / prefill / decode / cache.

Batch contract (as in ``repro.models.model``):
  prefill: {"tokens": (B, S_tok) integer, optional "prefix_embeds": (B, F, d)}
           with F + S_tok = S
  decode:  token (B, 1) integer, pos (B,) integer, plus the cache

Params are the reference's pytree as plain dicts of tensors:
``{"embedding", ["lm_head"], "blocks": [per period position, leaves
stacked over groups], "final_norm"}``; ``convert.params_from`` carries
the reference's own.  ``train_loss`` belongs to the training path
(ROADMAP Queue A item 11).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from . import transformer
from .layers import apply_norm, embed_tokens, init_embed, init_norm, lm_logits

Params = Dict[str, Any]


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random params at the reference's init scales, drawn from ``gen`` on
    ``gen.device``."""
    return {
        **init_embed(cfg, gen),
        "blocks": transformer.init_stack(cfg, gen),
        "final_norm": init_norm(cfg, gen),
    }


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


def serve_prefill(cfg: ArchConfig, params: Params, batch, cache):
    """Returns (last-position logits (B, 1, V), the cache with its first S
    rows, and each Mamba position's state and conv tail, written in
    place).  A config with a Mamba mixer takes the reference's prompt
    lengths only: at most the chunk or a multiple of it, and at least
    ``d_conv - 1`` tokens (else ``ValueError``)."""
    x, positions, _ = _assemble_inputs(cfg, params, batch)
    x, cache = transformer.forward_prefill(cfg, params, x, positions, cache)
    x = apply_norm(cfg, params.get("final_norm", {}), x)
    logits = lm_logits(cfg, params, x[:, -1:, :])
    return logits, cache


def serve_decode(cfg: ArchConfig, params: Params, token: torch.Tensor,
                 pos: torch.Tensor, cache):
    """One decode step: token (B, 1) -> logits (B, 1, V); the cache gets
    row ``pos`` (and each Mamba position its new state and conv tail) in
    place."""
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
