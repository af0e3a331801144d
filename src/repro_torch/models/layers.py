"""Shared model layers: norms, RoPE, MLPs, embedding, LM head, chunked CE
loss.

Functional style, as in ``repro.models.layers``: params are plain dicts of
tensors; every layer is ``fn(cfg, params, x, ...) -> y``.  Compute in the
param dtype, norm/activation math in fp32.  Init draws from an explicit
``torch.Generator`` on the generator's device, at the reference's scales
(the numbers differ from ``jax.random``'s; parity goes through
``convert.params_from``).  Training differentiates these functions with
autograd (``model.train_loss``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ArchConfig
from ..sharding.context import run_local

Params = Dict[str, torch.Tensor]
F32 = torch.float32


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def normal(gen: torch.Generator, shape, scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """fp32 standard normal draws times ``scale``, cast to ``dtype`` (the
    reference's ``(jax.random.normal(k, shape) * scale).astype(dt)``).
    Scaled in place: the same bits as ``x * scale``, without a second
    fp32 temporary (one expert group of arctic-480b is 17.8 GB in fp32)."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=F32)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ArchConfig, gen: torch.Generator) -> Params:
    if cfg.norm == "ln_nonparam":
        return {}
    return {"scale": torch.ones((cfg.d_model,), dtype=pdtype(cfg),
                                device=gen.device)}


def apply_norm(cfg: ArchConfig, params: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    if cfg.norm == "ln_nonparam":
        # olmo: LayerNorm without learnable scale/bias; population variance
        # (jnp.var), hence correction=0.
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    scale = params["scale"].to(F32)
    if cfg.norm == "rmsnorm_1p":      # gemma convention: (1 + scale)
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=F32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotate-half
    RoPE: the first and second halves of head_dim are the pairs."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    angles = positions[..., :, None].to(F32) * freqs         # (...,S,hd/2)
    angles = angles[..., None, :]                            # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (swiglu / gelu)
# ---------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, gen: torch.Generator) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    dt = pdtype(cfg)
    if cfg.mlp == "swiglu":
        return {"w_gate": normal(gen, (d, f), d ** -0.5, dt),
                "w_up": normal(gen, (d, f), d ** -0.5, dt),
                "w_down": normal(gen, (f, d), f ** -0.5, dt)}
    return {"w_in": normal(gen, (d, f), d ** -0.5, dt),
            "w_out": normal(gen, (f, d), f ** -0.5, dt)}


def apply_mlp(cfg: ArchConfig, params: Params,
              x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        return (F.silu(g.to(F32)).to(x.dtype) * u) @ params["w_down"]
    h = x @ params["w_in"]
    # jax.nn.gelu defaults to the tanh approximation.
    h = F.gelu(h.to(F32), approximate="tanh").to(x.dtype)
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# Embedding / LM head / loss
# ---------------------------------------------------------------------------


def init_embed(cfg: ArchConfig, gen: torch.Generator) -> Params:
    dt = pdtype(cfg)
    shape = (cfg.padded_vocab, cfg.d_model)
    out = {"embedding": normal(gen, shape, 0.02, dt)}
    if not cfg.tie_embeddings:
        out["lm_head"] = normal(gen, shape, 0.02, dt)
    return out


def embed_tokens(cfg: ArchConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    table = params["embedding"]
    if isinstance(table, DTensor):
        # DTensor's rules for an indexed read of a split table (and its
        # backward, index_put) fail: each rank reads its own batch rows
        # from the whole table
        rows = tuple(p if isinstance(p, Shard) and p.dim == 0
                     else Replicate() for p in tokens.placements)
        return run_local(lambda t, tok: t[tok], table.device_mesh,
                         (table, tokens),
                         ((Replicate(),) * len(rows), rows), (rows,))
    return table[tokens]


def lm_logits(cfg: ArchConfig, params: Params,
              x: torch.Tensor) -> torch.Tensor:
    head = params.get("lm_head", params["embedding"])
    return x @ head.T


def chunked_ce_loss(cfg: ArchConfig, params: Params, x: torch.Tensor,
                    labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over the vocab, computed in sequence chunks of
    ``cfg.loss_chunk`` (one chunk of all S when the chunk does not divide
    S, as in the reference).  Chunking bounds the forward pass alone: one
    chunk's (B, chunk, V) logits at a time.  Under autograd
    ``logsumexp`` keeps every chunk's fp32 logits for the backward, so a
    training step holds all B * S * V of them, as the reference's scan
    stores them.

    The logits are the head product in the activation dtype, then cast to
    fp32 (bf16 logits are rounded to bf16 first, as the reference's are);
    the gold logit is gathered (the reference's one-hot contraction gives
    the same fp32 value).  Returns (sum_loss, per_token_loss (B, S)) — the
    per-token loss feeds the ISLA telemetry."""
    B, S, _ = x.shape
    head = params.get("lm_head", params["embedding"])  # (V, D)
    chunk = min(cfg.loss_chunk, S)
    if S % chunk != 0:
        chunk = S
    if mask is None:
        mask = torch.ones((B, S), dtype=F32, device=x.device)
    labels = labels.long()
    toks = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = (x[:, sl] @ head.T).to(F32)                # (B, chunk, V)
        logz = torch.logsumexp(logits, dim=-1)
        if isinstance(logits, DTensor):
            # DTensor's gather on vocab-sharded logits has no working
            # rule: the gold logit as a masked sum over the vocab (the
            # reference's one-hot contraction; the same fp32 value)
            vocab = torch.arange(logits.shape[-1], device=x.device)
            gold = torch.where(labels[:, sl, None] == vocab, logits,
                               0.0).sum(-1)
        else:
            gold = torch.gather(logits, -1, labels[:, sl, None])[..., 0]
        toks.append((logz - gold) * mask[:, sl])
    per_token = torch.cat(toks, dim=1)
    return per_token.sum(), per_token
