"""Modality frontend stubs for the [audio] / [vlm] architectures
(``repro.models.frontends`` in torch).

The transformer backbone is what the repo serves; the modality frontend
(EnCodec frames, SigLIP patches) is a stub that hands the model
precomputed prefix embeddings, ``batch["prefix_embeds"]`` of
``serve_prefill``.  These helpers give their shape and a seeded stand-in.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ArchConfig
from .layers import pdtype


def frontend_embed_shape(cfg: ArchConfig,
                         batch: int) -> Optional[Tuple[int, int, int]]:
    """(B, frontend_len, d_model) prefix embeddings; None without a
    frontend."""
    if cfg.frontend is None:
        return None
    return (batch, cfg.frontend_len, cfg.d_model)


def synth_frontend_embeds(cfg: ArchConfig, batch: int,
                          gen: torch.Generator) -> torch.Tensor:
    """Deterministic stand-in for EnCodec frames / SigLIP patches: fp32
    N(0, 1) draws from ``gen`` on ``gen.device`` times 0.02, cast to the
    param dtype.  Its draws are torch's, not ``jax.random.normal``'s."""
    shape = frontend_embed_shape(cfg, batch)
    if shape is None:
        raise ValueError(f"{cfg.name} has no frontend")
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * 0.02).to(pdtype(cfg))
