"""input_specs(): ``meta`` tensor stand-ins for every model input, per
(arch x shape) (``repro.launch.specs_io`` in torch).  Nothing is
allocated.

Shapes are the reference's.  Token ids and positions are ``int64``, as
the port's own inputs are (``train.data.SyntheticStream`` yields them so,
``serve.engine`` builds them so); the reference's are ``int32``.
``prefix_embeds`` is in the config's param dtype and the cache is
``models.model.abstract_cache`` (bf16 k/v and conv tails, fp32 Mamba
states).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import SHAPES, ArchConfig, ShapeConfig
from ..models import model as model_lib
from ..models.layers import pdtype

TOKEN_DTYPE = torch.int64


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeConfig
                      ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    s_tok = S - cfg.frontend_len
    out = {
        "tokens": _spec((B, s_tok), TOKEN_DTYPE),
        "labels": _spec((B, s_tok), TOKEN_DTYPE),
    }
    if cfg.frontend is not None:
        out["prefix_embeds"] = _spec((B, cfg.frontend_len, cfg.d_model),
                                     pdtype(cfg))
    return out


def prefill_input_specs(cfg: ArchConfig, shape: ShapeConfig
                        ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(batch specs, abstract cache) for a prefill of the full sequence."""
    batch = train_input_specs(cfg, shape)
    del batch["labels"]
    cache = model_lib.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    return batch, cache


def decode_input_specs(cfg: ArchConfig, shape: ShapeConfig
                       ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(decode inputs, abstract cache at full context length)."""
    B = shape.global_batch
    inputs = {
        "token": _spec((B, 1), TOKEN_DTYPE),
        "pos": _spec((B,), TOKEN_DTYPE),
    }
    cache = model_lib.abstract_cache(cfg, B, shape.seq_len)
    return inputs, cache


def input_specs(cfg: ArchConfig, shape_name: str):
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return {"kind": "train", "batch": train_input_specs(cfg, shape)}
    if shape.kind == "prefill":
        batch, cache = prefill_input_specs(cfg, shape)
        return {"kind": "prefill", "batch": batch, "cache": cache}
    batch, cache = decode_input_specs(cfg, shape)
    return {"kind": "decode", "batch": batch, "cache": cache}
