"""GQA/MQA attention with RoPE, causal masking and a KV cache decode path.

Layouts, as in ``repro.models.attention``:
  q:  (B, S, H, hd)    k/v: (B, S, KV, hd)    cache: (B, S_max, KV, hd)
Each KV head serves G = H // KV consecutive q heads.

Prefill attention runs through the hand-written flash kernel
(``kernels.flash_attention``) on (B*H, S, hd) views of q and the freshly
projected k and v in the activation dtype — not the bf16 cache copy, as
the reference's ``_gqa_scores(q, k)`` does.  Decode attends over the
cache with plain torch ops (the reference's jnp path, outside any Pallas
kernel).  Both write the cache in place.  ``attention_train`` and
``_blocked_attention`` belong to the training path (ROADMAP Queue A
item 11).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention
from .layers import apply_rope, normal, pdtype

Params = Dict[str, torch.Tensor]
F32 = torch.float32

NEG_INF = -1e30


def init_attention(cfg: ArchConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    dt = pdtype(cfg)
    p = {
        "wq": normal(gen, (d, cfg.attn_dim), d ** -0.5, dt),
        "wk": normal(gen, (d, cfg.kv_dim), d ** -0.5, dt),
        "wv": normal(gen, (d, cfg.kv_dim), d ** -0.5, dt),
        "wo": normal(gen, (cfg.attn_dim, d), cfg.attn_dim ** -0.5, dt),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.attn_dim), ("bk", cfg.kv_dim),
                            ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((width,), dtype=dt, device=gen.device)
    return p


def _project_qkv(cfg: ArchConfig, params: Params, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,hd), k: (B,Sk,KV,hd) -> scores (B,H,Sq,Sk) fp32 (a bf16
    product is exact in fp32, so this is the reference's fp32-accumulated
    einsum)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).to(F32)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(F32))
    return s.reshape(B, KV * G, Sq, k.shape[1]) * (hd ** -0.5)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """probs: (B,H,Sq,Sk) fp32, v: (B,Sk,KV,hd) -> (B,Sq,H*hd).  The probs
    are rounded to ``dtype`` first, and the fp32 product to the type the
    reference's einsum of ``dtype`` and v's type gives."""
    B, H, Sq, Sk = probs.shape
    KV = v.shape[2]
    G = H // KV
    pg = probs.reshape(B, KV, G, Sq, Sk).to(dtype).to(F32)
    o = torch.einsum("bkgqs,bskh->bqkgh", pg, v.to(F32))
    return o.reshape(B, Sq, H * v.shape[3]).to(
        torch.promote_types(dtype, v.dtype))


def attention_prefill(cfg: ArchConfig, params: Params, x: torch.Tensor,
                      positions: torch.Tensor, cache_k: torch.Tensor,
                      cache_v: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention over ``positions = arange(S)`` that also writes the
    first S rows of the KV cache, in place.  Returns (out, cache_k,
    cache_v)."""
    q, k, v = _project_qkv(cfg, params, x, positions)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    cache_k[:, :S].copy_(k)
    cache_v[:, :S].copy_(v)

    def heads(t):  # (B, S, n, hd) -> (B * n, S, hd), contiguous
        return t.transpose(1, 2).reshape(B * t.shape[2], S, hd).contiguous()

    out = flash_attention(heads(q), heads(k), heads(v), groups=H // KV)
    out = out.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)
    return out @ params["wo"], cache_k, cache_v


def attention_decode(cfg: ArchConfig, params: Params, x: torch.Tensor,
                     pos: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode: x (B, 1, d), cache (B, S_max, KV, hd); ``pos``
    is the (B,)-shaped current position (tokens <= pos are attended).
    The new k/v are written at ``pos`` in place; a position past the cache
    writes its last row, as the reference's ``dynamic_update_slice``
    clamps its start."""
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, params, x, pos[:, None])
    smax = cache_k.shape[1]
    rows = torch.arange(B, device=x.device)
    at = pos.clamp(0, smax - 1)
    cache_k[rows, at] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, at] = v[:, 0].to(cache_v.dtype)
    scores = _gqa_scores(q, cache_k)                           # (B,H,1,Smax)
    valid = (torch.arange(smax, device=x.device)[None, None, None, :]
             <= pos[:, None, None, None])
    scores = torch.where(valid, scores,
                         torch.full((), NEG_INF, dtype=F32, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, cache_v, x.dtype)
    return out @ params["wo"], cache_k, cache_v
