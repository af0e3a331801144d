"""GQA/MQA attention with RoPE, causal masking and a KV cache decode path.

Layouts, as in ``repro.models.attention``:
  q:  (B, S, H, hd)    k/v: (B, S, KV, hd)    cache: (B, S_max, KV, hd)
Each KV head serves G = H // KV consecutive q heads.

Prefill attention runs through the hand-written flash kernel
(``kernels.flash_attention``) on (B*H, S, hd) views of q and the freshly
projected k and v in the activation dtype — not the bf16 cache copy, as
the reference's ``_gqa_scores(q, k)`` does.  Decode attends over the
cache with plain torch ops (the reference's jnp path, outside any Pallas
kernel).  Both write the cache in place.

Training attention (``attention_train``) is the reference's jnp path in
torch ops, differentiated by autograd: the flash kernel, like the
reference's Pallas kernel, has no backward.  Dense scores below
``BLOCKED_THRESHOLD`` tokens, the blocked online softmax
(``_blocked_attention``) at or above it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention
from ..sharding.context import head_plan, plan_placements, run_local
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


def _masked(scores: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``jnp.where(keep, scores, NEG_INF)``: a finite fill, so that no NaN
    reaches a gradient."""
    return torch.where(keep, scores, torch.full((), NEG_INF, dtype=F32,
                                                device=scores.device))


# Blocked online softmax at and above this sequence length (the
# reference's: below it the dense (B, H, S, S) scores fit and are faster).
BLOCKED_THRESHOLD = 8192


def attention_train(cfg: ArchConfig, params: Params, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention for training: dense fp32 scores and softmax,
    the probabilities rounded to the activation dtype before P.V
    (``_gqa_out``); at ``S >= BLOCKED_THRESHOLD`` with ``S % 1024 == 0``
    the blocked online softmax at block 1024, as in the reference."""
    q, k, v = _project_qkv(cfg, params, x, positions)
    if isinstance(q, DTensor):
        # DTensor has no rule for the scores' einsum over split heads
        # (it flattens batch and KV heads): batch and heads are
        # independent, so the core runs on each rank's own ones
        plan = head_plan(q, 0, (q.shape[2], k.shape[2]))
        qkv = plan_placements(plan, 0, 2)
        out = run_local(_attention_core, q.device_mesh,
                        (q, k, v, positions),
                        (qkv, qkv, qkv, plan_placements(plan, 0)),
                        (plan_placements(plan, 0, 2),))
    else:
        out = _attention_core(q, k, v, positions)
    return out @ params["wo"]


def _attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,KV,hd) -> (B,S,H*hd) in q's dtype: dense
    causal scores, or the blocked online softmax at and above
    ``BLOCKED_THRESHOLD`` tokens."""
    S = q.shape[1]
    if S >= BLOCKED_THRESHOLD and S % 1024 == 0:
        return _blocked_attention(q, k, v, positions, block=1024)
    causal = positions[:, None, :, None] >= positions[:, None, None, :]
    probs = torch.softmax(_masked(_gqa_scores(q, k), causal), dim=-1)
    return _gqa_out(probs, v, q.dtype)


def _blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, block: int) -> torch.Tensor:
    """Exact causal attention with an online softmax over KV blocks.

    q: (B,S,H,hd); k/v: (B,S,KV,hd).  Returns (B,S,H*hd) in q's dtype.
    The running max ``m``, normaliser ``l`` and accumulator ``acc`` are
    fp32; both contractions are fp32 products of the input-dtype operands
    (exact in fp32), and ``p`` is rounded to v's dtype before P.V, as in
    the reference."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).to(F32)
    scale = hd ** -0.5
    m = torch.full((B, KV, G, S), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=F32, device=q.device)
    acc = torch.zeros((B, KV, G, S, hd), dtype=F32, device=q.device)
    for j in range(S // block):
        sl = slice(j * block, (j + 1) * block)
        k_j, v_j, p_j = k[:, sl], v[:, sl], positions[:, sl]
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, k_j.to(F32)) * scale
        causal = positions[:, None, None, :, None] >= \
            p_j[:, None, None, None, :]
        s = _masked(s, causal)                   # (B,KV,G,S,block)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskh->bkgqh", p.to(v_j.dtype).to(F32),
                          v_j.to(F32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]    # (B,KV,G,S,hd)
    out = out.movedim(3, 1)                      # (B,S,KV,G,hd)
    return out.reshape(B, S, H * hd).to(q.dtype)
