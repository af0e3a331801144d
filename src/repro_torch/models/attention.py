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
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention
from ..sharding.context import (head_plan, local_rows, plan_placements,
                                run_local, unshard_dim)
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
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = _split_heads(q, cfg.n_heads, cfg.head_dim)
    k = _split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd); a DTensor split on its features
    over a mesh dim that does not divide ``n`` heads (arctic's 56 and 8
    over 16) is gathered on them first, as DTensor cannot unflatten it."""
    if isinstance(t, DTensor) and any(
            isinstance(p, Shard) and p.dim == t.ndim - 1
            and n % t.device_mesh.size(i)
            for i, p in enumerate(t.placements)):
        t = unshard_dim(t, -1)
    return t.reshape(t.shape[0], t.shape[1], n, hd)


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
    cache_v).  On DTensors the flash kernel runs on each rank's own batch
    rows and heads (the reference's ``constrain_heads`` layout), and each
    rank writes the cache rows it holds."""
    q, k, v = _project_qkv(cfg, params, x, positions)
    if isinstance(q, DTensor):
        plan = head_plan(q, 0, (q.shape[2], k.shape[2]))
        qkv = plan_placements(plan, 0, 2)
        out = run_local(_flash_heads, q.device_mesh, (q, k, v),
                        (qkv, qkv, qkv), (plan_placements(plan, 0, 2),))
        _write_rows(cache_k, k)
        _write_rows(cache_v, v)
    else:
        S = q.shape[1]
        cache_k[:, :S].copy_(k)
        cache_v[:, :S].copy_(v)
        out = _flash_heads(q, k, v)
    return out @ params["wo"], cache_k, cache_v


def _flash_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,KV,hd) -> (B,S,H*hd): ``flash_attention`` on
    contiguous (B*n, S, hd) views of each."""
    B, S, H, hd = q.shape

    def heads(t):  # (B, S, n, hd) -> (B * n, S, hd), contiguous
        return t.transpose(1, 2).reshape(B * t.shape[2], S, hd).contiguous()

    out = flash_attention(heads(q), heads(k), heads(v),
                          groups=H // k.shape[2])
    return out.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)


def _rows_placements(cache: DTensor) -> tuple:
    """A (B, S, ...) tensor's placements beside ``cache``: its batch split
    as the cache's, everything else whole on every rank."""
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in cache.placements)


def _write_rows(cache: DTensor, new: DTensor) -> None:
    """Rows ``[0, S)`` of a sharded (B, S_max, KV, hd) cache from ``new``
    (B, S, KV, hd): each rank copies the rows of its own cache shard."""
    rows = new.redistribute(cache.device_mesh,
                            _rows_placements(cache)).to_local()
    lo, hi = local_rows(cache, 1)
    a, b = max(lo, 0), min(hi, new.shape[1])
    if a < b:   # (after the collective, which every rank takes part in)
        with torch.no_grad():
            cache.to_local()[:, a - lo:b - lo].copy_(rows[:, a:b])


def attention_decode(cfg: ArchConfig, params: Params, x: torch.Tensor,
                     pos: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode: x (B, 1, d), cache (B, S_max, KV, hd); ``pos``
    is the (B,)-shaped current position (tokens <= pos are attended).
    The new k/v are written at ``pos`` in place; a position past the cache
    writes its last row, as the reference's ``dynamic_update_slice``
    clamps its start.  On DTensors the row write, scores and softmax run
    on each rank's own cache shard (``_sharded_decode``)."""
    q, k, v = _project_qkv(cfg, params, x, pos[:, None])
    if isinstance(q, DTensor):
        out = _sharded_decode(q, k, v, pos, cache_k, cache_v, x.dtype)
    else:
        out = _decode_core(q, k, v, pos, cache_k, cache_v, x.dtype)
    return out @ params["wo"], cache_k, cache_v


def _decode_core(q, k, v, pos, cache_k, cache_v, dtype, shard=None):
    """The decode step over the cache: the new k/v written at ``pos``, then
    the masked scores and softmax.  ``shard`` = (lo, smax): the cache is
    rows ``[lo, lo + n)`` of ``smax`` (a cache split on S); the row is
    written only where it falls in them, and the result is these rows'
    unnormalised (out (B,1,H*hd) fp32, row max (B,H), sum (B,H))."""
    B, n = q.shape[0], cache_k.shape[1]
    lo, smax = shard or (0, n)
    rows = torch.arange(B, device=q.device)
    at = pos.clamp(0, smax - 1)
    if shard is None:
        cache_k[rows, at] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, at] = v[:, 0].to(cache_v.dtype)
    else:
        # a row outside this shard rewrites the shard's own row
        at = at - lo
        mine = ((at >= 0) & (at < n))[:, None, None]
        at = at.clamp(0, n - 1)
        cache_k[rows, at] = torch.where(mine, k[:, 0].to(cache_k.dtype),
                                        cache_k[rows, at])
        cache_v[rows, at] = torch.where(mine, v[:, 0].to(cache_v.dtype),
                                        cache_v[rows, at])
    scores = _gqa_scores(q, cache_k)                           # (B,H,1,n)
    valid = (torch.arange(lo, lo + n, device=q.device)[None, None, None, :]
             <= pos[:, None, None, None])
    scores = torch.where(valid, scores,
                         torch.full((), NEG_INF, dtype=F32, device=q.device))
    if shard is None:
        return _gqa_out(torch.softmax(scores, dim=-1), cache_v, dtype)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return (_gqa_out(p, cache_v, dtype).to(F32), m[..., 0, 0],
            p.sum(dim=-1)[..., 0])


def _local_in(t, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``t`` in ``placements`` (a plain tensor, the
    same on every rank, split without a collective)."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements).to_local()
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements,
                             src_data_rank=None).to_local()


def _sharded_decode(q, k, v, pos, cache_k, cache_v, dtype):
    """``_decode_core`` on DTensors: each rank takes its batch rows of q,
    k, v and pos (all heads) beside its own shard of the cache.  Where the
    cache is split on S over ranks, each shard's partial softmax (out, max,
    sum) is gathered over them and combined (flash decoding)."""
    mesh = cache_k.device_mesh
    pl = cache_k.placements
    rows = _rows_placements(cache_k)
    by_s = [isinstance(p, Shard) and p.dim == 1 for p in pl]
    split = any(s and mesh.size(i) > 1 for i, s in enumerate(by_s))
    ql, kl, vl, posl = (_local_in(t, mesh, rows) for t in (q, k, v, pos))
    with torch.no_grad():
        ck, cv = cache_k.to_local(), cache_v.to_local()
        if not split:
            out = _decode_core(ql, kl, vl, posl, ck, cv, dtype)
            return DTensor.from_local(out, mesh, rows, run_check=False)
        o, m, s = _decode_core(ql, kl, vl, posl, ck, cv, dtype,
                               (local_rows(cache_k, 1)[0], cache_k.shape[1]))
    # stack the shards' partials on a new dim 0, split over the S ranks
    stacked = tuple(Shard(0) if s_ else (Shard(1) if isinstance(p, Shard)
                                         else Replicate())
                    for s_, p in zip(by_s, rows))
    whole = tuple(Replicate() if s_ else p for s_, p in zip(by_s, stacked))
    o, m, s = (DTensor.from_local(t[None], mesh, stacked, run_check=False)
               .redistribute(mesh, whole).to_local() for t in (o, m, s))
    top = m.amax(dim=0)
    w = torch.exp(m - top)                                     # (n_s,B,H)
    B, _, Hhd = o.shape[1:]
    H = w.shape[2]
    num = (o.reshape(o.shape[0], B, 1, H, Hhd // H)
           * w[:, :, None, :, None]).sum(dim=0)
    out = (num / (s * w).sum(dim=0)[:, None, :, None]).reshape(B, 1, Hhd)
    out = out.to(torch.promote_types(dtype, cache_v.dtype))
    return DTensor.from_local(out, mesh, rows, run_check=False)


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
