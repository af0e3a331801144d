"""Block assembly and layer stacks (the serving half of
``repro.models.transformer``).

A config's layer pattern is described by a *period*: the smallest repeating
block structure.  Dense archs have period 1 (attention + MLP); jamba has
period 8 (7 mamba + 1 attention, MoE on odd positions).  As in the
reference, layers are stored stacked over ``n_groups = n_layers / period``:
``params["blocks"]`` is a list over period positions whose leaves are
(G, ...) tensors, and the forward passes loop over groups (the
reference's ``lax.scan``) and over the period inside.

Cache layout (serving): every period position owns a leaf stacked over
groups: attention -> ``{"k", "v": (G, B, S_max, KV, hd)}`` in the cache
dtype, mamba -> ``{"h": (G, B, H, N, P)`` fp32, ``"conv": (G, B, K-1,
conv_dim)}`` in the cache dtype.  Prefill and decode write it in place
(the scheduler prefills into views of one slot's rows).

The port serves both mixers with ``channel`` in ``{"mlp", "moe",
"none"}``; an MoE channel runs ``moe.apply_moe`` and drops its aux, as the
reference's prefill and decode do.

Training (``forward_train``) runs the same loops through the training
mixers (``attn.attention_train``, ``mamba2.apply_mamba_train``), sums the
MoE aux losses, and puts ``grad_boundary`` at every block edge.  With
``cfg.remat`` each group runs under ``torch.utils.checkpoint`` (policy
``"full"``: nothing saved inside the group; ``"dots"``: the matrix
products' outputs saved), the reference's ``jax.checkpoint`` of its scan
body.  ``constraint`` is the activation sharding constraint: ``None`` on
one device.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..sharding.context import like_layout, unshard_dim, write_local
from . import attention as attn
from . import mamba2, moe
from .layers import apply_mlp, apply_norm, init_mlp, init_norm

Params = Dict[str, Any]
F32 = torch.float32


class _GradBoundary(torch.autograd.Function):
    """Identity forward; the backward casts the cotangent to the primal
    dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_boundary(x: torch.Tensor) -> torch.Tensor:
    """Identity with a cotangent dtype boundary (the reference's
    ``custom_vjp``): fp32 products (attention scores, the router) give
    their inputs fp32 cotangents, and this casts the cotangent back to the
    primal dtype at each block edge so the promotion does not run down the
    residual stream.  autograd already casts a cotangent to its input's
    dtype; the boundary names where the reference puts it."""
    return _GradBoundary.apply(x)


def period_of(cfg: ArchConfig) -> int:
    p = 1
    if cfg.mamba is not None and cfg.n_heads > 0:
        p = cfg.attn_every
    if cfg.moe is not None:
        p = max(p, cfg.moe.moe_every)
        assert p % cfg.moe.moe_every == 0
    assert cfg.n_layers % p == 0, \
        f"{cfg.name}: n_layers {cfg.n_layers} % period {p} != 0"
    return p


def n_groups_of(cfg: ArchConfig) -> int:
    return cfg.n_layers // period_of(cfg)


def position_kind(cfg: ArchConfig, pos: int) -> Tuple[str, str]:
    """(mixer, channel) for period position ``pos``:
    mixer in {attn, mamba}; channel in {mlp, moe, none}."""
    mixer = "attn" if cfg.block_is_attention(pos) else "mamba"
    if cfg.moe is not None and cfg.block_is_moe(pos):
        channel = "moe"
    elif cfg.d_ff > 0:
        channel = "mlp"
    else:
        channel = "none"
    return mixer, channel


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_block_position(cfg: ArchConfig, pos: int,
                        gen: torch.Generator) -> Params:
    mixer, channel = position_kind(cfg, pos)
    p: Params = {"ln1": init_norm(cfg, gen)}
    if mixer == "attn":
        p["attn"] = attn.init_attention(cfg, gen)
    else:
        p["mamba"] = mamba2.init_mamba(cfg, gen)
    if channel != "none":
        p["ln2"] = init_norm(cfg, gen)
        if channel == "moe":
            p["moe"] = moe.init_moe(cfg, gen)
        else:
            p["mlp"] = init_mlp(cfg, gen)
    return p


def _fill_group(stacked: Params, tree: Params, g: int, groups: int) -> None:
    """Move ``tree``'s leaves into group ``g`` of ``stacked``, each stacked
    leaf allocated when group 0 reaches it (one group: the leaf itself,
    unsqueezed), dropping each leaf from ``tree`` once moved, so that at
    most one leaf is held twice."""
    for k in list(tree):
        v = tree.pop(k)
        if isinstance(v, dict):
            _fill_group(stacked.setdefault(k, {}), v, g, groups)
        elif groups == 1:
            stacked[k] = v.unsqueeze(0)
        else:
            if g == 0:
                stacked[k] = torch.empty((groups,) + tuple(v.shape),
                                         dtype=v.dtype, device=v.device)
            stacked[k][g].copy_(v)


def group_params(blocks: Params, g: int) -> Params:
    """Group ``g``'s slice of a period position's stacked leaves (views;
    a DTensor stack split on its group dim is gathered on it first)."""
    return {k: (group_params(v, g) if isinstance(v, dict)
                else unshard_dim(v, 0)[g])
            for k, v in blocks.items()}


def init_stack(cfg: ArchConfig, gen: torch.Generator) -> List[Params]:
    """params["blocks"]: list over period positions, leaves stacked over
    groups.  Each position's groups are drawn one after another, and each
    stacked leaf is allocated once and filled group by group, so the
    resident weights are never held twice (an MoE position's experts are
    the bulk of a large model)."""
    groups = n_groups_of(cfg)
    blocks = []
    for pos in range(period_of(cfg)):
        stacked: Params = {}
        for g in range(groups):
            _fill_group(stacked, init_block_position(cfg, pos, gen), g,
                        groups)
        blocks.append(stacked)
    return blocks


# ---------------------------------------------------------------------------
# Forward (prefill / decode)
# ---------------------------------------------------------------------------


def _channel(cfg: ArchConfig, pos: int, bp: Params, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``x`` plus the position's channel (MLP or MoE) on its normed input,
    and the MoE aux (empty for an MLP or no channel)."""
    _, channel = position_kind(cfg, pos)
    if channel == "none":
        return x, {}
    h = _seq_whole(apply_norm(cfg, bp.get("ln2", {}), x))
    if channel == "moe":
        y, aux = moe.apply_moe(cfg, bp["moe"], h)
        return x + like_layout(y, x), aux
    return x + like_layout(apply_mlp(cfg, bp["mlp"], h), x), {}


def _seq_whole(h: torch.Tensor) -> torch.Tensor:
    """A normed (B, S, d) input gathered on S before the mixer's, the
    channel's or the head's products (Megatron-SP's all-gather after the
    norm: the
    activation constraint splits the residual stream on S, and DTensor
    cannot flatten (B, S) with S split).  A plain tensor as it is."""
    return unshard_dim(h, 1)


def _apply_channel(cfg: ArchConfig, pos: int, bp: Params,
                   x: torch.Tensor) -> torch.Tensor:
    """The serving channel: the MoE aux dropped."""
    return _channel(cfg, pos, bp, x)[0]


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device="cuda") -> List[Dict[str, torch.Tensor]]:
    """One cache entry per period position, leaves stacked over groups; a
    Mamba position's state ``h`` is fp32 whatever ``dtype``."""
    groups = n_groups_of(cfg)
    cache: List[Dict[str, torch.Tensor]] = []
    for pos in range(period_of(cfg)):
        mixer, _ = position_kind(cfg, pos)
        if mixer == "attn":
            shape = (groups, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            cache.append({
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)})
        else:
            hs, cs = mamba2.mamba_state_shapes(cfg, batch)
            cache.append({
                "h": torch.zeros((groups,) + hs, dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((groups,) + cs, dtype=dtype,
                                    device=device)})
    return cache


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16
                   ) -> List[Dict[str, torch.Tensor]]:
    """The cache's shapes and dtypes as ``meta`` tensors (the reference's
    ``eval_shape`` of ``init_cache``): nothing is allocated."""
    return init_cache(cfg, batch, max_seq, dtype, device="meta")


def _forward(cfg: ArchConfig, params: Params, x: torch.Tensor, cache,
             attn_mix, decode: bool, constraint=None
             ) -> Tuple[torch.Tensor, list]:
    """The stack: for every group, every period position's mixer, then its
    channel.  An attention position runs ``attn_mix(bp, h, cache_k,
    cache_v)``, which writes its cache rows in place; a Mamba position runs
    ``mamba2._mamba_forward`` from the cached state (and, decoding, the
    cached conv tail) and copies the new state and tail into the cache.
    ``constraint`` (prefill) is applied to ``x`` before each period
    position, as in the reference.  On DTensors the normed input is
    gathered on S and each cache write lands in the cache's placements."""
    for g in range(n_groups_of(cfg)):
        for pos in range(period_of(cfg)):
            bp = group_params(params["blocks"][pos], g)
            if constraint is not None:
                x = constraint(x)
            h = _seq_whole(apply_norm(cfg, bp.get("ln1", {}), x))
            c = cache[pos]
            mixer, _ = position_kind(cfg, pos)
            if mixer == "attn":
                y, _, _ = attn_mix(bp["attn"], h, c["k"][g], c["v"][g])
            else:
                y, h_new, conv_new = mamba2._mamba_forward(
                    cfg, bp["mamba"], h, h0=c["h"][g],
                    conv0=c["conv"][g] if decode else None)
                write_local(c["h"][g], h_new)
                write_local(c["conv"][g], conv_new)
            x = _apply_channel(cfg, pos, bp, x + like_layout(y, x))
    return x, cache


def forward_prefill(cfg: ArchConfig, params: Params, x: torch.Tensor,
                    positions: torch.Tensor, cache, constraint=None):
    """Prefill: causal forward that fills the cache's first S rows (and
    each Mamba position's state and conv tail).  A config with a Mamba
    mixer refuses, before any layer runs, a length off the chunk contract
    or shorter than the conv tail (``mamba2.check_prefill``).
    ``constraint`` is the activation sharding constraint (None on one
    device), applied before each period position."""
    if cfg.mamba is not None:
        mamba2.check_prefill(cfg, x.shape[1])
    return _forward(cfg, params, x, cache, lambda p, h, ck, cv:
                    attn.attention_prefill(cfg, p, h, positions, ck, cv),
                    decode=False, constraint=constraint)


def forward_decode(cfg: ArchConfig, params: Params, x: torch.Tensor,
                   pos: torch.Tensor, cache):
    """Single-token decode: x (B, 1, d); pos (B,) current positions."""
    return _forward(cfg, params, x, cache, lambda p, h, ck, cv:
                    attn.attention_decode(cfg, p, h, pos, ck, cv),
                    decode=True)


# ---------------------------------------------------------------------------
# Forward (train)
# ---------------------------------------------------------------------------


def _train_group_body(cfg: ArchConfig, constraint, x: torch.Tensor,
                      aux: Dict[str, torch.Tensor], group: List[Params],
                      positions: torch.Tensor):
    """One group: every period position's mixer, then its channel; an MoE
    channel's aux losses added to ``aux`` (its router probs dropped)."""
    for pos in range(period_of(cfg)):
        bp = group[pos]
        # constraint BEFORE the boundary, as in the reference: backward
        # casts the cotangent before the constraint's resharding.
        if constraint is not None:
            x = constraint(x)
        x = grad_boundary(x)
        h = _seq_whole(apply_norm(cfg, bp.get("ln1", {}), x))
        mixer, _ = position_kind(cfg, pos)
        if mixer == "attn":
            y = attn.attention_train(cfg, bp["attn"], h, positions)
        else:
            y = mamba2.apply_mamba_train(cfg, bp["mamba"], h)
        x, a = _channel(cfg, pos, bp, x + like_layout(y, x))
        if a:
            aux = {k: aux.get(k, 0.0) + v for k, v in a.items()
                   if not k.endswith("probs")}
    return x, aux


def _unbind(tree: Params, groups: int) -> List[Params]:
    """A period position's stacked leaves as ``groups`` trees of views
    (one ``unbind`` a leaf: its backward stacks the groups' grads once)."""
    out: List[Params] = [{} for _ in range(groups)]
    for k, v in tree.items():
        # DTensor has no unbind of a split dim: an FSDP-sharded group
        # stack is gathered first (the all-gather at use)
        parts = (_unbind(v, groups) if isinstance(v, dict)
                 else unshard_dim(v, 0).unbind(0))
        for g in range(groups):
            out[g][k] = parts[g]
    return out


# Matrix products whose outputs the "dots" policy saves (the reference's
# dots_with_no_batch_dims_saveable keeps the dots; here mm, bmm, addmm).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def forward_train(cfg: ArchConfig, params: Params, x: torch.Tensor,
                  positions: torch.Tensor, constraint=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) embedded inputs -> final hidden states + aux losses
    (``moe_lb_loss``, ``moe_z_loss`` summed over the MoE positions, fp32;
    empty without MoE)."""
    aux: Dict[str, torch.Tensor] = {}
    if cfg.moe is not None:
        aux = {k: torch.zeros((), dtype=F32, device=x.device)
               for k in ("moe_lb_loss", "moe_z_loss")}
    n_groups = n_groups_of(cfg)
    per_pos = [_unbind(p, n_groups) for p in params["blocks"]]
    body = functools.partial(_train_group_body, cfg, constraint)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    for g in range(n_groups):
        group = [p[g] for p in per_pos]
        if cfg.remat:
            x, aux = checkpoint(body, x, aux, group, positions,
                                use_reentrant=False,
                                preserve_rng_state=False, **kw)
        else:
            x, aux = body(x, aux, group, positions)
    return x, aux
