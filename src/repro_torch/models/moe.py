"""Top-k (k=2) token-choice MoE with grouped capacity dispatch
(``repro.models.moe`` in torch).

Tokens are routed within fixed-size groups; each expert accepts up to C
tokens a group and overflow is dropped (the residual passes through).
Dispatch and combine are products against a (G, Tg, E, C) one-hot, as in
the reference, so the batch of tokens a call routes together decides
who is dropped: a prefill routes its S tokens, a decode step every slot.
Arctic's dense residual FFN runs beside the experts and is added.

The reference computes all of it in plain jnp, outside any Pallas kernel:
the routing is a few small elementwise ops a top-k pass, and the dispatch,
expert and combine products are large batched matmuls, so they stay
library matmuls here.  Nothing reads a value back to the host (no
``.item()``, no data-dependent shape), so a layer is launches only.

Aux: the switch-style load-balance loss (E * sum f_e * p_e), the router
z-loss and the mean router probabilities, returned beside the output; the
serving path drops them, as the reference's prefill and decode do.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..sharding.context import constrain_expert_parallel, run_local
from .layers import apply_mlp, init_mlp, normal, pdtype

Params = Dict[str, torch.Tensor]
F32 = torch.float32


def init_moe(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Expert weights are STORED in the virtual-expert layout
    (E*factor, d, f/factor) (see ``virtual_expert_factor``); the router is
    fp32 whatever the param dtype."""
    assert cfg.moe is not None
    e = cfg.moe.n_experts
    d, f = cfg.d_model, cfg.d_ff
    fac = virtual_expert_factor(cfg)
    ev, fv = e * fac, f // fac if f else 0
    dt = pdtype(cfg)
    s_in, s_out = d ** -0.5, f ** -0.5
    p: Params = {"router": normal(gen, (d, e), s_in, F32)}
    if cfg.mlp == "swiglu":
        p["w_gate"] = normal(gen, (ev, d, fv), s_in, dt)
        p["w_up"] = normal(gen, (ev, d, fv), s_in, dt)
        p["w_down"] = normal(gen, (ev, fv, d), s_out, dt)
    else:
        p["w_in"] = normal(gen, (ev, d, fv), s_in, dt)
        p["w_out"] = normal(gen, (ev, fv, d), s_out, dt)
    if cfg.moe.dense_residual:
        p["residual"] = init_mlp(cfg, gen)
    return p


def capacity(cfg: ArchConfig, tg: int) -> int:
    m = cfg.moe
    c = int(math.ceil(tg * m.top_k * m.capacity_factor / m.n_experts))
    # pad to even for layout, to 4 only when the relative waste is small
    # (small groups at large E make C tiny)
    c4 = ((c + 3) // 4) * 4
    if c4 <= 1.2 * c:
        return max(4, c4)
    return max(2, ((c + 1) // 2) * 2)


def virtual_expert_factor(cfg: ArchConfig, tp: int = 16) -> int:
    """When n_experts < the model axis (``tp``, the reference's 16 whatever
    the device count: it fixes the stored layout), split each expert's ff
    dim into ``factor`` *virtual experts*.  Exact for gated and gelu MLPs:
    the nonlinearity is elementwise in f, and the down-projection's
    partial sums are re-added by the combine's contraction over experts."""
    e = cfg.moe.n_experts
    if e >= tp or cfg.d_ff == 0:
        return 1
    factor = tp // e
    while factor > 1 and cfg.d_ff % factor != 0:
        factor //= 2
    return max(factor, 1)


def _expert_ffn(cfg: ArchConfig, params: Params,
                xe: torch.Tensor) -> torch.Tensor:
    """xe: (E', G, C, d) -> (E', G, C, d), per-(virtual-)expert weights on
    dim 0 (E' = E * factor; the stored layout)."""
    if cfg.mlp == "swiglu":
        g = torch.einsum("egcd,edf->egcf", xe, params["w_gate"])
        u = torch.einsum("egcd,edf->egcf", xe, params["w_up"])
        h = F.silu(g.to(F32)).to(xe.dtype) * u
        return torch.einsum("egcf,efd->egcd", h, params["w_down"])
    h = torch.einsum("egcd,edf->egcf", xe, params["w_in"])
    # jax.nn.gelu defaults to the tanh approximation.
    h = F.gelu(h.to(F32), approximate="tanh").to(xe.dtype)
    return torch.einsum("egcf,efd->egcd", h, params["w_out"])


def _local_moe(cfg: ArchConfig, params: Params, xt: torch.Tensor,
               dispatch: torch.Tensor, combine: torch.Tensor
               ) -> torch.Tensor:
    """The dispatch, expert and combine products on DTensors, run on each
    rank's own groups and experts (DTensor has no rule for their einsums
    over split experts: they flatten them with the slots).  The layout is
    ``constrain_expert_parallel``'s: groups over the dp axes and experts
    over "model" where they divide; where the experts do not, the
    expert-internal TP of the weights' spec (ff over "model").  Each rank
    combines its own experts (or ff slices), so the (G, Tg, d) output is a
    partial sum over "model"."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = xt.device_mesh
    G, E = dispatch.shape[0], dispatch.shape[2]
    up = ("w_gate", "w_up") if cfg.mlp == "swiglu" else ("w_in",)
    down = "w_down" if cfg.mlp == "swiglu" else "w_out"
    ff = params[down].shape[1]
    # per mesh dim: (xt, dispatch and combine, up weights, down weight, out)
    plan, dp = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        n = mesh.size(i)
        if name == "model" and E % n == 0:
            plan.append((Replicate(), Shard(2), Shard(0), Shard(0),
                         Partial()))
        elif name == "model" and ff % n == 0:
            plan.append((Replicate(), Replicate(), Shard(2), Shard(1),
                         Partial()))
        elif name in ("pod", "data") and G > 1 and G % (dp * n) == 0:
            dp *= n
            plan.append((Shard(0), Shard(0), Replicate(), Replicate(),
                         Shard(0)))
        else:
            plan.append((Replicate(),) * 5)
    x_pl, dc_pl, up_pl, down_pl, out_pl = (tuple(c) for c in zip(*plan))
    names = up + (down,)

    def moe(xt, dispatch, combine, *ws):
        xe = torch.einsum("gtd,gtec->egcd", xt, dispatch)
        ye = _expert_ffn(cfg, dict(zip(names, ws)), xe)
        return torch.einsum("egcd,gtec->gtd", ye, combine)

    return run_local(moe, mesh, (xt, dispatch, combine,
                                 *(params[k] for k in names)),
                     (x_pl, dc_pl, dc_pl) + (up_pl,) * len(up)
                     + (down_pl,), (out_pl,))


def _route(cfg: ArchConfig, logits: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k capacity routing of fp32 router ``logits`` (G, Tg, E).

    Returns ``dispatch`` (G, Tg, E, C) fp32 0/1 (each kept (token, expert)
    at its slot), ``combine`` (the same, times the token's gate for that
    expert) and the aux losses.  Each top-k pass takes the largest
    remaining gate (the first expert on ties, as ``jnp.argmax``), gives
    the token the next slot of that expert within its group (after the
    slots earlier passes used) and drops it past capacity C."""
    m = cfg.moe
    G, tg, E = logits.shape
    C = capacity(cfg, tg)
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)

    # aux losses on the full distribution
    me = probs.mean(dim=(0, 1))                                  # (E,)
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()

    experts = torch.arange(E, device=dev)
    slots = torch.arange(C, device=dev)
    dispatch = torch.zeros((G, tg, E, C), dtype=F32, device=dev)
    combine = torch.zeros((G, tg, E, C), dtype=F32, device=dev)
    gates_remaining = probs
    ce_accum = torch.zeros((E,), dtype=F32, device=dev)
    # cumulative slots already used per expert (from earlier choices)
    used = torch.zeros((G, E), dtype=torch.int64, device=dev)
    for _ in range(m.top_k):
        idx = torch.argmax(gates_remaining, dim=-1)              # (G,Tg)
        gate = torch.gather(gates_remaining, -1, idx[..., None])[..., 0]
        onehot = (idx[..., None] == experts).to(torch.int64)     # (G,Tg,E)
        ce_accum = ce_accum + onehot.sum(dim=(0, 1)).to(F32)
        pos = torch.cumsum(onehot, dim=1) - 1 + used[:, None, :]  # (G,Tg,E)
        slot = (pos * onehot).sum(dim=-1)                        # (G,Tg)
        keep = (slot < C).to(F32) * onehot.amax(dim=-1).to(F32)
        # A dropped token's slot is >= C: its row is all zeros (jax's
        # one_hot of an out-of-range index), built without F.one_hot,
        # which refuses such an index.
        slot_oh = (slot[..., None] == slots).to(F32) * keep[..., None]
        d_k = onehot.to(F32)[..., :, None] * slot_oh[..., None, :]
        dispatch = dispatch + d_k
        combine = combine + d_k * gate[..., None, None]
        used = used + (onehot * (pos < C)).sum(dim=1)
        gates_remaining = gates_remaining * (1.0 - onehot.to(F32))

    # load-balance loss: E * sum_e (frac tokens to e) * (mean prob of e)
    ce = ce_accum / float(G * tg * m.top_k)
    lb_loss = float(E) * (ce * me).sum()
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
           "moe_router_probs": me}
    return dispatch, combine, aux


def _repeat_experts(t: torch.Tensor, fac: int) -> torch.Tensor:
    """``torch.repeat_interleave(t, fac, dim=2)`` of a (G, Tg, E, C)
    tensor (expert e's slices become e*fac .. e*fac+fac-1), as a view
    expanded and copied once: no host sync."""
    G, tg, E, C = t.shape
    return t[:, :, :, None, :].expand(G, tg, E, fac, C).reshape(
        G, tg, E * fac, C)


def apply_moe(cfg: ArchConfig, params: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d), plus aux metrics/losses.  All B * S
    tokens route together: groups of ``group_size`` when they divide the
    count, else one group of them all (the reference's fallback)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    tg = min(m.group_size, T)
    if T % tg != 0:
        tg = T  # degenerate small-input fallback
    G = T // tg

    xt = x.reshape(G, tg, d)
    # Router matmul in the activation dtype, softmax in fp32.  The fp32
    # parity with the reference rests on fp32 products being full fp32:
    # TF32 stays off (torch's default for matmuls).
    logits = (xt @ params["router"].to(xt.dtype)).to(F32)
    dispatch, combine, aux = _route(cfg, logits)
    dispatch = dispatch.to(x.dtype)

    # virtual experts (E' = E * factor): each token is dispatched to every
    # f-slice of its expert; the combine contraction re-adds the slices.
    fac = virtual_expert_factor(cfg)
    if fac > 1:
        dispatch = _repeat_experts(dispatch, fac)
        combine = _repeat_experts(combine, fac)
    if isinstance(xt, DTensor):
        yt = _local_moe(cfg, params, xt, dispatch, combine.to(x.dtype))
    else:
        xe = torch.einsum("gtd,gtec->egcd", xt, dispatch)        # (E',G,C,d)
        xe = constrain_expert_parallel(xe)
        ye = _expert_ffn(cfg, params, xe)
        ye = constrain_expert_parallel(ye)
        yt = torch.einsum("egcd,gtec->gtd", ye,
                          combine.to(x.dtype))                    # (G,Tg,d)
    y = yt.reshape(B, S, d)

    if m.dense_residual:
        y = y + apply_mlp(cfg, params["residual"], x)
    return y, aux
