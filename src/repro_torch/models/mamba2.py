"""Mamba2 mixer (SSD — state-space duality), chunked scan + decode step
(``repro.models.mamba2`` in torch).

Per block:
  in_proj -> [z | x | B | C | dt]     (gate, values, input/output maps, step)
  causal depthwise conv (width d_conv) over [x|B|C], silu
  dt = softplus(dt + dt_bias);  A = -exp(A_log)  (per head)
  y = SSD(x, dt*A, B, C) + D*x
  y = RMSNorm(y * silu(z));  out_proj

SSD chunked algorithm (chunk Q):
  da       = dt * A                       (B,S,H)
  cum      = intra-chunk cumsum of da
  Y_diag   = ((C_q . B_s) * exp(cum_q - cum_s) * dt_s)_{s<=q} x_s
  S_chunk  = sum_s B_s * exp(cum_Q - cum_s) * dt_s * x_s       (H,N,P)
  h_c      = h_{c-1} * exp(cum_Q) + S_chunk      (loop over chunks)
  Y_inter  = (C_q . h_{c-1}) * exp(cum_q)
A decode step is the same forward at S = 1 (one chunk of one token), so
it rounds as prefill does.

The reference computes all of it in plain jnp, outside any Pallas kernel,
so the port keeps plain torch ops and library matmuls.  Its contractions
run in fp32 (``preferred_element_type=float32`` in the reference): the
bf16 operands are upcast first, as products of bf16 values are exact in
fp32, and only ``w``, ``decay_to_end``, ``dt``, ``B``, ``C`` and the
final ``y`` are rounded to the input dtype, where the reference rounds
them.  Nothing reads a value back to the host.

The chunk contract is the reference's: a sequence longer than the chunk
must be a multiple of it, and a prefill must hold at least ``d_conv - 1``
tokens (the conv tail it leaves in the cache); both raise ``ValueError``.
The training forward (``apply_mamba_train``) is the same forward with no
state in and none kept, under the same chunk contract, differentiated by
autograd (the masked ``exp`` of ``_segsum_exp`` has a zero gradient where
it is masked, so no NaN).  ``ssd_reference`` is the O(S^2) oracle for
tests.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..sharding.context import (constrain_heads, head_plan, plan_placements,
                                run_local)
from .layers import normal, pdtype

Params = Dict[str, torch.Tensor]
F32 = torch.float32


def _mcfg(cfg: ArchConfig):
    assert cfg.mamba is not None
    return cfg.mamba


def init_mamba(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Projections are stored per component (z/x/B/C/dt and a conv per
    stream), as in the reference.  ``A_log``, ``D`` and ``dt_bias`` are
    fp32 whatever the param dtype."""
    m = _mcfg(cfg)
    d = cfg.d_model
    H, gn = m.n_heads, m.n_groups * m.d_state
    dt = pdtype(cfg)
    s = d ** -0.5
    dev = gen.device
    p: Params = {
        "wz": normal(gen, (d, m.d_inner), s, dt),
        "wx": normal(gen, (d, m.d_inner), s, dt),
        "wB": normal(gen, (d, gn), s, dt),
        "wC": normal(gen, (d, gn), s, dt),
        "wdt": normal(gen, (d, H), s, dt),
    }
    for name, width in (("x", m.d_inner), ("B", gn), ("C", gn)):
        p[f"conv_{name}_w"] = normal(gen, (m.d_conv, width), 0.2, dt)
        p[f"conv_{name}_b"] = torch.zeros((width,), dtype=dt, device=dev)
    p.update({
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=F32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=F32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=F32, device=dev),
        "norm_scale": torch.ones((m.d_inner,), dtype=dt, device=dev),
        "out_proj": normal(gen, (m.d_inner, d), m.d_inner ** -0.5, dt),
    })
    return p


def _causal_conv(w: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B,S,Cdim), w (K,Cdim)."""
    K, S = w.shape[0], x.shape[1]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pads[:, i:i + S, :] * w[i]
    return out + b


def _split_conv_state(cfg: ArchConfig, conv: torch.Tensor):
    """Cache keeps one concatenated (B, K-1, d_inner + 2GN) tail."""
    m = _mcfg(cfg)
    gn = m.n_groups * m.d_state
    return torch.split(conv, [m.d_inner, gn, gn], dim=-1)


def _segsum_exp(cum: torch.Tensor) -> torch.Tensor:
    """exp(cum_q - cum_s) masked to s <= q.  cum: (..., Q) -> (..., Q, Q).

    Masked BEFORE the exp: the upper-triangular differences are large and
    positive, and their exp would be inf."""
    diff = cum[..., :, None] - cum[..., None, :]
    Q = cum.shape[-1]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def _repeat_heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, rep, axis=dim)``: group g becomes heads
    g*rep .. g*rep+rep-1.  An int count expands a view (no host sync)."""
    return torch.repeat_interleave(t, rep, dim=dim)


def check_chunk(S: int, chunk: int) -> int:
    """The chunk length ``min(chunk, S)``; a longer sequence that is not a
    multiple of ``chunk`` raises, as the reference's assert refuses it."""
    Q = min(chunk, S)
    if S % Q != 0:
        raise ValueError(f"SSD: sequence length {S} is longer than the "
                         f"chunk {chunk} and not a multiple of it "
                         f"(S % min(chunk, S) must be 0)")
    return Q


def check_prefill(cfg: ArchConfig, S: int) -> None:
    """A prefill of ``S`` tokens meets the chunk contract and leaves a
    full conv tail (``S >= d_conv - 1``), or raises ``ValueError``."""
    m = _mcfg(cfg)
    check_chunk(S, m.chunk)
    if S < m.d_conv - 1:
        raise ValueError(f"{cfg.name}: a prefill of {S} tokens is shorter "
                         f"than the conv tail d_conv - 1 = {m.d_conv - 1} "
                         f"it must leave in the cache")


def ssd_chunked(x: torch.Tensor, da: torch.Tensor, dt: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.

    x: (B,S,H,P); da = dt*A: (B,S,H); dt: (B,S,H);
    Bm/Cm: (B,S,G,N) with H % G == 0; h0: (B,H,N,P) or None.
    Returns (y (B,S,H,P) in x's dtype, h_final (B,H,N,P) fp32).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = check_chunk(S, chunk)
    nc = S // Q
    rep = H // G

    # Intra-chunk operands in the input dtype, contracted in fp32;
    # cumsums, decays and state carries fp32.
    cdt = x.dtype
    xr = x.reshape(Bsz, nc, Q, H, P).to(F32)
    dar = da.reshape(Bsz, nc, Q, H).to(F32)
    dtr = dt.reshape(Bsz, nc, Q, H).to(cdt).to(F32)
    Br = _repeat_heads(Bm.reshape(Bsz, nc, Q, G, N).to(cdt), rep, 3).to(F32)
    Cr = _repeat_heads(Cm.reshape(Bsz, nc, Q, G, N).to(cdt), rep, 3).to(F32)

    cum = torch.cumsum(dar, dim=2)                             # (B,nc,Q,H)
    # ---- intra-chunk (diagonal blocks)
    Lmat = _segsum_exp(cum.movedim(-1, 2))                     # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhs,bckhs->bchqk", Cr, Br)
    w = (scores * Lmat).to(cdt).to(F32)                        # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", w, dtr, xr)

    # ---- chunk states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum).to(cdt).to(F32)
    s_chunk = torch.einsum("bcqhs,bcqh,bcqh,bcqhp->bchsp",
                           Br, decay_to_end, dtr, xr)          # (B,nc,H,N,P)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)

    # ---- inter-chunk recurrence (the reference's lax.scan)
    h = (torch.zeros((Bsz, H, N, P), dtype=F32, device=x.device)
         if h0 is None else h0.to(F32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                      # state BEFORE
        h = h * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                       # (B,nc,H,N,P)

    # ---- inter-chunk output
    y_inter = torch.einsum("bcqhs,bchsp,bcqh->bcqhp", Cr, h_prev,
                           torch.exp(cum))
    y = (y_diag + y_inter).reshape(Bsz, S, H, P)
    return y.to(x.dtype), h


def ssd_reference(x, da, dt, Bm, Cm) -> torch.Tensor:
    """Naive O(S^2) oracle (masked attention form) for tests."""
    Bsz, S, H, P = x.shape
    G = Bm.shape[2]
    rep = H // G
    # The oracle maps heads to groups on its own (not ``_repeat_heads``),
    # so it can catch a wrong map in the scan.
    Br = torch.repeat_interleave(Bm, rep, dim=2).to(F32)
    Cr = torch.repeat_interleave(Cm, rep, dim=2).to(F32)
    cum = torch.cumsum(da.to(F32), dim=1)                      # (B,S,H)
    diff = cum[:, :, None, :] - cum[:, None, :, :]             # (B,q,s,H)
    mask = torch.ones((S, S), dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    L = torch.exp(diff.masked_fill(~mask, float("-inf")))
    scores = torch.einsum("bqhn,bshn->bqsh", Cr, Br)
    w = scores * L
    return torch.einsum("bqsh,bsh,bshp->bqhp", w, dt.to(F32),
                        x.to(F32)).to(x.dtype)


def apply_mamba_train(cfg: ArchConfig, params: Params,
                      x: torch.Tensor) -> torch.Tensor:
    """Full-sequence mixer (training: no state in, none kept)."""
    y, _, _ = _mamba_forward(cfg, params, x, h0=None, conv0=None)
    return y


def _mamba_forward(cfg: ArchConfig, params: Params, x: torch.Tensor,
                   h0: Optional[torch.Tensor],
                   conv0: Optional[torch.Tensor]):
    """x (B,S,d) -> (out (B,S,d), h_final (B,H,N,P) fp32, new conv tail
    (B,K-1,conv_dim), or None for a prefill of fewer than K-1 tokens, as
    in the reference).  ``conv0`` (decode) is the cached conv tail."""
    m = _mcfg(cfg)
    z = x @ params["wz"]
    xs = x @ params["wx"]
    Bs = x @ params["wB"]
    Cs = x @ params["wC"]
    dth = x @ params["wdt"]
    if isinstance(xs, DTensor):
        # DTensor has no rule for the convs' pad nor the SSD's einsums
        # over split heads: the training mixer runs on each rank's own
        # batch rows and heads (the reference's constrain_heads layout)
        y, h_final, new_conv = _local_conv_ssd(cfg, params, xs, Bs, Cs, dth)
    else:
        y, h_final, new_conv = _conv_ssd(
            cfg, {k: params[k] for k in _CORE}, xs, Bs, Cs, dth, h0, conv0)
    # gated RMSNorm
    yf = y.to(F32) * F.silu(z.to(F32))
    ms = (yf * yf).mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(ms + 1e-6) * params["norm_scale"].to(F32)
    out = yf.to(x.dtype) @ params["out_proj"]
    return out, h_final, new_conv


# The params of the convs and the scan (``_conv_ssd``), and the dim of each
# that a head-parallel region splits (None: every head reads it whole).
_CORE = ("conv_x_w", "conv_x_b", "conv_B_w", "conv_B_b", "conv_C_w",
         "conv_C_b", "dt_bias", "A_log", "D")
_CORE_HEAD_DIM = {"conv_x_w": 1, "conv_x_b": 0, "dt_bias": 0, "A_log": 0,
                  "D": 0}
_CORE_GROUP_DIM = {"conv_B_w": 1, "conv_B_b": 0, "conv_C_w": 1,
                   "conv_C_b": 0}


def _local_conv_ssd(cfg: ArchConfig, params: Params, xs, Bs, Cs, dth):
    """``_conv_ssd`` of a training forward (no state in) on DTensors, run
    on this rank's batch rows and heads: (y, h_final, None) as DTensors.
    The B/C streams are split with the heads only where there are several
    groups (each group's heads together); one group is read whole."""
    m = _mcfg(cfg)
    groups = m.n_groups
    plan = head_plan(xs, 0, (m.n_heads,) + ((groups,) if groups > 1
                                              else ()))
    bc_dim = 2 if groups > 1 else None
    heads = plan_placements(plan, 0, 2)
    bc = plan_placements(plan, 0, bc_dim)
    pl = [plan_placements(plan, None, _CORE_HEAD_DIM.get(k) if
                          k in _CORE_HEAD_DIM else
                          (_CORE_GROUP_DIM[k] if groups > 1 else None))
          for k in _CORE]

    def core(xs, Bs, Cs, dth, *ps):
        y, h, _ = _conv_ssd(cfg, dict(zip(_CORE, ps)), xs, Bs, Cs, dth,
                            None, None)
        return y, h

    y, h = run_local(core, xs.device_mesh,
                     (xs, Bs, Cs, dth, *(params[k] for k in _CORE)),
                     (heads, bc, bc, heads, *pl),
                     (heads, plan_placements(plan, 0, 1)))
    return y, h, None


def _conv_ssd(cfg: ArchConfig, params: Params, xs, Bs, Cs, dth,
              h0: Optional[torch.Tensor], conv0: Optional[torch.Tensor]):
    """The projected streams (xs (B,S,H*P), Bs/Cs (B,S,G*N), dth (B,S,H))
    through the causal convs and the SSD scan: (y (B,S,H*P) with the D
    skip, h_final (B,H,N,P) fp32, the new conv tail).  Head and group
    counts are read off the streams, so a rank's own heads run alone."""
    m = _mcfg(cfg)
    Bsz, S, _ = xs.shape
    H = dth.shape[-1]
    P, N = m.head_dim, m.d_state
    G = Bs.shape[-1] // N

    def joined(tail, stream):  # jnp.concatenate's type promotion
        dt_ = torch.promote_types(tail.dtype, stream.dtype)
        return torch.cat([tail.to(dt_), stream.to(dt_)], dim=1)

    def conv(name, stream, tail):
        w, b = params[f"conv_{name}_w"], params[f"conv_{name}_b"]
        if tail is not None:  # decode: prepend conv state
            out = _causal_conv(w, b, joined(tail, stream))
            return out[:, tail.shape[1]:, :]
        return _causal_conv(w, b, stream)

    tails = (_split_conv_state(cfg, conv0) if conv0 is not None
             else (None, None, None))
    xc = conv("x", xs, tails[0])
    Bc = conv("B", Bs, tails[1])
    Cc = conv("C", Cs, tails[2])
    tail_len = m.d_conv - 1
    if conv0 is not None:
        new_conv = torch.cat([joined(t, s)[:, -tail_len:, :]
                              for t, s in zip(tails, (xs, Bs, Cs))], dim=-1)
    else:
        new_conv = (torch.cat([xs[:, -tail_len:, :], Bs[:, -tail_len:, :],
                               Cs[:, -tail_len:, :]], dim=-1)
                    if S >= tail_len else None)

    def silu(t):
        return F.silu(t.to(F32)).to(xs.dtype)

    xc, Bc, Cc = silu(xc), silu(Bc), silu(Cc)
    xh = constrain_heads(xc.reshape(Bsz, S, H, P), head_dim=2)
    Bm = Bc.reshape(Bsz, S, G, N)
    Cm = Cc.reshape(Bsz, S, G, N)
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-off.
    v = dth.to(F32) + params["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros((), dtype=F32, device=v.device))
    dt = constrain_heads(dt, head_dim=2)
    A = -torch.exp(params["A_log"])                            # (H,)
    da = dt * A
    y, h_final = ssd_chunked(xh, da, dt, Bm, Cm, m.chunk, h0=h0)
    y = y + xh.to(F32).to(y.dtype) \
        * params["D"].to(y.dtype)[None, None, :, None]
    return y.reshape(Bsz, S, H * P), h_final, new_conv


def mamba_state_shapes(cfg: ArchConfig, batch: int):
    m = _mcfg(cfg)
    G, N = m.n_groups, m.d_state
    conv_dim = m.d_inner + 2 * G * N
    return ((batch, m.n_heads, N, m.head_dim),           # h
            (batch, m.d_conv - 1, conv_dim))             # conv tail


def apply_mamba_decode(cfg: ArchConfig, params: Params, x: torch.Tensor,
                       h: torch.Tensor, conv: torch.Tensor):
    """One-token decode: x (B,1,d); h (B,H,N,P); conv (B,K-1,conv_dim)."""
    return _mamba_forward(cfg, params, x, h0=h, conv0=conv)
