"""The device half of ISLA in PyTorch: branchless Phase 2, the fused
serving tick and the device pilot.

This mirrors ``repro.core.distributed``.  Everything is branchless
(``torch.where`` over the modulation cases) and fp32-safe (values are
pre-scaled by a per-anchor normalizer; ISLA is exactly scale-equivariant).
The dense tick (``fused_tick_dense``: the fp32 serving form, and on a
float64 stack ``DeviceStack.tick(dense=...)``) folds its dense pane
through the hand-written CUDA kernel ``isla_fold`` on the card (its
float64 form for a float64 pane; its plain PyTorch version on the CPU),
one launch for every key of the stack
(``kernels.isla_moments.isla_fold_stack``), and a sketch stack's HLL
register merge through ``isla_sketch``, also one launch a tick
(``isla_sketch_stack``).  The tagged tick (``fused_tick``, the float64
exact mode, bit-identical to the host fold) folds its stream through
``isla_tagged_fold`` and merges registers through ``isla_sketch_tagged``.
Phase 2, the group statistics and the group fold of the registers are
plain tensor code, in the type of the state.

Where the JAX reference donates the resident state to a jitted launch and
gets successors back, these functions update the resident tensors IN
PLACE and return the same objects.

The mesh launches (``mesh_tick``, ``mesh_tick_dense``, ``mesh_solve`` and
their sketch forms) run the same single-device programs on each shard of
a cell mesh (``launch.mesh.CellMesh``: a tuple of devices driven by one
host program), and ``mesh_all_reduce`` is their one cross-device step.

The pipelined tick's plumbing lives here too: ``launch_pool``, the one
worker thread every pipelined chunk's uploads, launches and stat copy
run on; ``d2h_async``, a stat copy into a pinned host buffer behind a
CUDA event.  The stages' spans and wall clocks are ``trace.stage_trace``
and ``trace.book``.

The telemetry estimator (``isla_mean``, ``exact_mean`` and their pieces)
is the last section: the ISLA mean of a tensor, or of a tensor sharded
over a cell mesh, that crosses shards with O(1) floats; its Phase 1 is
one ``isla_fold`` launch a shard.
"""
from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.isla_moments import (MAX_KEYS, StackKey, TaggedRuns,
                                     isla_fold_stack, isla_sketch_stack,
                                     isla_sketch_tagged, isla_tagged_fold,
                                     pilot_moments)
from .types import IslaParams

F32 = torch.float32


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU.  A CUDA request without a card raises — the port never
    drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``like``'s type and device, made by a fill
    there (no upload): Phase 2 runs in the type of the moments it solves
    (fp32 serving, float64 exact)."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` correctly rounded on every device.  torch divides a CUDA
    tensor by a host scalar as a product with the scalar's reciprocal,
    which parts from the CPU's (and XLA's) quotient by an ulp in some
    cells; a 0-d divisor on ``x``'s device is divided by."""
    return x / (d if isinstance(d, torch.Tensor) else _const(d, x))


# ---------------------------------------------------------------------------
# Phase 1: classification + moments.
# ---------------------------------------------------------------------------


def region_masks(v: torch.Tensor, b: Tuple
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S and L masks per §IV-A1 (bounds as a (s_lo, s_hi, l_lo, l_hi)
    tuple)."""
    s_lo, s_hi, l_lo, l_hi = b
    return (v > s_lo) & (v < s_hi), (v > l_lo) & (v < l_hi)


def moments(values: torch.Tensor, bounds: Tuple, valid=None, prior=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked (count, s1, s2, s3) for S and L as two 4-vectors (fp32);
    ``prior`` is a previous round's ``(mom_s, mom_l)`` added on."""
    v = values.to(F32).reshape(-1)
    ms, ml = region_masks(v, bounds)
    if valid is not None:
        valid = valid.to(torch.bool).reshape(-1)
        ms, ml = ms & valid, ml & valid

    def mom(mask):
        m = mask.to(F32)
        vm = v * m
        return torch.stack([m.sum(), vm.sum(), (vm * v).sum(),
                            (vm * v * v).sum()])

    mom_s, mom_l = mom(ms), mom(ml)
    if prior is not None:
        prior_s, prior_l = prior
        mom_s = mom_s + torch.as_tensor(prior_s, dtype=F32, device=v.device)
        mom_l = mom_l + torch.as_tensor(prior_l, dtype=F32, device=v.device)
    return mom_s, mom_l


# ---------------------------------------------------------------------------
# Phase 2 pieces (branchless).
# ---------------------------------------------------------------------------


def choose_q(dev: torch.Tensor, params: IslaParams) -> torch.Tensor:
    """§IV-A4 q schedule as nested where."""
    mild = torch.where((dev >= params.mild_lo) & (dev <= params.mild_hi),
                       _const(params.q_mild, dev),
                       _const(params.q_strong, dev))
    qp = torch.where((dev >= 0.97) & (dev <= 1.03),
                     _const(1.0, dev), mild)
    return torch.where(dev > 1.0, 1.0 / qp, qp)


def theorem3_kc(mom_s: torch.Tensor, mom_l: torch.Tensor, q: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form (k, c) from moment vectors, (4,) or any (..., 4)
    stack; safe for u=0 / v=0 (the caller masks those out)."""
    u, sx, sx2, sx3 = (mom_s[..., 0], mom_s[..., 1], mom_s[..., 2],
                       mom_s[..., 3])
    v, sy, sy2, sy3 = (mom_l[..., 0], mom_l[..., 1], mom_l[..., 2],
                       mom_l[..., 3])
    eps = 1e-30
    t2 = sx2 + sy2
    denom_s = (1.0 + v / (q * u.clamp_min(1.0))) * (u * t2 - sx2)
    term_s = (t2 * sx - sx3) / denom_s.clamp_min(eps)
    term_l = v * sy3 / ((q * u + v) * sy2).clamp_min(eps)
    c = (sx + sy) / (u + v).clamp_min(1.0)
    k = term_s + term_l - c
    return k, c


def n_iterations(d0: torch.Tensor, thr, eta: float) -> torch.Tensor:
    ad = d0.abs()
    log_inv_eta = torch.log(_const(1.0 / eta, d0))
    return torch.ceil(torch.log(_div(ad, thr).clamp_min(1.0)) / log_inv_eta)


def _lambda_star(p1: float, p2: float) -> float:
    from .modulation import lambda_star
    return lambda_star(p1, p2)


def phase2(mom_s: torch.Tensor, mom_l: torch.Tensor, sketch0,
           params: IslaParams, mode: str = "calibrated",
           geometry=None, thr=None) -> torch.Tensor:
    """Branchless Phase 2 over one (4,) moment pair or any (..., 4) stack.

    mode="calibrated" — ISLA-C fixed point; "empirical" — ISLA-E with
    ``geometry=(kappa, b0)``; "faithful" — the §V-C case table.  Falls
    back to sketch0 when u or v is below ``min_region_count``, to c when
    k ~ 0.  ``thr`` optionally overrides ``params.thr`` per cell (cells at
    different anchor scales), and ``b0`` may be per cell too.
    """
    eta, lam = params.eta, params.lam
    thr = params.thr if thr is None else thr
    u, v = mom_s[..., 0], mom_l[..., 0]
    q = choose_q(u / v.clamp_min(1.0), params)
    k, c = theorem3_kc(mom_s, mom_l, q)
    d0 = c - sketch0
    t = n_iterations(d0, thr, eta)
    total_shrink = (1.0 - eta ** t) * d0.abs()

    if mode == "empirical":
        kappa, b0 = geometry
        c_adj = c - b0
        d0 = c_adj - sketch0
        t = n_iterations(d0, thr, eta)
        shrink = (1.0 - eta ** t) * d0.abs()
        avg = c_adj - _div(torch.sign(d0) * kappa * shrink, 1.0 + kappa)
        balanced = None
    elif mode == "calibrated":
        lam_c = _lambda_star(params.p1, params.p2)
        s_sk = _div(total_shrink, 1.0 + lam_c)
        mu_move = -torch.sign(d0) * lam_c * s_sk
        avg = c + mu_move
        balanced = None  # calibrated always modulates
    elif mode == "faithful":
        one = _const(1.0, k)
        sgn_k = torch.where(k >= 0, one, -one)
        case1 = (d0 < 0) & (u < v)
        case2 = (d0 < 0) & (u >= v)
        case3 = (d0 >= 0) & (u < v)
        mu_dom_move = torch.where(case1, _div(total_shrink, 1.0 - lam),
                                  _div(-total_shrink, 1.0 - lam))
        gain2 = 1.0 + sgn_k * lam
        gain3 = 1.0 - sgn_k * lam
        sk_dom_move = torch.where(case2,
                                  sgn_k * lam * total_shrink / gain2,
                                  sgn_k * lam * total_shrink / gain3)
        mu_move = torch.where(case2 | case3, sk_dom_move, mu_dom_move)
        avg = c + mu_move
        dev = u / v.clamp_min(1.0)
        balanced = (dev > params.balanced_lo) & (dev < params.balanced_hi)
    else:
        raise ValueError(f"unknown mode {mode}")

    sk = torch.as_tensor(sketch0, dtype=avg.dtype, device=avg.device)
    avg = torch.where(k.abs() < 1e-12, c, avg)
    if balanced is not None:
        avg = torch.where(balanced, sk, avg)
    return torch.where((u < params.min_region_count)
                       | (v < params.min_region_count), sk, avg)


# ---------------------------------------------------------------------------
# The device-resident tick: Phase 1 fold onto resident rows + Phase 2 +
# group statistics, the resident state updated in place.
# ---------------------------------------------------------------------------


def h2d(x, dtype=None, device="cuda") -> torch.Tensor:
    """The single sanctioned host->device upload of the serving path.
    Every array the steady-state tick ships to the device (fresh sample
    panes and their tags — never moments) goes through here, so tests can
    count crossings."""
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class D2HCopy:
    """A device->host copy in flight (``d2h_async``): ``wait`` returns the
    host tensor once the copy has landed."""

    __slots__ = ("_host", "_done")

    def __init__(self, host: torch.Tensor, done) -> None:
        self._host, self._done = host, done

    def wait(self) -> torch.Tensor:
        if self._done is not None:
            self._done.synchronize()
            self._done = None
        return self._host


def d2h_async(x: torch.Tensor) -> D2HCopy:
    """Start the device->host copy of ``x`` (a tick's O(groups) stat rows)
    without blocking, and return its handle.

    A CUDA tensor is copied into a fresh PINNED host buffer (a copy into
    pageable memory would be synchronous) with ``non_blocking=True`` on
    its device's current stream, the stream of the tick that wrote it,
    and an event is recorded after the copy: ``wait`` waits on that event
    alone, never on the whole device, so the work queued behind the copy
    keeps running.  The buffer belongs to the handle, and PyTorch's pinned
    memory cache hands a block out again only once the copies recorded
    on it have completed, so no buffer is reused before its event.  A CPU
    tensor is held as it is: the caller asked for the CPU, and there is
    nothing to overlap."""
    if x.device.type == "cpu":
        return D2HCopy(x, None)
    if x.device.type != "cuda":
        raise ValueError(f"d2h_async copies CUDA or CPU tensors, not "
                         f"{x.device}")
    stream = torch.cuda.current_stream(x.device)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    return D2HCopy(host, done)


_launch_pool: Optional[ThreadPoolExecutor] = None
_launch_pool_lock = threading.Lock()


def launch_pool() -> ThreadPoolExecutor:
    """The pipelined tick's one launch worker (built at first use, shared
    by the process).  It runs every chunk's pane build, uploads, launches
    and stat copy in submission order, the serial order, on its thread's
    current stream (the default stream, as the main thread's), while the
    main thread draws the next chunk's rows.  One worker for the process
    also keeps two ticks of one stack from running at once."""
    global _launch_pool
    with _launch_pool_lock:
        if _launch_pool is None:
            _launch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="isla-launch")
    return _launch_pool


def group_row_stats(mom_s: torch.Tensor, mom_l: torch.Tensor,
                    totals: torch.Tensor, partials: torch.Tensor,
                    n_sampled: torch.Tensor, sizes: torch.Tensor,
                    n_groups_list, min_region_count: float
                    ) -> torch.Tensor:
    """Per-group statistics rows, reduced on the device so the host never
    reads per-cell moments.  One row per (store, group); columns:

      0 n_g            matching samples
      1 w_g            estimated matching population (size * cnt / drawn)
      2 sum p*w        partials weighted by w
      3 sum ex2*w      per-cell E[x^2] weighted by w
      4 s1_g           plain sample sum
      5 s2_g           plain sample square sum
      6 degraded       #populated cells that hit the empty-region fallback
      7 sum ex2*size   catalog-weighted E[x^2] numerator (visited cells)
      8 sum size       catalog-weighted denominator (visited cells)

    Cells are (group, block)-contiguous per stacked store, so every
    reduction is a reshape-sum over the block axis.
    """
    cnt, s1, s2 = totals[:, 0], totals[:, 1], totals[:, 2]
    per_ex2 = s2 / cnt.clamp_min(1.0)
    visited = (cnt > 0).to(cnt.dtype)
    fallback = ((mom_s[:, 0] < min_region_count)
                | (mom_l[:, 0] < min_region_count)).to(cnt.dtype) * visited
    n_b = n_sampled.shape[0] // len(n_groups_list)
    out = []
    o = 0
    for k, g in enumerate(n_groups_list):
        sl = slice(o, o + g * n_b)
        shape = (g, n_b)
        drawn = n_sampled[k * n_b:(k + 1) * n_b][None, :]
        bsize = sizes[k * n_b:(k + 1) * n_b][None, :]
        cnt_k = cnt[sl].reshape(shape)
        w = bsize * cnt_k / drawn.clamp_min(1.0)
        ex2_k = per_ex2[sl].reshape(shape)
        vis_k = visited[sl].reshape(shape)
        out.append(torch.stack([
            cnt_k.sum(1), w.sum(1),
            (partials[sl].reshape(shape) * w).sum(1), (ex2_k * w).sum(1),
            s1[sl].reshape(shape).sum(1), s2[sl].reshape(shape).sum(1),
            fallback[sl].reshape(shape).sum(1),
            (ex2_k * bsize * vis_k).sum(1), (bsize * vis_k).sum(1),
        ], dim=1))
        o += g * n_b
    return torch.cat(out) if len(out) > 1 else out[0]


def _scaled_solve_args(params: IslaParams, geometry, inv_scale):
    """Per-cell Phase 2 stopping threshold and ISLA-E geometry: ``thr``
    and the empirical ``b0`` are absolute on the value axis, so cells
    normalized by their own anchor scale get them divided by it
    (``inv_scale`` is the per-cell 1/scale vector; None keeps the scalar
    params)."""
    if inv_scale is None:
        return params.thr, geometry
    thr = params.thr * inv_scale
    if geometry is not None:
        geometry = (geometry[0], geometry[1] * inv_scale)
    return thr, geometry


def stack_keys(n_b: int, n_groups_list, gid_slots, valid_slots,
               key_affine=None, bound_slots=None):
    """The dense tick's stacked keys, ``StackKey`` entries of the fold and
    register merge launches: key k's cells follow the keys before it
    (row ``offset = sum of n_groups * n_b`` before it, or that entry of the
    compacted map), it groups by its gid slot (ungrouped keys take none),
    masks with its predicate slot, reads the pane through ``key_affine[k]``
    (identity: none) and classifies against row ``bound_slots[k]``."""
    n_keys = len(n_groups_list)
    if key_affine is None:
        key_affine = ((1.0, 0.0),) * n_keys
    if bound_slots is None:
        bound_slots = (0,) * n_keys
    keys, o = [], 0
    for g, gslot, vslot, (ratio, off), brow in zip(
            n_groups_list, gid_slots, valid_slots, key_affine, bound_slots):
        keys.append(StackKey(
            n_groups=g, gid_slot=-1 if g == 1 else gslot, valid_slot=vslot,
            offset=o, affine=(None if ratio == 1.0 and off == 0.0
                              else (float(ratio), float(off))),
            bound_row=brow))
        o += g * n_b
    return keys


def fold_panes(mom_s: torch.Tensor, mom_l: torch.Tensor,
               totals: torch.Tensor, values2d: torch.Tensor,
               pad_valid: torch.Tensor, gid_panes, valid_panes,
               bounds: torch.Tensor, *, n_groups_list, gid_slots,
               valid_slots, key_affine=None, bound_slots=None,
               active_cells=None) -> None:
    """Phase 1 of the dense tick: one ``isla_fold_stack`` launch adds the
    (n_blocks, quota_max) sample pane into every stacked key's resident
    rows, in place, reading each sample once for all keys (a stack of more
    than ``MAX_KEYS`` keys takes a launch per ``MAX_KEYS``).  The pane,
    ``bounds`` and the rows share one dtype (fp32, or float64: the fold's
    float64 form); the masks are fp32.

    Key k reads the shared pane through its affine ``key_affine[k] =
    (ratio, offset)`` (its own anchor frame), classifies against row
    ``bound_slots[k]`` of ``bounds``, masks with ``pad_valid`` times its
    predicate pane ``valid_panes[valid_slots[k]]`` (-1: none) and groups by
    ``gid_panes[gid_slots[k]]`` (ungrouped keys take none).  With
    ``active_cells`` the panes cover only the active blocks and
    ``active_cells[0]`` maps each compacted (key, group, block) cell to
    its resident row; out-of-range pads drop.
    """
    keys = stack_keys(values2d.shape[0], n_groups_list, gid_slots,
                      valid_slots, key_affine, bound_slots)
    for i in range(0, len(keys), MAX_KEYS):
        isla_fold_stack(values2d, bounds.reshape(-1, 4), mom_s, mom_l,
                        totals, keys=keys[i:i + MAX_KEYS], pad=pad_valid,
                        gid_panes=gid_panes, valid_panes=valid_panes,
                        cell_idx=None if active_cells is None
                        else active_cells[0])


def _dense_core(mom_s: torch.Tensor, mom_l: torch.Tensor,
                totals: torch.Tensor, n_sampled: torch.Tensor,
                values2d: torch.Tensor, pad_valid: torch.Tensor,
                quotas: torch.Tensor, gid_panes, valid_panes,
                bounds: torch.Tensor, sketch0, sizes: torch.Tensor,
                inv_scale: Optional[torch.Tensor], *,
                params: IslaParams, mode: str, geometry,
                n_groups_list, gid_slots, valid_slots, key_affine,
                bound_slots, active_cells=None):
    """The dense tick body: ``fold_panes`` folds the (n_blocks,
    quota_max) sample pane into every key's resident rows in place (one
    ``isla_fold`` launch for the stack), then Phase 2 and the group stat rows
    run over the full state.

    ``active_cells = (cell_idx, ns_idx)`` is the zone-pruned compacted
    launch: the panes cover only the active blocks, ``cell_idx`` maps
    each compacted (key, group, block) cell to its resident row and
    ``ns_idx`` each compacted (key, block) quota to the draw ledger;
    out-of-range pads drop.  Pruned cells' rows are never addressed, so a
    predicate change re-activates them warm.
    """
    fold_panes(mom_s, mom_l, totals, values2d, pad_valid, gid_panes,
               valid_panes, bounds, n_groups_list=n_groups_list,
               gid_slots=gid_slots, valid_slots=valid_slots,
               key_affine=key_affine, bound_slots=bound_slots,
               active_cells=active_cells)
    n_keys = len(n_groups_list)
    q_all = quotas.repeat(n_keys)
    if active_cells is None:
        n_sampled += q_all
    else:
        ns_idx = active_cells[1].to(torch.int64)
        keep = (ns_idx >= 0) & (ns_idx < n_sampled.shape[0])
        # Pads add an exact 0 at row 0 (no boolean gather, no host sync).
        n_sampled.index_add_(0, torch.where(keep, ns_idx, 0),
                             torch.where(keep, q_all, 0.0))
    thr, geometry = _scaled_solve_args(params, geometry, inv_scale)
    partials = phase2(mom_s, mom_l, sketch0, params, mode=mode,
                      geometry=geometry, thr=thr)
    rows = group_row_stats(mom_s, mom_l, totals, partials, n_sampled,
                           sizes, n_groups_list,
                           float(params.min_region_count))
    return mom_s, mom_l, totals, n_sampled, partials, rows


def fused_tick_dense(mom_s: torch.Tensor, mom_l: torch.Tensor,
                     totals: torch.Tensor, n_sampled: torch.Tensor,
                     values2d: torch.Tensor, pad_valid: torch.Tensor,
                     quotas: torch.Tensor, gid_panes, valid_panes,
                     bounds: torch.Tensor, sketch0, sizes: torch.Tensor,
                     inv_scale: Optional[torch.Tensor] = None,
                     active_cells=None, *, params: IslaParams,
                     mode: str = "calibrated", geometry=None,
                     n_groups_list=(1,), gid_slots=(-1,),
                     valid_slots=(-1,), key_affine=None,
                     bound_slots=None):
    """One device-resident continuation round on the dense block-major
    layout (see ``_dense_core``).  The four state tensors are updated in
    place (the reference donates them); returns ``(mom_s, mom_l, totals,
    n_sampled, partials, rows)`` with ``rows`` per ``group_row_stats``.
    fp32 (the serving form) or float64; in float64 each cell's delta is
    summed, then added onto its row, as the reference's contraction and
    vector add are, so the state sits within 1e-12 of the host carry
    fold, not on it (``fused_tick`` is the bit-exact form)."""
    return _dense_core(mom_s, mom_l, totals, n_sampled, values2d,
                       pad_valid, quotas, gid_panes, valid_panes, bounds,
                       sketch0, sizes, inv_scale, params=params, mode=mode,
                       geometry=geometry, n_groups_list=n_groups_list,
                       gid_slots=gid_slots, valid_slots=valid_slots,
                       key_affine=key_affine, bound_slots=bound_slots,
                       active_cells=active_cells)


# ---------------------------------------------------------------------------
# The tagged tick: a stream of samples, each tagged with its stacked cell,
# folded onto the resident rows in stream order — the float64 exact mode
# (bit-identical to the host ``MomentStore`` fold) and ``layout="tagged"``.
# ---------------------------------------------------------------------------


def _sample_bounds(bounds: torch.Tensor) -> torch.Tensor:
    """Region cuts aligned with a tagged sample stream, as the table the
    fold reads: one broadcast row ((4,) or (1, 4): every cell shares the
    anchor) or a per-cell table ((n_cells + 1, 4), the per-key anchor
    path; the pad row, the drop segment's, holds +inf cuts).  The fold
    looks each cell's row up itself, where the reference gathers a row
    per sample."""
    return bounds.reshape(-1, 4).contiguous()


def _segment_carry_sum(mom_s: torch.Tensor, mom_l: torch.Tensor,
                       totals: torch.Tensor, values: torch.Tensor,
                       seg: torch.Tensor, bounds: torch.Tensor, *,
                       runs: Optional[TaggedRuns] = None) -> None:
    """The carry-prepend segmented sum of the tagged tick, in place: each
    cell's S and L region moments and plain totals continue from its
    resident row as the left fold ``((carry + a1) + a2) + ...`` over its
    samples in stream order — the host ``np.bincount`` carry's order
    (``engine._segment_moment_rows``), so a float64 store is bit-identical
    to the host fold.  One ``isla_tagged_fold`` launch (its plain version
    on the CPU), by the stream's (key, block) run table when ``runs``
    gives one; ids equal to ``n_cells`` (the drop segment) fold
    nowhere."""
    isla_tagged_fold(values, seg, _sample_bounds(bounds), mom_s, mom_l,
                     totals, runs=runs)


def _tick_core(mom_s: torch.Tensor, mom_l: torch.Tensor,
               totals: torch.Tensor, n_sampled: torch.Tensor,
               values: torch.Tensor, seg: torch.Tensor,
               quotas: torch.Tensor, bounds: torch.Tensor, sketch0,
               sizes: torch.Tensor, inv_scale: Optional[torch.Tensor], *,
               params: IslaParams, mode: str, geometry, n_groups_list,
               runs: Optional[TaggedRuns] = None):
    """The tagged tick body: the carry-prepend fold of the stream onto the
    resident rows (in place), the draw ledger, then Phase 2 and the group
    stat rows over the full state."""
    _segment_carry_sum(mom_s, mom_l, totals, values, seg, bounds, runs=runs)
    n_sampled += quotas.repeat(len(n_groups_list))
    thr, geometry = _scaled_solve_args(params, geometry, inv_scale)
    partials = phase2(mom_s, mom_l, sketch0, params, mode=mode,
                      geometry=geometry, thr=thr)
    rows = group_row_stats(mom_s, mom_l, totals, partials, n_sampled,
                           sizes, n_groups_list,
                           float(params.min_region_count))
    return mom_s, mom_l, totals, n_sampled, partials, rows


def fused_tick(mom_s: torch.Tensor, mom_l: torch.Tensor,
               totals: torch.Tensor, n_sampled: torch.Tensor,
               values: torch.Tensor, seg: torch.Tensor,
               quotas: torch.Tensor, bounds: torch.Tensor, sketch0,
               sizes: torch.Tensor, inv_scale: Optional[torch.Tensor] = None,
               *, params: IslaParams, mode: str = "calibrated",
               geometry=None, n_groups_list=(1,),
               runs: Optional[TaggedRuns] = None):
    """One device-resident continuation round on the tagged layout.

    ``values`` (m,) are the samples in each cell's own anchor frame
    (pre-scaled and shifted on the host), ``seg`` (m,) int32 their stacked
    cell ids (``n_cells`` is the drop segment), ``quotas`` the pass's
    per-block draws.  ``bounds`` is one broadcast row for a shared-anchor
    stack or a per-cell (+pad) table for per-key anchors; ``sketch0`` is
    per cell and ``inv_scale`` the per-cell anchor-scale vector the
    stopping threshold rides.  ``runs`` (optional ``TaggedRuns``) is the
    run table of a block-major stream, whose fold then needs no sort.
    The four state tensors are updated in place (the reference donates
    them); returns ``(mom_s, mom_l, totals, n_sampled, partials, rows)``
    with ``rows`` per ``group_row_stats``.  In float64 (scale 1.0) the
    state is the host fold's bit for bit."""
    return _tick_core(mom_s, mom_l, totals, n_sampled, values, seg, quotas,
                      bounds, sketch0, sizes, inv_scale, params=params,
                      mode=mode, geometry=geometry,
                      n_groups_list=n_groups_list, runs=runs)


def fused_solve(mom_s: torch.Tensor, mom_l: torch.Tensor,
                totals: torch.Tensor, n_sampled: torch.Tensor,
                sketch0, sizes: torch.Tensor,
                inv_scale: Optional[torch.Tensor] = None, *,
                params: IslaParams, mode: str = "calibrated",
                geometry=None, n_groups_list=(1,)):
    """The zero-draw tick: re-solve the resident moments without touching
    them (a warm repeat whose deficit is <= 0); no upload at all."""
    thr, geometry = _scaled_solve_args(params, geometry, inv_scale)
    partials = phase2(mom_s, mom_l, sketch0, params, mode=mode,
                      geometry=geometry, thr=thr)
    rows = group_row_stats(mom_s, mom_l, totals, partials, n_sampled,
                           sizes, n_groups_list,
                           float(params.min_region_count))
    return partials, rows


# ---------------------------------------------------------------------------
# Sketch-plane variants: the dense tick with a (n_cells, 4096) uint8 HLL
# register plane riding it.
# ---------------------------------------------------------------------------
#
# COUNT DISTINCT state is a per-cell HyperLogLog register row whose merge
# is an elementwise max — associative, commutative, idempotent — so any
# partition of a stream into ticks folds to the bit-identical one-pass
# plane.  The hash pane holds the bits of the RAW float64 measure values
# (one int64 per lane), block-major like the value pane; the
# ``isla_sketch`` kernel mixes and encodes them.  Dead lanes carry the
# neutral rho = 0 and compacted pads drop, so pruned cells' registers are
# never addressed and re-activate warm, exactly like the moment rows.


def sketch_panes(regs: torch.Tensor, bits2d: torch.Tensor,
                 pad_valid: torch.Tensor, gid_panes, valid_panes, *,
                 n_groups_list, gid_slots, valid_slots,
                 active_cells=None) -> None:
    """The dense register merge (the reference's
    ``_sketch_dense_scatter``): one ``isla_sketch_stack`` launch merges
    the (n_blocks, quota_max) int64 hash pane (the raw measure bits) into
    every stacked key's resident register rows, in place, hashing each
    live lane once (a launch per ``MAX_KEYS`` keys), masked and grouped
    as ``fold_panes`` masks and groups the value pane (same slots, same
    ``active_cells`` map)."""
    keys = stack_keys(bits2d.shape[0], n_groups_list, gid_slots,
                      valid_slots)
    for i in range(0, len(keys), MAX_KEYS):
        isla_sketch_stack(bits2d, regs, keys=keys[i:i + MAX_KEYS],
                          pad=pad_valid, gid_panes=gid_panes,
                          valid_panes=valid_panes,
                          cell_idx=None if active_cells is None
                          else active_cells[0])


def _sketch_fold(regs: torch.Tensor, n_groups_list) -> torch.Tensor:
    """Fold the (n_cells, 4096) register plane to one (store, group) row
    each — max over every store's block axis (the register analogue of
    ``group_row_stats``: the host reads O(groups) rows, never per-cell
    registers).  Cells are (group, block)-contiguous per stacked store,
    so the fold is a reshape-max."""
    n_b = regs.shape[0] // sum(n_groups_list)
    out = []
    o = 0
    for g in n_groups_list:
        out.append(regs[o:o + g * n_b].reshape(g, n_b, -1).amax(dim=1))
        o += g * n_b
    return torch.cat(out) if len(out) > 1 else out[0]


def fused_tick_sketch(mom_s: torch.Tensor, mom_l: torch.Tensor,
                      totals: torch.Tensor, n_sampled: torch.Tensor,
                      regs: torch.Tensor, values: torch.Tensor,
                      seg: torch.Tensor, bits: torch.Tensor,
                      quotas: torch.Tensor, bounds: torch.Tensor, sketch0,
                      sizes: torch.Tensor,
                      inv_scale: Optional[torch.Tensor] = None, *,
                      params: IslaParams, mode: str = "calibrated",
                      geometry=None, n_groups_list=(1,),
                      runs: Optional[TaggedRuns] = None):
    """``fused_tick`` with the register plane riding the tick: ``regs``
    is the fifth state tensor, updated in place; ``bits`` (m,) int64 are
    the samples' RAW float64 measure bits, aligned with ``values`` and
    ``seg`` (the reference ships them as (hi, lo) uint32 limbs), merged by
    one ``isla_sketch_tagged`` launch (drop-segment lanes drop).  Returns
    ``(mom_s, mom_l, totals, n_sampled, regs, partials, rows,
    group_regs)``."""
    mom_s, mom_l, totals, n_sampled, partials, rows = _tick_core(
        mom_s, mom_l, totals, n_sampled, values, seg, quotas, bounds,
        sketch0, sizes, inv_scale, params=params, mode=mode,
        geometry=geometry, n_groups_list=n_groups_list, runs=runs)
    isla_sketch_tagged(bits, seg, regs)
    return (mom_s, mom_l, totals, n_sampled, regs, partials, rows,
            _sketch_fold(regs, n_groups_list))


def fused_tick_dense_sketch(mom_s: torch.Tensor, mom_l: torch.Tensor,
                            totals: torch.Tensor, n_sampled: torch.Tensor,
                            regs: torch.Tensor, values2d: torch.Tensor,
                            pad_valid: torch.Tensor, bits2d: torch.Tensor,
                            quotas: torch.Tensor, gid_panes, valid_panes,
                            bounds: torch.Tensor,
                            sketch0, sizes: torch.Tensor,
                            inv_scale: Optional[torch.Tensor] = None,
                            active_cells=None, *, params: IslaParams,
                            mode: str = "calibrated", geometry=None,
                            n_groups_list=(1,), gid_slots=(-1,),
                            valid_slots=(-1,), key_affine=None,
                            bound_slots=None):
    """``fused_tick_dense`` with the register plane riding the tick: the
    five state tensors (``regs`` the (n_cells, 4096) uint8 plane) are
    updated in place; ``bits2d`` is the (n_blocks, quota_max) int64 pane
    of the RAW measure bits (the reference ships them as (hi, lo) uint32
    limb panes).  Returns ``(mom_s, mom_l, totals, n_sampled, regs,
    partials, rows, group_regs)`` — ``group_regs`` the folded per-group
    register rows, the only register bytes that are ever read back.  The
    register merge is an integer max, so the plane stays bit-exact even
    in fp32 serving."""
    mom_s, mom_l, totals, n_sampled, partials, rows = _dense_core(
        mom_s, mom_l, totals, n_sampled, values2d, pad_valid, quotas,
        gid_panes, valid_panes, bounds, sketch0, sizes, inv_scale,
        params=params, mode=mode, geometry=geometry,
        n_groups_list=n_groups_list, gid_slots=gid_slots,
        valid_slots=valid_slots, key_affine=key_affine,
        bound_slots=bound_slots, active_cells=active_cells)
    sketch_panes(regs, bits2d, pad_valid, gid_panes, valid_panes,
                 n_groups_list=n_groups_list, gid_slots=gid_slots,
                 valid_slots=valid_slots, active_cells=active_cells)
    return (mom_s, mom_l, totals, n_sampled, regs, partials, rows,
            _sketch_fold(regs, n_groups_list))


def fused_solve_sketch(mom_s: torch.Tensor, mom_l: torch.Tensor,
                       totals: torch.Tensor, n_sampled: torch.Tensor,
                       regs: torch.Tensor, sketch0, sizes: torch.Tensor,
                       inv_scale: Optional[torch.Tensor] = None, *,
                       params: IslaParams, mode: str = "calibrated",
                       geometry=None, n_groups_list=(1,)):
    """``fused_solve`` for sketch stacks: the zero-draw re-solve also
    re-folds the resident registers, so a warm repeat serves distinct
    answers from the same O(groups) readback."""
    partials, rows = fused_solve(
        mom_s, mom_l, totals, n_sampled, sketch0, sizes, inv_scale,
        params=params, mode=mode, geometry=geometry,
        n_groups_list=n_groups_list)
    return partials, rows, _sketch_fold(regs, n_groups_list)


# ---------------------------------------------------------------------------
# The mesh launches: the fused tick on every shard of the cell axis.
# ---------------------------------------------------------------------------
#
# Each shard of a ``MeshDeviceStack`` owns a contiguous run of blocks for
# EVERY (store, group), keeps those rows resident on its own device and
# runs the single-device program (``_tick_core`` / ``_dense_core`` /
# ``fused_solve`` and their sketch forms) on them, launching the same
# kernels there.  One host program drives every shard in turn (the
# reference's single-controller ``shard_map``), and the only cross-device
# step is ``mesh_all_reduce`` of the O(groups) stat rows: a sum, and on a
# sketch stack a max of the folded register rows.  ``group_row_stats``
# columns are plain sums over the block axis, so the shards' rows sum to
# the full table's rows up to float association; the float64 contract of
# the mesh covers the resident state and the per-cell partials.


def cell_axis(mesh) -> str:
    """Name of the (single) mesh axis the cell dimension shards over."""
    return mesh.axis_names[0]


def mesh_h2d(mesh, x, spec, dtype=None) -> "list[torch.Tensor]":
    """``h2d`` for the mesh: the sanctioned host->mesh upload, one ``h2d``
    a shard (counted where ``h2d`` is).  Returns a tensor a shard, on that
    shard's device.

    ``spec`` is the operand's placement (``sharding.specs.isla_cell_specs``):
    a split operand is cut on dim 0 into equal parts, one a shard, in
    shard order; a whole one is copied to every shard.  ``x`` may instead
    be a sequence of host arrays, one a shard: each shard's own part of a
    ragged operand (a tagged stream cut by shard)."""
    devs = mesh.devices
    if isinstance(x, (list, tuple)):
        if len(x) != len(devs):
            raise ValueError(f"{len(x)} parts for {len(devs)} shards")
        return [h2d(p, dtype, d) for p, d in zip(x, devs)]
    x = np.asarray(x)
    if not spec.split:
        return [h2d(x, dtype, d) for d in devs]
    n_s = len(devs)
    if x.shape[0] % n_s:
        raise ValueError(f"dim 0 of {x.shape} does not split into {n_s} "
                         f"shards")
    n = x.shape[0] // n_s
    return [h2d(x[s * n:(s + 1) * n], dtype, d) for s, d in enumerate(devs)]


# Open ``collective_footprint`` windows: each records every reduce.
_FOOTPRINTS: list = []


def mesh_all_reduce(mesh, parts: Sequence[torch.Tensor],
                    op: str = "sum") -> torch.Tensor:
    """The mesh tick's one cross-device step: the shards' row tensors
    (one a shard, each of one shape) reduced in shard order on the mesh's
    first device, ``op`` ``"sum"`` (stat rows) or ``"max"`` (folded
    register rows).  Counted in ``mesh_all_reduce.calls`` and
    ``.elements`` (the elements of one shard's rows, the size of the
    reference's ``psum`` operand), and recorded as ``(op, elements)`` in
    every open ``collective_footprint`` window."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown reduce {op!r}: use 'sum' or 'max'")
    if len(parts) != len(mesh.devices):
        raise ValueError(f"{len(parts)} parts for {len(mesh.devices)} "
                         f"shards")
    dev0 = mesh.devices[0]
    out = parts[0].to(dev0)
    for p in parts[1:]:
        p = p.to(dev0)
        out = out + p if op == "sum" else torch.maximum(out, p)
    n = int(out.numel())
    mesh_all_reduce.calls += 1
    mesh_all_reduce.elements += n
    for rec in _FOOTPRINTS:
        rec.append((op, n))
    return out


mesh_all_reduce.calls = 0
mesh_all_reduce.elements = 0


@contextlib.contextmanager
def collective_footprint():
    """A window over the mesh's cross-device steps: yields a list that
    gets one ``(op, elements)`` entry a ``mesh_all_reduce`` call made
    inside it.  The reference parses the compiled HLO for its
    collectives; here the reduce is the only cross-device step, so its
    record is the footprint.  The contract: every entry is O(groups)
    stat or register rows, never O(cells) state."""
    rec = []
    _FOOTPRINTS.append(rec)
    try:
        yield rec
    finally:
        for i, r in enumerate(_FOOTPRINTS):
            if r is rec:
                del _FOOTPRINTS[i]
                break


def _reduced(mesh, outs, sketch: bool):
    """Per-shard ``(..., partials, rows[, group_regs])`` outputs as
    ``(partials a shard, summed rows[, max of the folded register
    rows])``."""
    if sketch:
        return ([o[-3] for o in outs],
                mesh_all_reduce(mesh, [o[-2] for o in outs]),
                mesh_all_reduce(mesh, [o[-1] for o in outs], op="max"))
    return ([o[-2] for o in outs],
            mesh_all_reduce(mesh, [o[-1] for o in outs]))


def mesh_tick(mesh, state, values, seg, quotas, bounds, sketch0, sizes,
              inv_scale, *, params: IslaParams, mode: str = "calibrated",
              geometry=None, n_groups_list=(1,), runs=None):
    """The tagged tick on every shard: shard ``s`` runs ``fused_tick`` on
    its own rows.  ``state`` holds a ``(mom_s, mom_l, totals,
    n_sampled)`` tuple a shard, updated in place; every other operand is
    a list by shard (``seg``: each shard's LOCAL cell ids, its row count
    the drop segment; ``runs``: a ``TaggedRuns`` a shard, or None).
    Returns ``(partials a shard, rows)``, the rows summed across shards
    on the mesh's first device."""
    outs = [fused_tick(*state[s], values[s], seg[s], quotas[s], bounds[s],
                       sketch0[s], sizes[s], inv_scale[s], params=params,
                       mode=mode, geometry=geometry,
                       n_groups_list=n_groups_list,
                       runs=None if runs is None else runs[s])
            for s in range(len(mesh.devices))]
    return _reduced(mesh, outs, False)


def mesh_tick_sketch(mesh, state, regs, values, seg, bits, quotas, bounds,
                     sketch0, sizes, inv_scale, *, params: IslaParams,
                     mode: str = "calibrated", geometry=None,
                     n_groups_list=(1,), runs=None):
    """``mesh_tick`` with each shard's register plane (``regs``, a list by
    shard) merged in place by ``fused_tick_sketch``: per-cell registers
    never leave their shard; the folded O(groups) rows are max-reduced.
    Returns ``(partials a shard, rows, group_regs)``."""
    outs = [fused_tick_sketch(*state[s], regs[s], values[s], seg[s],
                              bits[s], quotas[s], bounds[s], sketch0[s],
                              sizes[s], inv_scale[s], params=params,
                              mode=mode, geometry=geometry,
                              n_groups_list=n_groups_list,
                              runs=None if runs is None else runs[s])
            for s in range(len(mesh.devices))]
    return _reduced(mesh, outs, True)


def mesh_tick_dense(mesh, state, values2d, pad_valid, quotas, gid_panes,
                    valid_panes, bounds, sketch0, sizes, inv_scale,
                    active_cells=None, *, params: IslaParams,
                    mode: str = "calibrated", geometry=None,
                    n_groups_list=(1,), gid_slots=(-1,), valid_slots=(-1,),
                    key_affine=None, bound_slots=None):
    """The dense tick on every shard: the block axis is the split axis,
    so shard ``s`` runs ``fused_tick_dense`` verbatim on its own rows of
    the panes (``gid_panes`` / ``valid_panes``: a tuple of panes a shard;
    ``active_cells``: a ``(cell_idx, ns_idx)`` pair a shard, each
    shard's LOCAL targets, or None).  Returns ``(partials a shard,
    rows)``."""
    outs = [fused_tick_dense(*state[s], values2d[s], pad_valid[s],
                             quotas[s], gid_panes[s], valid_panes[s],
                             bounds[s], sketch0[s], sizes[s], inv_scale[s],
                             None if active_cells is None
                             else active_cells[s], params=params,
                             mode=mode, geometry=geometry,
                             n_groups_list=n_groups_list,
                             gid_slots=gid_slots, valid_slots=valid_slots,
                             key_affine=key_affine, bound_slots=bound_slots)
            for s in range(len(mesh.devices))]
    return _reduced(mesh, outs, False)


def mesh_tick_dense_sketch(mesh, state, regs, values2d, pad_valid, bits2d,
                           quotas, gid_panes, valid_panes, bounds, sketch0,
                           sizes, inv_scale, active_cells=None, *,
                           params: IslaParams, mode: str = "calibrated",
                           geometry=None, n_groups_list=(1,),
                           gid_slots=(-1,), valid_slots=(-1,),
                           key_affine=None, bound_slots=None):
    """``mesh_tick_dense`` with each shard's register plane merged by
    ``fused_tick_dense_sketch`` from its rows of the hash pane.  Returns
    ``(partials a shard, rows, group_regs)``."""
    outs = [fused_tick_dense_sketch(
        *state[s], regs[s], values2d[s], pad_valid[s], bits2d[s],
        quotas[s], gid_panes[s], valid_panes[s], bounds[s], sketch0[s],
        sizes[s], inv_scale[s],
        None if active_cells is None else active_cells[s], params=params,
        mode=mode, geometry=geometry, n_groups_list=n_groups_list,
        gid_slots=gid_slots, valid_slots=valid_slots,
        key_affine=key_affine, bound_slots=bound_slots)
        for s in range(len(mesh.devices))]
    return _reduced(mesh, outs, True)


def mesh_solve(mesh, state, sketch0, sizes, inv_scale, *,
               params: IslaParams, mode: str = "calibrated", geometry=None,
               n_groups_list=(1,)):
    """The zero-draw re-solve on every shard (``fused_solve``); the
    resident shards are read, never written.  Returns ``(partials a
    shard, rows)``."""
    outs = [fused_solve(*state[s], sketch0[s], sizes[s], inv_scale[s],
                        params=params, mode=mode, geometry=geometry,
                        n_groups_list=n_groups_list)
            for s in range(len(mesh.devices))]
    return _reduced(mesh, outs, False)


def mesh_solve_sketch(mesh, state, regs, sketch0, sizes, inv_scale, *,
                      params: IslaParams, mode: str = "calibrated",
                      geometry=None, n_groups_list=(1,)):
    """``mesh_solve`` for sketch stacks: each shard also re-folds its
    resident registers (``fused_solve_sketch``).  Returns ``(partials a
    shard, rows, group_regs)``."""
    outs = [fused_solve_sketch(*state[s], regs[s], sketch0[s], sizes[s],
                               inv_scale[s], params=params, mode=mode,
                               geometry=geometry,
                               n_groups_list=n_groups_list)
            for s in range(len(mesh.devices))]
    return _reduced(mesh, outs, True)


# ---------------------------------------------------------------------------
# The device pilot.
# ---------------------------------------------------------------------------


def prescale_pilot(values) -> Tuple[np.ndarray, float]:
    """A host pilot array pre-scaled for fp32: ``(values / scale`` as
    fp32, ``scale)``, ``scale = max(max |value|, 1e-12)``, the division
    taken in float64 and rounded once (the reference's ``v / scale`` cast,
    bit for bit) with no float64 temporary.  An empty pilot raises."""
    v = np.asarray(values, dtype=np.float64).reshape(-1)
    if v.size == 0:
        raise ValueError("pilot must be non-empty")
    scale = float(max(v.max(), -v.min(), 1e-12))
    out = np.empty(v.shape, np.float32)
    np.divide(v, scale, out=out, casting="same_kind")
    return out, scale


def pilot_stats_device(values, device="cuda") -> Tuple[float, float, float]:
    """Pre-estimation statistics on the device: ``(sketch0, sigma, min)``
    of a host pilot array through the pilot kernel (``pilot_moments``;
    its plain version on the CPU) — ``run_pilot``'s ``stats_fn`` for
    ``route="device"``.

    fp32-safe by pre-scaling with the pilot's max |value| in float64 on
    the host (``prescale_pilot``; the three statistics are exactly
    scale-equivariant).  One upload of the pre-scaled fp32 pilot, one
    launch that reads each sample once and finishes (mean, sigma, min) on
    the device, one readback; the host multiplies by the scale.  sigma
    uses ddof=1 to match the host pilot.
    """
    dev = resolve_device(device)
    v32, scale = prescale_pilot(values)
    _, mean, _, lo, sigma = pilot_moments(h2d(v32, F32, dev)).tolist()
    return mean * scale, sigma * scale, lo * scale


# ---------------------------------------------------------------------------
# Telemetry: the ISLA mean of a (sharded) tensor, O(1) floats across shards.
#
# With a mesh (``launch.mesh.CellMesh``) every function takes a sequence
# with one tensor a shard, on that shard's device: the host program runs
# each shard's local steps, and ``_psum`` is each cross-device step (3
# floats for the pilot, 6 for the empirical geometry, then 8 for "merged"
# or 2 for "blocks"; 2 for ``exact_mean``).
# ---------------------------------------------------------------------------


def _strided(v: torch.Tensor, take: int, stride: int) -> torch.Tensor:
    """``jax.lax.slice(v, (0,), (take * stride,), (stride,))`` of a flat
    tensor, as fp32 (the cast after the selection: the same values)."""
    return v[:take * stride:stride].to(F32)


def local_pilot(values: torch.Tensor, pilot_size: int = 256
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cheap local sketch/sigma from a strided slice: ``(sum, sumsq, n)``
    as fp32 0-d tensors on the values' device."""
    v = values.reshape(-1)
    n = v.shape[0]
    take = min(pilot_size, n)
    stride = max(n // take, 1)
    pv = _strided(v, take, stride)
    return pv.sum(), (pv * pv).sum(), _const(float(pv.shape[0]), pv)


def _band_sums(v: torch.Tensor, sketch0: torch.Tensor, sigma: torch.Tensor,
               params: IslaParams) -> torch.Tensor:
    """The S∪L band's (sum, count) of ``v`` at the three centres
    ``(sketch0, sketch0 - h, sketch0 + h)``, ``h = sigma / 4``: (3, 2)."""
    h = 0.25 * sigma
    c = torch.stack([sketch0, sketch0 - h, sketch0 + h])[:, None]
    lo1, hi1 = c - params.p2 * sigma, c - params.p1 * sigma
    lo2, hi2 = c + params.p1 * sigma, c + params.p2 * sigma
    m = (((v > lo1) & (v < hi1)) | ((v > lo2) & (v < hi2))).to(F32)
    return torch.stack([(v * m).sum(-1), m.sum(-1)], -1)


def _band_geometry(sums: torch.Tensor, sketch0: torch.Tensor,
                   sigma: torch.Tensor, params: IslaParams):
    """``(kappa, b0)`` from the reduced (3, 2) band sums."""
    h = 0.25 * sigma
    centers = torch.stack([sketch0, sketch0 - h, sketch0 + h])
    means = sums[:, 0] / sums[:, 1].clamp_min(1.0)
    means = torch.where(sums[:, 1] > 0, means, centers)
    kappa_hat = ((means[1] - means[2]) / (2.0 * h)).clamp(-0.9, 0.9)
    b0_hat = means[0] - sketch0                      # sketch0 == pilot mean
    # Shrink toward the analytic normal prior (kappa*, b0=0) by pilot mass:
    # N0 ~ the pilot size at which measurement and prior weigh the same.
    w = sums[0, 1] / (sums[0, 1] + 1024.0)
    kappa = w * kappa_hat + (1.0 - w) * _lambda_star(params.p1, params.p2)
    return kappa, w * b0_hat


def pilot_band_geometry(pilot_vals, sketch0, sigma, params: IslaParams,
                        mesh=None):
    """Device-side ISLA-E geometry ``(kappa, b0)`` from the pilot slice.

    The S∪L band mean at three centres (sketch0, sketch0 -+ h), one
    broadcast (3, n) mask: a (3, 2) sum, reduced across shards (6 floats).
    b0 is the band-mean offset at delta=0 (the skew signal); kappa the
    central-difference slope (the Theorem-1 deviation ratio), both shrunk
    toward the normal prior by pilot mass.  With a mesh each argument is a
    sequence by shard, and so is the result."""
    if mesh is None:
        return _geometry([pilot_vals], [sketch0], [sigma], params, None)[0]
    return _geometry(pilot_vals, sketch0, sigma, params, mesh)


def _geometry(pvs, sks, sgs, params: IslaParams, mesh):
    sums = _psum([_band_sums(v.to(F32).reshape(-1), sk, sg, params)
                  for v, sk, sg in zip(pvs, sks, sgs)], mesh)
    return [_band_geometry(s, sk, sg, params)
            for s, sk, sg in zip(sums, sks, sgs)]


def _psum(x, mesh):
    """The cross-shard sum: ``x`` itself without a mesh; with one, ``x``
    is a sequence with a tensor a shard, summed by ``mesh_all_reduce`` on
    the mesh's first device, and the sum goes back to every shard's device
    (the broadcast half of the reference's all-reduce, not a second
    reduce): a list with a tensor a shard."""
    if mesh is None:
        return x
    out = mesh_all_reduce(mesh, x)
    return [out.to(d) for d in mesh.devices]


def subsample(values: torch.Tensor, rate: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform sample of ``max(1, round(n * rate))`` elements: strided
    without a generator (the reference's indices), else drawn with
    replacement by ``torch.randint`` from ``generator``, which must live on
    the values' device."""
    v = values.reshape(-1)
    n = v.shape[0]
    m = max(1, int(round(n * rate)))
    if generator is None:
        stride = max(n // m, 1)
        return v[:m * stride:stride]
    if generator.device.type != v.device.type or (
            v.device.type == "cuda"
            and generator.device.index not in (None, v.device.index)):
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"values on {v.device}")
    idx = torch.randint(0, n, (m,), generator=generator, device=v.device)
    return v[idx]


def _shards(values, generator, mesh):
    """``(values, generators)`` as lists with an entry a shard."""
    if mesh is None:
        return [values], [generator]
    if isinstance(values, torch.Tensor):
        raise ValueError("with a mesh, values is a sequence with a tensor "
                         "a shard")
    values = list(values)
    if len(values) != len(mesh.devices):
        raise ValueError(f"{len(values)} value shards for "
                         f"{len(mesh.devices)} mesh shards")
    for v, d in zip(values, mesh.devices):
        if v.device != d:
            raise ValueError(f"a shard's values are on {v.device}, its "
                             f"mesh device is {d}")
    if generator is None:
        return values, [None] * len(values)
    gens = list(generator) if isinstance(generator, (list, tuple)) else None
    if gens is None or len(gens) != len(values):
        raise ValueError("with a mesh, generator is a sequence of "
                         "generators, one on each shard's device")
    return values, gens


def isla_mean(values, params: IslaParams, mesh=None, rate: float = 0.05,
              generator=None, scale_hint: Optional[float] = None,
              semantics: str = "blocks", mode: str = "calibrated",
              pilot_size: int = 256) -> torch.Tensor:
    """Approximate mean of ``values`` (fp32 0-d tensor on the values'
    device; with a mesh, on its first device).

    Without a mesh ``values`` is one tensor; with one (``launch.mesh.
    CellMesh``) a sequence with a tensor a shard, on that shard's device,
    and ``generator`` (if any) a sequence with a generator a shard.
    Cross-shard traffic: 3 floats (pilot), 6 (empirical geometry), then 8
    (``"merged"``: one Phase 2 over the summed moments) or 2
    (``"blocks"``: each shard a block, its partial weighted by its
    sample count), whatever the tensor's size.  Phase 1 of the subsample
    is one ``isla_fold`` launch a shard on the card (``ops.isla_moments``).
    Nothing here reads a device value on the host.
    """
    if semantics not in ("blocks", "merged"):
        raise ValueError(f"unknown semantics {semantics}")
    shards, gens = _shards(values, generator, mesh)
    flats = [v.reshape(-1) for v in shards]

    # --- Pre-estimation (pilot): relaxed sketch0 + sigma, one 3-float sum.
    pilots = _psum([torch.stack(local_pilot(v, pilot_size))
                    for v in flats], mesh)
    sk, sg, scales, bounds = [], [], [], []
    for p in pilots:
        ps, pss, pn = p.unbind()
        sketch0 = ps / pn.clamp_min(1.0)
        sigma = torch.sqrt((pss / pn.clamp_min(1.0)
                            - sketch0 * sketch0).clamp_min(1e-12))
        # fp32 safety: scale so values are O(1) (exact equivariance).
        scale = (_const(scale_hint, p) if scale_hint is not None
                 else torch.maximum(sketch0.abs(), sigma)).clamp_min(1e-12)
        s, g = sketch0 / scale, sigma / scale
        sk.append(s)
        sg.append(g)
        scales.append(scale)
        bounds.append(torch.stack([s - params.p2 * g, s - params.p1 * g,
                                   s + params.p1 * g, s + params.p2 * g]))

    # --- ISLA-E geometry from the pilot slice (one 6-float sum).  The
    # division by the scale commutes with the selection.
    geometry = [None] * len(flats)
    if mode == "empirical":
        pvs = []
        for v, scale in zip(flats, scales):
            n_loc = v.shape[0]
            take = min(max(pilot_size, 2048), n_loc)
            pvs.append(_strided(v, take, max(n_loc // take, 1)) / scale)
        geometry = _geometry(pvs, sk, sg, params, mesh)

    # --- Phase 1 on the subsample: one fold launch a shard.
    samps = [subsample(v, rate, g).to(F32) / scale
             for v, g, scale in zip(flats, gens, scales)]
    moms = [ops.isla_moments(x, b) for x, b in zip(samps, bounds)]

    if semantics == "merged":
        mom = _psum([m.reshape(-1) for m in moms], mesh)[0]
        avg = phase2(mom[:4], mom[4:], sk[0], params, mode=mode,
                     geometry=geometry[0])
        return avg * scales[0]
    parts = []
    for m, x, s, geo in zip(moms, samps, sk, geometry):
        avg = phase2(m[0], m[1], s, params, mode=mode, geometry=geo)
        n_local = _const(float(x.shape[0]), avg)
        parts.append(torch.stack([avg * n_local, n_local]))
    acc = _psum(parts, mesh)[0]
    return (acc[0] / acc[1].clamp_min(1.0)) * scales[0]


def exact_mean(values, mesh=None) -> torch.Tensor:
    """The exact competitor: a full fp32 reduction a shard, then one
    2-float sum across shards (``values`` as in ``isla_mean``)."""
    shards, _ = _shards(values, None, mesh)
    parts = []
    for v in shards:
        s = v.sum(dtype=F32)
        parts.append(torch.stack([s, _const(float(v.numel()), s)]))
    acc = _psum(parts, mesh)[0]
    return acc[0] / acc[1]
