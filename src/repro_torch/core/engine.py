"""The ISLA block engine — Alg. 1 (sampling) + Alg. 2 (iteration) + the full
Pre-estimation -> Calculation -> Summarization pipeline (paper Fig. 2).

Host path: float64 numpy.  The device path lives in ``distributed.py`` and is
bit-validated against this one in tests.

Two execution engines share the pipeline:

 * ``engine="sequential"`` — the per-block scalar loop (``run_block`` per
   block), the bit-validated reference oracle.  Its Phase 2 logic is kept
   verbatim; Phase 1 routes through the same ``np.bincount`` accumulator as
   the batched path (stream order == Alg. 1's ``updateParams``) — that shared
   summation order is what makes the two engines bit-identical, at the cost
   of sequential-accumulation rounding (O(n*eps) vs pairwise O(log n * eps))
   on per-block moment sums.
 * ``engine="batched"`` (default) — Theorem 3 collapses each block to 8
   streaming moments, so n blocks stack into (n, 4)+(n, 4) arrays and both
   phases evaluate as one vectorized computation (``phase1_sampling_batch``
   + ``phase2_iteration_batch``).  Bit-identical to the sequential path per
   block (float64, same operation order; see ``modulation.n_iterations_batch``
   for the two libm-exactness details), ~an order of magnitude faster at
   1000+ blocks (see benchmarks/multiquery_bench.py).

Relational axis: Phase 1 is a segmented reduction, and the segment id is not
limited to the block index.  ``phase1_sampling_batch`` /
``sample_moments_batch`` accept per-sample ``group_ids`` (GROUP BY keys,
integer-coded) and a boolean predicate ``mask`` (WHERE clause); the segment
id becomes ``group * n_blocks + block`` (``flat_segments``), so a
(n_groups, n_blocks) moments axis flattens onto the exact batch dim every
vectorized stage — host Phase 2, the torch ``distributed.phase2``, and the
batched CUDA fold kernel — already handles.  Masked samples are dropped from
the stream *before* accumulation, so each (group, block) cell's moments are
bit-identical to running the scalar Alg. 1 over that cell's sub-stream in
stream order; ``repro_torch.core.multiquery`` builds grouped/predicated SQL-shaped
answers on top of this.

Memory: ``chunk_size`` (Phase 1) accumulates ``np.bincount`` over stream
prefixes with a carry that preserves the per-segment summation order
bit-for-bit, and ``chunk_blocks`` (sampling) draws + folds block chunks so
the tagged sample stream is never materialized whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from . import baselines
from .boundaries import (choose_q, choose_q_batch, deviation_degree,
                         deviation_degree_batch, make_boundaries)
from .estimator import theorem3_kc, theorem3_kc_batch
from .modulation import (CASE_BALANCED, ModulationBatchResult,
                         ModulationResult, empirical_geometry, run_modulation,
                         solve_calibrated, solve_calibrated_batch,
                         solve_closed_form, solve_closed_form_batch,
                         solve_empirical, solve_empirical_batch)
from .preestimation import (PilotResult, array_sampler, required_sample_size,
                            run_pilot, sampling_rate)
from .summarize import summarize
from .types import (AggregateResult, BlockResult, BlockResultsBatch,
                    Boundaries, IslaParams, Predicate, REGION_L, REGION_S,
                    RegionMoments, classify_np)

Sampler = Callable[[int, np.random.Generator], np.ndarray]

# |k| below this is "no leverage capability": f(alpha) cannot move, return c.
_K_EPS = 1e-12


def flat_segments(block_ids: np.ndarray, n_blocks: int,
                  group_ids: Optional[np.ndarray] = None,
                  n_groups: int = 1) -> Tuple[np.ndarray, int]:
    """Flatten a (group, block) tag pair onto one segment axis.

    segment id = ``group * n_blocks + block`` — groups are the slow axis, so
    a (n_groups * n_blocks, ...) stack reshapes to (n_groups, n_blocks, ...)
    with ``.reshape(n_groups, n_blocks, -1)``.  With ``group_ids=None`` the
    segment axis is the plain block axis (the pre-relational layout).
    """
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    if group_ids is None:
        if n_groups != 1:
            raise ValueError("n_groups > 1 requires per-sample group_ids")
        return block_ids, n_blocks
    group_ids = np.asarray(group_ids, dtype=np.intp).reshape(-1)
    if group_ids.shape != block_ids.shape:
        raise ValueError("group_ids and block_ids must align")
    if group_ids.size and (group_ids.min() < 0
                           or group_ids.max() >= n_groups):
        raise ValueError(
            f"group ids must lie in [0, {n_groups}); got range "
            f"[{group_ids.min()}, {group_ids.max()}]")
    return group_ids * n_blocks + block_ids, n_groups * n_blocks


def _tagged_segments(values: np.ndarray, block_ids: np.ndarray,
                     n_blocks: int, group_ids: Optional[np.ndarray],
                     n_groups: int, mask: Optional[np.ndarray]
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Shared tag plumbing of the segmented accumulators: align the stream
    with its (group, block) tags, flatten the segment axis, and drop
    masked-out samples (stream order preserved, so per-cell accumulation
    stays bit-identical to the scalar sweep)."""
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    block_ids = np.asarray(block_ids, dtype=np.intp).reshape(-1)
    if values.shape != block_ids.shape:
        raise ValueError("values and block_ids must align")
    seg_ids, n_segments = flat_segments(block_ids, n_blocks, group_ids,
                                        n_groups)
    if mask is not None:
        mask = np.asarray(mask, dtype=bool).reshape(-1)
        if mask.shape != values.shape:
            raise ValueError("mask and values must align")
        values, seg_ids = values[mask], seg_ids[mask]
    return values, seg_ids, n_segments


def _segment_moment_rows(values: np.ndarray, seg_ids: np.ndarray,
                         n_segments: int, boundaries: Boundaries,
                         carry: Optional[Tuple[np.ndarray, np.ndarray]] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Alg. 1 over a tagged stream: (n_segments, 4) moment rows
    ``(count, s1, s2, s3)`` for S and for L.

    ``np.bincount`` accumulates weights in stream order — exactly the
    sequential ``updateParams`` of Alg. 1 — which is what makes the scalar
    and batched engines bit-identical (both route through here).

    ``carry`` continues accumulation from previous (rows_s, rows_l): each
    segment's running total is prepended to the bincount input as a single
    weight, so the addition order is ``((carry + a1) + a2) + ...`` — the
    identical left fold a single whole-stream bincount performs.  That is
    what keeps chunked accumulation bit-for-bit equal to unchunked.
    """
    codes = classify_np(values, boundaries)

    def rows(region: int, prev: Optional[np.ndarray]) -> np.ndarray:
        m = codes == region
        ids = seg_ids[m]
        vals = values[m]
        # vals * vals * vals, not vals ** 3: numpy pow differs from repeated
        # multiplication by an ulp, and updateParams uses a * a * a.
        if prev is None:
            cnt = np.bincount(ids, minlength=n_segments).astype(np.float64)
            s1 = np.bincount(ids, weights=vals, minlength=n_segments)
            s2 = np.bincount(ids, weights=vals * vals, minlength=n_segments)
            s3 = np.bincount(ids, weights=vals * vals * vals,
                             minlength=n_segments)
            return np.stack([cnt, s1, s2, s3], axis=1)
        pre = np.arange(n_segments, dtype=np.intp)
        ids2 = np.concatenate([pre, ids])

        def acc(col: int, w: np.ndarray) -> np.ndarray:
            return np.bincount(ids2, weights=np.concatenate([prev[:, col], w]),
                               minlength=n_segments)

        cnt = acc(0, np.ones(vals.size, dtype=np.float64))
        s1 = acc(1, vals)
        s2 = acc(2, vals * vals)
        s3 = acc(3, vals * vals * vals)
        return np.stack([cnt, s1, s2, s3], axis=1)

    return (rows(REGION_S, None if carry is None else carry[0]),
            rows(REGION_L, None if carry is None else carry[1]))


def phase1_sampling(samples: np.ndarray, boundaries: Boundaries
                    ) -> Tuple[RegionMoments, RegionMoments]:
    """Alg. 1: classify samples, accumulate S/L moments, drop the samples.

    Vectorized host version of the scalar loop (single-block case of
    ``phase1_sampling_batch``); the CUDA fold kernel
    (``repro_torch.kernels.isla_moments``) implements the same contract on
    the GPU.
    """
    s = np.asarray(samples, dtype=np.float64).reshape(-1)
    rows_s, rows_l = _segment_moment_rows(
        s, np.zeros(s.size, dtype=np.intp), 1, boundaries)
    return (RegionMoments(*(float(x) for x in rows_s[0])),
            RegionMoments(*(float(x) for x in rows_l[0])))


def phase1_sampling_batch(values: np.ndarray, block_ids: np.ndarray,
                          n_blocks: int, boundaries: Boundaries, *,
                          group_ids: Optional[np.ndarray] = None,
                          n_groups: int = 1,
                          mask: Optional[np.ndarray] = None,
                          chunk_size: Optional[int] = None,
                          carry: Optional[Tuple[np.ndarray, np.ndarray]]
                          = None) -> Tuple[np.ndarray, np.ndarray]:
    """Alg. 1 over every (group, block) cell at once.

    ``values`` is the concatenation of every block's samples and
    ``block_ids`` tags each sample with its block.  Optionally each sample
    carries a ``group_ids`` tag (GROUP BY key, in [0, n_groups)) and a
    boolean ``mask`` (WHERE clause) — masked-out samples are dropped from
    the stream before accumulation.  Returns (n_groups * n_blocks, 4) S and
    L moment rows on the flattened ``flat_segments`` axis (plain
    (n_blocks, 4) when ungrouped).  Per cell bit-identical to running
    ``phase1_sampling`` over that cell's sub-stream in stream order.

    ``chunk_size`` accumulates over stream prefixes of at most that many
    samples (bit-identical to whole-stream accumulation — see
    ``_segment_moment_rows``'s carry contract), bounding the bincount
    working set for callers that stream huge tagged samples.

    ``carry`` continues accumulation from previous (rows_s, rows_l) — the
    online-mode round continuation (§VII-A): merging a fresh round into
    prior moments through the carry is bit-identical to having drawn one
    longer stream (``MomentStore`` builds on exactly this contract).
    """
    values, seg_ids, n_segments = _tagged_segments(
        values, block_ids, n_blocks, group_ids, n_groups, mask)
    if carry is not None:
        carry = (np.asarray(carry[0], dtype=np.float64),
                 np.asarray(carry[1], dtype=np.float64))
        if carry[0].shape != (n_segments, 4) \
                or carry[1].shape != (n_segments, 4):
            raise ValueError(
                f"carry rows must be ({n_segments}, 4), got "
                f"{carry[0].shape} and {carry[1].shape}")
    if chunk_size is None or values.size <= chunk_size:
        return _segment_moment_rows(values, seg_ids, n_segments, boundaries,
                                    carry=carry)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if carry is None:
        carry = (np.zeros((n_segments, 4)), np.zeros((n_segments, 4)))
    for start in range(0, values.size, chunk_size):
        sl = slice(start, start + chunk_size)
        carry = _segment_moment_rows(values[sl], seg_ids[sl], n_segments,
                                     boundaries, carry=carry)
    return carry


def sample_moments_batch(values: np.ndarray, block_ids: np.ndarray,
                         n_blocks: int, *,
                         group_ids: Optional[np.ndarray] = None,
                         n_groups: int = 1,
                         mask: Optional[np.ndarray] = None,
                         carry: Optional[np.ndarray] = None) -> np.ndarray:
    """(n_groups * n_blocks, 3) plain moments ``(count, s1, s2)`` of *all*
    stream samples per (group, block) cell (no region mask) — the extra
    accumulators VAR/COUNT estimators and per-group weights compose with the
    leverage-based mean (see ``multiquery``).  Same segment/mask contract as
    ``phase1_sampling_batch``; ``carry`` continues accumulation from prior
    (n_segments, 3) rows via the same carry-prepend bincount, so merged
    rounds stay bit-identical to one longer stream."""
    values, seg_ids, n_segments = _tagged_segments(
        values, block_ids, n_blocks, group_ids, n_groups, mask)
    if carry is None:
        cnt = np.bincount(seg_ids, minlength=n_segments).astype(np.float64)
        s1 = np.bincount(seg_ids, weights=values, minlength=n_segments)
        s2 = np.bincount(seg_ids, weights=values * values,
                         minlength=n_segments)
        return np.stack([cnt, s1, s2], axis=1)
    carry = np.asarray(carry, dtype=np.float64)
    if carry.shape != (n_segments, 3):
        raise ValueError(f"carry rows must be ({n_segments}, 3), got "
                         f"{carry.shape}")
    pre = np.arange(n_segments, dtype=np.intp)
    ids2 = np.concatenate([pre, seg_ids])

    def acc(col: int, w: np.ndarray) -> np.ndarray:
        return np.bincount(ids2, weights=np.concatenate([carry[:, col], w]),
                           minlength=n_segments)

    cnt = acc(0, np.ones(values.size, dtype=np.float64))
    s1 = acc(1, values)
    s2 = acc(2, values * values)
    return np.stack([cnt, s1, s2], axis=1)


_SOLVERS = {
    "faithful": run_modulation,        # Alg. 2 loop, §V-C case table verbatim
    "faithful_cf": solve_closed_form,  # same recursion, algebraic form
    "calibrated": solve_calibrated,    # beyond-paper: lambda* geometry (ISLA-C)
    # "empirical" (ISLA-E) needs the pilot geometry — handled explicitly.
}

# Every Phase 2 mode the pipeline accepts ("auto" resolves from pilot skew).
MODES = ("faithful", "faithful_cf", "calibrated", "empirical", "auto")


def phase2_iteration(param_s: RegionMoments, param_l: RegionMoments,
                     sketch0: float, params: IslaParams,
                     mode: str = "faithful",
                     geometry=None) -> ModulationResult:
    """Alg. 2: construct D, pick the modulation strategy, iterate to |D|<=thr.

    Falls back to sketch0 when a region is empty (Theorem 3 needs u,v > 0 —
    sketch0 still carries its relaxed confidence assurance) and to c when
    k ~= 0 (the l-estimator cannot move; c is the uniform S∪L answer).
    """
    u, v = float(param_s.count), float(param_l.count)
    if u < params.min_region_count or v < params.min_region_count:
        return ModulationResult(avg=sketch0, alpha=0.0, sketch=sketch0,
                                d=0.0, n_iter=0, case=CASE_BALANCED)
    dev = deviation_degree(u, v)
    q = choose_q(dev, params)
    k, c = theorem3_kc(param_s, param_l, q)
    if abs(k) < _K_EPS:
        return ModulationResult(avg=c, alpha=0.0, sketch=sketch0,
                                d=c - sketch0, n_iter=0, case=CASE_BALANCED)
    if mode == "empirical":
        if geometry is None:
            raise ValueError("mode='empirical' needs the pilot geometry")
        kappa, b0 = geometry
        return solve_empirical(k, c, sketch0, u, v, params, kappa, b0)
    return _SOLVERS[mode](k, c, sketch0, u, v, params)


_BATCH_SOLVERS = {
    "faithful": solve_closed_form_batch,     # Alg. 2 recursion, algebraic form
    "faithful_cf": solve_closed_form_batch,
    "calibrated": solve_calibrated_batch,
    # "empirical" needs the pilot geometry — handled explicitly.
}


def phase2_iteration_batch(mom_s: np.ndarray, mom_l: np.ndarray,
                           sketch0: float, params: IslaParams,
                           mode: str = "faithful",
                           geometry=None) -> ModulationBatchResult:
    """Alg. 2 over all blocks at once: (n, 4) S/L moment rows in, per-block
    modulation results out.

    Per block bit-identical to ``phase2_iteration`` for the closed-form
    modes ("faithful_cf", "calibrated", "empirical"), including the
    empty-region and k~=0 fallbacks.  mode="faithful" maps to the closed
    form — the batched engine never runs a data-dependent loop.  The loop
    and its algebraic evaluation agree to 1e-12 whenever the iteration
    count t = ceil(log_{1/eta}(|D0|/thr)) fits the loop's max_iter cap of
    200 (always true at the paper's eta=0.5; an eta pushed toward 1 can
    exceed it, where the loop stops early and only the closed form
    converges fully).
    """
    mom_s = np.asarray(mom_s, dtype=np.float64)
    mom_l = np.asarray(mom_l, dtype=np.float64)
    u, v = mom_s[:, 0], mom_l[:, 0]
    empty = (u < params.min_region_count) | (v < params.min_region_count)
    # Mirror the scalar theorem3_kc contract: lanes that pass the
    # min_region_count gate but violate Theorem 3's preconditions are a
    # caller bug, and the sequential engine raises — a silent NaN answer
    # must not differ.  Order matches the scalar checks (u/v first).
    degenerate = ~empty & ((u <= 0) | (v <= 0))  # min_region_count == 0
    if np.any(degenerate):
        raise ValueError("Theorem 3 needs samples in S and L; offending "
                         f"blocks: {np.nonzero(degenerate)[0].tolist()[:8]}")
    bad = ~empty & ((mom_s[:, 2] + mom_l[:, 2] <= 0) | (mom_l[:, 2] <= 0))
    if np.any(bad):
        raise ValueError("square sums must be positive (positive data "
                         f"assumed); offending blocks: "
                         f"{np.nonzero(bad)[0].tolist()[:8]}")
    dev = deviation_degree_batch(u, v)
    q = choose_q_batch(dev, params)
    k, c = theorem3_kc_batch(mom_s, mom_l, q)  # garbage on empty lanes

    if mode == "empirical":
        if geometry is None:
            raise ValueError("mode='empirical' needs the pilot geometry")
        kappa, b0 = geometry
        res = solve_empirical_batch(k, c, sketch0, u, v, params, kappa, b0)
    else:
        res = _BATCH_SOLVERS[mode](k, c, sketch0, u, v, params)

    sk0 = np.broadcast_to(np.asarray(sketch0, dtype=np.float64), k.shape)
    # k ~= 0: the l-estimator cannot move; c is the uniform S∪L answer.
    knull = np.abs(k) < _K_EPS
    avg = np.where(knull, c, res.avg)
    alpha = np.where(knull, 0.0, res.alpha)
    sketch = np.where(knull, sk0, res.sketch)
    d = np.where(knull, c - sk0, res.d)
    n_iter = np.where(knull, 0.0, res.n_iter)
    case = np.where(knull, CASE_BALANCED, res.case)
    # Empty region: Theorem 3 needs u, v > 0 — fall back to sketch0 (checked
    # first in the scalar path, so it wins over the k guard here).
    avg = np.where(empty, sk0, avg)
    alpha = np.where(empty, 0.0, alpha)
    sketch = np.where(empty, sk0, sketch)
    d = np.where(empty, 0.0, d)
    n_iter = np.where(empty, 0.0, n_iter)
    case = np.where(empty, CASE_BALANCED, case)
    return ModulationBatchResult(avg=avg, alpha=alpha, sketch=sketch, d=d,
                                 n_iter=n_iter, case=case.astype(np.int64))


def sample_skew(values) -> float:
    """Standardized third moment of a sample, clamped to 0 when the slice
    is degenerate.

    The naive estimator divides by ``np.std(pv) + eps``; on a
    (near-)constant slice the measured spread is float64 rounding noise
    at the data's own magnitude, and dividing by it amplifies that noise
    into an arbitrary |skew| > 0.5 — flipping auto-mode to "empirical"
    on data that carries no shape information at all.  A slice whose
    spread is below ~1e-7 of its magnitude therefore reports skew 0
    (treated as symmetric -> "calibrated").
    """
    pv = np.asarray(values, dtype=np.float64).reshape(-1)
    if pv.size < 3:
        return 0.0
    mean = float(np.mean(pv))
    sd = float(np.std(pv))
    if sd <= 1e-7 * max(abs(mean), 1.0):
        return 0.0
    return float(np.mean(((pv - mean) / sd) ** 3))


# |skew| above this resolves mode="auto" to "empirical" (below: the
# analytic calibrated geometry is lowest-variance).  Shared by the global
# resolution here and the per-key resolution in the multi-query planner.
AUTO_SKEW_THRESHOLD = 0.5


def resolve_mode_and_geometry(pilot: PilotResult, params: IslaParams,
                              mode: str):
    """Shared pre-estimation tail: resolve mode="auto" from pilot skew
    (calibrated for near-symmetric data — the analytic geometry is
    lowest-variance — empirical for real skew) and fit the ISLA-E band
    geometry when empirical.  Used by ``aggregate`` and the multi-query
    executor so the heuristic lives in exactly one place."""
    shifted_sketch0 = pilot.sketch0 + pilot.shift
    if mode == "auto":
        skew = sample_skew(pilot.values)
        mode = "empirical" if abs(skew) > AUTO_SKEW_THRESHOLD \
            else "calibrated"
    geometry = None
    if mode == "empirical":
        geometry = empirical_geometry(pilot.values + pilot.shift,
                                      shifted_sketch0, pilot.sigma, params)
    return mode, geometry


def block_quotas(block_sizes: Sequence[int], rate,
                 max_samples: Optional[int] = None) -> "list[int]":
    """Per-block sample quotas — the same formula ``run_block`` applies.

    ``rate`` may be a scalar (the classic uniform plan) or a per-block
    array (the zone-map pruned plan): a block rated exactly ``<= 0`` is
    provably out of the plan and gets quota 0 — no draw, no RNG
    consumption — while every in-plan block keeps the scalar path's
    ``max(m, 1)`` floor bit-identically.
    """
    rates = np.asarray(rate, dtype=np.float64)
    per_block = rates.ndim > 0
    if per_block and rates.shape != (len(block_sizes),):
        raise ValueError(f"per-block rate must have shape "
                         f"({len(block_sizes)},), got {rates.shape}")
    quotas = []
    for j, bs in enumerate(block_sizes):
        r = float(rates[j]) if per_block else float(rates)
        if per_block and r <= 0.0:
            quotas.append(0)
            continue
        m = int(math.ceil(r * bs))
        if max_samples is not None:
            m = min(m, int(max_samples))
        quotas.append(max(m, 1))
    return quotas


def sample_blocks_batched(block_samplers: Sequence[Sampler],
                          block_sizes: Sequence[int], rate: float,
                          boundaries: Boundaries, rng: np.random.Generator,
                          shift: float = 0.0,
                          max_samples: Optional[int] = None,
                          chunk_blocks: Optional[int] = None
                          ) -> Tuple[Optional[np.ndarray],
                                     Optional[np.ndarray], np.ndarray,
                                     np.ndarray, np.ndarray]:
    """Sampling + Phase 1 for every block, stacked.

    Samples are drawn per block in block order — the identical RNG stream the
    sequential path consumes.  Returns ``(values, block_ids, mom_s, mom_l,
    quotas)``; callers pick the Phase 2 executor (host vectorized solvers,
    or the torch/device path in ``distributed.phase2``).

    Memory: by default the whole tagged stream is materialized at once (sum
    of quotas floats) — negligible at ISLA's Eq. 1 rates, but a deliberate
    departure from the sequential engine's O(one-block) profile.
    ``chunk_blocks`` restores it: blocks are drawn and folded into the
    moment rows ``chunk_blocks`` at a time and each chunk's samples are
    dropped immediately, so peak memory is one chunk's quota.  Block
    boundaries never split a segment, so chunked moments are bit-identical
    to unchunked; ``values``/``block_ids`` are returned as ``None`` (the
    stream no longer exists to hand back).
    """
    n = len(block_samplers)
    quotas = block_quotas(block_sizes, rate, max_samples)
    if chunk_blocks is None:
        raws = [np.asarray(sampler(m, rng), dtype=np.float64)
                for sampler, m in zip(block_samplers, quotas)]
        values = np.concatenate(raws) + shift if n else np.zeros(0)
        block_ids = np.repeat(np.arange(n, dtype=np.intp), quotas)
        mom_s, mom_l = phase1_sampling_batch(values, block_ids, n,
                                             boundaries)
        return values, block_ids, mom_s, mom_l, np.asarray(quotas,
                                                           dtype=np.int64)
    if chunk_blocks < 1:
        raise ValueError(f"chunk_blocks must be >= 1, got {chunk_blocks}")
    mom_s = np.zeros((n, 4))
    mom_l = np.zeros((n, 4))
    for start in range(0, n, chunk_blocks):
        end = min(start + chunk_blocks, n)
        raws = [np.asarray(block_samplers[j](quotas[j], rng),
                           dtype=np.float64) for j in range(start, end)]
        vals = np.concatenate(raws) + shift
        ids = np.repeat(np.arange(end - start, dtype=np.intp),
                        quotas[start:end])
        ms, ml = phase1_sampling_batch(vals, ids, end - start, boundaries)
        mom_s[start:end] = ms
        mom_l[start:end] = ml
    return None, None, mom_s, mom_l, np.asarray(quotas, dtype=np.int64)


def run_blocks_batched(block_samplers: Sequence[Sampler],
                       block_sizes: Sequence[int], rate: float,
                       boundaries: Boundaries, sketch0: float,
                       params: IslaParams, rng: np.random.Generator,
                       shift: float = 0.0,
                       max_samples: Optional[int] = None,
                       mode: str = "faithful", geometry=None,
                       chunk_blocks: Optional[int] = None
                       ) -> Tuple[BlockResultsBatch, Optional[np.ndarray],
                                  Optional[np.ndarray]]:
    """All blocks' partial answers as one stacked computation (both phases
    vectorized on the host).

    Returns ``(blocks, values, block_ids)``; the tagged sample stream is
    returned so multi-query executors can derive further estimators (VAR
    second moments, predicate COUNTs) from the same pass without
    re-sampling.  With ``chunk_blocks`` set the stream is folded away chunk
    by chunk (O(one-chunk) memory, bit-identical moments) and
    ``values``/``block_ids`` come back as ``None``.
    """
    values, block_ids, mom_s, mom_l, quotas = sample_blocks_batched(
        block_samplers, block_sizes, rate, boundaries, rng, shift=shift,
        max_samples=max_samples, chunk_blocks=chunk_blocks)
    res = phase2_iteration_batch(mom_s, mom_l, sketch0, params, mode=mode,
                                 geometry=geometry)
    blocks = BlockResultsBatch(
        avg=res.avg, alpha=res.alpha, sketch=res.sketch, case=res.case,
        n_iter=res.n_iter, mom_s=mom_s, mom_l=mom_l, n_sampled=quotas)
    return blocks, values, block_ids


def run_block(block_id: int, sampler: Sampler, block_size: int, rate: float,
              boundaries: Boundaries, sketch0: float, params: IslaParams,
              rng: np.random.Generator, shift: float = 0.0,
              carry: Optional[Tuple[RegionMoments, RegionMoments]] = None,
              max_samples: Optional[int] = None,
              mode: str = "faithful", geometry=None) -> BlockResult:
    """One block's partial answer.

    ``shift`` — footnote 1: data are translated by +shift before the math so
    everything is positive; the answer is translated back by the caller.
    ``carry`` — the online extension (§VII-A): previous (param_S, param_L) to
    merge with the new round's moments.
    ``max_samples`` — the time-constraint extension (§VII-F) / straggler
    mitigation: truncate this block's quota; moments are valid at any prefix.
    """
    m = block_quotas([block_size], rate, max_samples)[0]
    raw = np.asarray(sampler(m, rng), dtype=np.float64) + shift
    p_s, p_l = phase1_sampling(raw, boundaries)
    if carry is not None:
        p_s = carry[0].merge(p_s)
        p_l = carry[1].merge(p_l)
    mod = phase2_iteration(p_s, p_l, sketch0, params, mode=mode,
                           geometry=geometry)
    return BlockResult(
        block_id=block_id, avg=mod.avg, alpha=mod.alpha, sketch=mod.sketch,
        case=mod.case, n_iter=mod.n_iter, u=int(p_s.count), v=int(p_l.count),
        n_sampled=m, param_s=p_s, param_l=p_l)


@dataclasses.dataclass(frozen=True)
class IslaQuery:
    """SELECT <agg>(measure) [WHERE ...] [GROUP BY key] with precision=e
    (paper §II-B, extended to the BlinkDB-style relational workload).

    Frozen/hashable so planners can key shared work off
    ``(where, group_by)``.

    Parameters
    ----------
    e : float
        Precision target on the *mean* scale for every aggregate — a SUM
        answer therefore carries an absolute bound of ``M * e``.
    beta : float
        Confidence level of the ``(e, beta)`` claim, in (0, 1).
    agg : str
        One of ``"AVG"`` / ``"SUM"`` / ``"COUNT"`` / ``"VAR"`` — see
        ``repro_torch.core.multiquery`` for how non-AVG aggregates compose from
        the leverage-based mean and the shared block moments.  Plain
        unpredicated COUNT is exact from catalog metadata; under WHERE /
        GROUP BY it becomes an estimate with a normal-binomial bound.
    where : Predicate, optional
        WHERE clause evaluated on the sampled rows.  Each distinct
        predicate gets its own moment store and — when the matching pilot
        support allows — its own refined leverage anchor
        (``Anchor.refine_for_predicate``), so measure-correlated filters
        keep their S/L regions populated.
    group_by : str, optional
        Integer-coded column whose cardinality the executor knows
        (``group_domains``); the answer carries per-group rows.
    mode : str, optional
        Pins this query's Phase 2 solver (None = the executor default).
        The planner groups queries by RESOLVED mode and runs one shared
        sampling pass per mode-group.
    priority : float
        Tenant weight for budgeted scheduling, > 0 (default 1.0).  Under
        ``run(budget=...)`` the marginal-error waterfill treats a pass
        carrying priority ``w`` as if its error were ``w`` times larger,
        so higher-priority tenants drain their deficits first at equal
        error.  Priorities never change *what* is computed — values and
        bounds are priority-independent — only the per-tick sample split.

    Examples
    --------
    >>> q = IslaQuery(e=0.5, agg="AVG", where=Predicate(lo=100.0),
    ...               group_by="region")
    >>> q.where.describe()
    'value >= 100'
    """
    e: float = 0.1
    beta: float = 0.95
    agg: str = "AVG"
    where: Optional[Predicate] = None
    group_by: Optional[str] = None
    mode: Optional[str] = None
    priority: float = 1.0


def aggregate(block_samplers: Sequence[Sampler],
              block_sizes: Sequence[int],
              params: IslaParams,
              rng: np.random.Generator,
              rate_override: Optional[float] = None,
              sigma_guess: Optional[float] = None,
              mode: str = "faithful",
              deadline_samples: Optional[int] = None,
              engine: str = "batched",
              chunk_blocks: Optional[int] = None) -> AggregateResult:
    """Full pipeline: Pre-estimation -> Calculation -> Summarization.

    ``rate_override`` lets experiments set the sampling rate directly (e.g.
    Table III uses r/3).  ``deadline_samples`` caps every block's quota
    (time-constraint extension).  ``engine`` picks the Calculation executor:
    "batched" (default) stacks every block into one vectorized Phase 1 +
    Phase 2 evaluation; "sequential" is the per-block reference loop the
    batched path is bit-validated against (for the closed-form modes; the
    loop-based mode="faithful" maps onto its algebraic closed form when
    batched, which agrees to 1e-12).  ``chunk_blocks`` (batched engine
    only) folds the sample stream away that many blocks at a time —
    O(one-chunk) memory, bit-identical answers.
    """
    if len(block_samplers) != len(block_sizes):
        raise ValueError("one sampler per block required")
    if engine not in ("batched", "sequential"):
        raise ValueError(f"unknown engine {engine!r}")
    if chunk_blocks is not None and engine != "batched":
        raise ValueError("chunk_blocks applies to engine='batched' only")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    data_size = int(sum(block_sizes))

    # --- Pre-estimation: pilot -> sigma, sketch0, shift; rate from Eq. 1.
    pilot = run_pilot(block_samplers, block_sizes, params, rng,
                      sigma_guess=sigma_guess)
    rate = (rate_override if rate_override is not None
            else sampling_rate(params.e, pilot.sigma, params.beta, data_size))
    sample_size = max(1, int(math.ceil(rate * data_size)))

    shifted_sketch0 = pilot.sketch0 + pilot.shift
    boundaries = make_boundaries(shifted_sketch0, pilot.sigma, params)

    mode, geometry = resolve_mode_and_geometry(pilot, params, mode)

    # --- Calculation: Alg. 1 + Alg. 2, stacked or per block.
    if engine == "batched":
        blocks, _, _ = run_blocks_batched(
            block_samplers, block_sizes, rate, boundaries, shifted_sketch0,
            params, rng, shift=pilot.shift, max_samples=deadline_samples,
            mode=mode, geometry=geometry, chunk_blocks=chunk_blocks)
        partials = blocks.avg
    else:
        blocks = []
        for j, (sampler, bs) in enumerate(zip(block_samplers, block_sizes)):
            blocks.append(run_block(
                j, sampler, bs, rate, boundaries, shifted_sketch0, params,
                rng, shift=pilot.shift, max_samples=deadline_samples,
                mode=mode, geometry=geometry))
        partials = [b.avg for b in blocks]

    # --- Summarization: final = sum avg_j * |B_j| / M, then un-shift.
    answer = summarize(partials, list(block_sizes)) - pilot.shift
    return AggregateResult(
        answer=answer, sketch0=pilot.sketch0, sigma=pilot.sigma,
        sampling_rate=rate, sample_size=sample_size, blocks=blocks,
        boundaries=boundaries)


def aggregate_array(data: np.ndarray, n_blocks: int, params: IslaParams,
                    rng: np.random.Generator, **kw) -> AggregateResult:
    """Convenience: split an in-memory array into b equal blocks and run."""
    chunks = np.array_split(np.asarray(data, dtype=np.float64), n_blocks)
    samplers = [array_sampler(c) for c in chunks]
    sizes = [c.size for c in chunks]
    return aggregate(samplers, sizes, params, rng, **kw)


def baseline_sample(block_samplers: Sequence[Sampler],
                    block_sizes: Sequence[int], rate: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Uniform sample at the given rate, drawn per block proportionally —
    shared substrate for the US/MV/MVB baselines."""
    out = []
    for sampler, bs in zip(block_samplers, block_sizes):
        m = max(1, int(math.ceil(rate * bs)))
        out.append(np.asarray(sampler(m, rng), dtype=np.float64))
    return np.concatenate(out)
