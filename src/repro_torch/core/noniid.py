"""Non-i.i.d. extension (paper §VII-C): per-block boundaries + block leverages.

 * Block leverage: blev_i = (1 + sigma_i^2) / (b + sum_j sigma_j^2)
 * Block sampling rate: r_i = r * M * blev_i / |B_i|
 * Per-block pilot -> per-block sketch0_i, sigma_i -> per-block boundaries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from .boundaries import make_boundaries
from .engine import Sampler, run_block
from .preestimation import required_sample_size
from .summarize import summarize
from .types import AggregateResult, IslaParams


@dataclasses.dataclass
class BlockPilot:
    sketch0: float
    sigma: float
    shift: float


def block_leverages(sigmas: Sequence[float]) -> np.ndarray:
    """blev_i = (1 + sigma_i^2) / (b + sum sigma_j^2) — §VII-C.  Sums to 1."""
    s2 = np.asarray(sigmas, dtype=np.float64) ** 2
    b = s2.size
    return (1.0 + s2) / (b + float(np.sum(s2)))


def aggregate_noniid(block_samplers: Sequence[Sampler],
                     block_sizes: Sequence[int],
                     params: IslaParams,
                     rng: np.random.Generator,
                     pilot_per_block: int = 512,
                     rate_override: Optional[float] = None,
                     mode: str = "faithful") -> AggregateResult:
    """AVG aggregation over heterogeneous blocks.

    Each block gets its own pilot (sketch0_i, sigma_i, boundaries_i); the
    overall rate r comes from the pooled pilot sigma; per-block rates are
    r * M * blev_i / |B_i| so high-variance blocks are sampled more.
    """
    b = len(block_samplers)
    M = int(sum(block_sizes))
    pilots: List[BlockPilot] = []
    pooled = []
    for sampler in block_samplers:
        vals = np.asarray(sampler(pilot_per_block, rng), dtype=np.float64)
        pooled.append(vals)
        sigma_i = float(np.std(vals, ddof=1)) or 1e-9
        lo = float(np.min(vals))
        shift = (-lo + sigma_i) if lo <= 0 else 0.0
        pilots.append(BlockPilot(sketch0=float(np.mean(vals)), sigma=sigma_i,
                                 shift=shift))
    pooled_all = np.concatenate(pooled)
    sigma_overall = float(np.std(pooled_all, ddof=1)) or 1e-9
    if rate_override is not None:
        r = rate_override
    else:
        m = required_sample_size(params.e, sigma_overall, params.beta)
        r = min(1.0, m / M)

    blev = block_leverages([p.sigma for p in pilots])
    blocks = []
    for j, (sampler, bs, p) in enumerate(zip(block_samplers, block_sizes, pilots)):
        rate_j = min(1.0, r * M * float(blev[j]) / bs)
        shifted_sketch0 = p.sketch0 + p.shift
        boundaries_j = make_boundaries(shifted_sketch0, p.sigma, params)
        br = run_block(j, sampler, bs, rate_j, boundaries_j, shifted_sketch0,
                       params, rng, shift=p.shift, mode=mode)
        # un-shift this block's partial before summarization (shifts differ
        # per block in the non-iid world)
        br.avg = br.avg - p.shift
        blocks.append(br)

    answer = summarize([bl.avg for bl in blocks], list(block_sizes))
    return AggregateResult(
        answer=answer, sketch0=float(np.mean(pooled_all)), sigma=sigma_overall,
        sampling_rate=r, sample_size=int(math.ceil(r * M)), blocks=blocks,
        boundaries=make_boundaries(float(np.mean(pooled_all)), sigma_overall,
                                   params))
