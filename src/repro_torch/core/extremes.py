"""Extreme-value aggregation (paper §VII-D, sketched as future work —
implemented here).

MAX/MIN with leverage-based per-block sampling rates:
 * each block records only its sampled extreme (O(1) state, like param_S/L);
 * block sampling rates are leverage-weighted by BOTH the local variance
   (dispersion => wider tails => sample more) and the block's general level
   (a high-mean block is more likely to hold the global max) — exactly the
   two signals §VII-D names;
 * the final answer is the max/min of the block extremes, with a
   Gumbel-style tail correction estimated from the pilot (beyond-paper:
   corrects the systematic underestimate of a sampled max).

blev_i ∝ (1 + sigma_i^2) * exp(zeta * (mu_i - mu_min) / spread)  — variance
leverage (paper §VII-C form) times a level tilt; normalized to sum 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from .engine import Sampler
from .types import IslaParams


@dataclasses.dataclass
class ExtremeResult:
    answer: float
    raw_extreme: float           # uncorrected sampled extreme
    block_extremes: List[float]
    rates: List[float]
    tail_correction: float


def block_rate_leverages(mus: Sequence[float], sigmas: Sequence[float],
                         zeta: float = 1.0, mode: str = "max") -> np.ndarray:
    """Sampling-rate leverages from local variance + general level."""
    mu = np.asarray(mus, dtype=np.float64)
    s2 = np.asarray(sigmas, dtype=np.float64) ** 2
    level = mu if mode == "max" else -mu
    spread = float(np.ptp(level)) or 1.0
    tilt = np.exp(zeta * (level - level.min()) / spread)
    lev = (1.0 + s2) * tilt
    return lev / lev.sum()


def aggregate_extreme(block_samplers: Sequence[Sampler],
                      block_sizes: Sequence[int],
                      params: IslaParams,
                      rng: np.random.Generator,
                      mode: str = "max",
                      total_samples: int = 100_000,
                      pilot_per_block: int = 256,
                      zeta: float = 1.0) -> ExtremeResult:
    """Approximate MAX/MIN with leverage-weighted block sampling.

    The tail correction uses the pilot's top-k spacings (Hill-style): for a
    sample of size m from a distribution with exponential-ish tail, the
    expected gap between the sampled max and the true block max scales with
    the mean top-spacing times log(N/m); estimated per pooled pilot.
    """
    b = len(block_samplers)
    sign = 1.0 if mode == "max" else -1.0

    # pilot: per-block mu/sigma + pooled tail shape
    mus, sigmas, pools = [], [], []
    for sampler in block_samplers:
        v = sign * np.asarray(sampler(pilot_per_block, rng), dtype=np.float64)
        mus.append(float(np.mean(v)))
        sigmas.append(float(np.std(v, ddof=1)))
        pools.append(v)
    pooled = np.sort(np.concatenate(pools))
    k = max(8, pooled.size // 50)
    top = pooled[-k:]
    # mean spacing in the top tail ~ tail scale
    tail_scale = float(np.mean(np.diff(top))) if k > 1 else 0.0

    lev = block_rate_leverages(mus, sigmas, zeta=zeta, mode="max")
    extremes, rates = [], []
    M = float(sum(block_sizes))
    for j, (sampler, bs) in enumerate(zip(block_samplers, block_sizes)):
        m_j = max(1, int(round(total_samples * float(lev[j]))))
        rates.append(m_j / bs)
        v = sign * np.asarray(sampler(m_j, rng), dtype=np.float64)
        extremes.append(float(np.max(v)))
    raw = max(extremes)
    # expected shortfall of a size-m sample max vs the size-N population max
    # for an exponential tail: scale * ln(N/m)
    m_eff = total_samples
    corr = tail_scale * math.log(max(M / max(m_eff, 1), 1.0)) \
        if tail_scale > 0 else 0.0
    answer = sign * (raw + corr)
    return ExtremeResult(answer=answer, raw_extreme=sign * raw,
                         block_extremes=[sign * e for e in extremes],
                         rates=rates, tail_correction=corr)
