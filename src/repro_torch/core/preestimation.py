"""Pre-estimation module (paper §III): sampling rate and sketch estimator.

m = u^2 * sigma^2 / e^2  (confidence-interval half-width e, z-score u)
r = m / M                                                        (Eq. 1)

sketch0 is generated the same way with a *relaxed* precision t_e * e, so it
carries the relaxed confidence interval (sketch0 - t_e*e, sketch0 + t_e*e).
Pilot samples are drawn per block proportionally to block size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from .types import IslaParams


def z_score(beta: float) -> float:
    """Two-sided normal z for confidence beta: Phi^{-1}((1+beta)/2).

    Uses the stdlib NormalDist (no scipy dependency in core).
    """
    if not (0.0 < beta < 1.0):
        raise ValueError(f"confidence must be in (0,1), got {beta}")
    from statistics import NormalDist
    return float(NormalDist().inv_cdf((1.0 + beta) / 2.0))


def required_sample_size(e: float, sigma: float, beta: float) -> int:
    """m = u^2 sigma^2 / e^2 (§III-A)."""
    if e <= 0:
        raise ValueError(f"precision must be positive, got {e}")
    u = z_score(beta)
    return max(1, int(math.ceil(u * u * sigma * sigma / (e * e))))


def sampling_rate(e: float, sigma: float, beta: float, data_size: int) -> float:
    """r = m / M (Eq. 1), clamped to (0, 1]."""
    m = required_sample_size(e, sigma, beta)
    return min(1.0, m / float(data_size))


@dataclasses.dataclass
class PilotResult:
    sketch0: float
    sigma: float
    pilot_size: int
    shift: float  # translation applied so all data are positive (footnote 1)
    values: Optional[np.ndarray] = None  # pilot sample (ISLA-E geometry fit)


def run_pilot(block_samplers: Sequence[Callable[[int, np.random.Generator], np.ndarray]],
              block_sizes: Sequence[int],
              params: IslaParams,
              rng: np.random.Generator,
              sigma_guess: Optional[float] = None,
              min_pilot: int = 64,
              stats_fn: Optional[Callable] = None) -> PilotResult:
    """Draw the pilot sample (per block, proportional to block size) and
    compute sigma-hat and sketch0 at relaxed precision t_e * e.

    ``block_samplers[j](n, rng)`` returns n uniform random samples from block
    j — the abstraction covers in-memory arrays, file blocks and synthetic
    streams alike.

    ``stats_fn`` optionally offloads the pilot's moment accumulation (e.g.
    to the CUDA device path, ``distributed.pilot_stats_device``): it takes
    the drawn pilot array and returns ``(sketch0, sigma, min)`` — or None
    to fall back to the host reduction.  The draw itself always stays on
    the host RNG so sampling streams are backend-independent.
    """
    total = float(sum(block_sizes))
    # Bootstrap: if no sigma guess, draw a fixed small pilot to estimate it.
    if sigma_guess is None:
        boot = np.concatenate([
            np.asarray(s(max(min_pilot, 1), rng), dtype=np.float64)
            for s in block_samplers])
        sigma_guess = float(np.std(boot))
        if sigma_guess <= 0:
            sigma_guess = 1e-9
    relaxed_e = params.te * params.e
    m0 = required_sample_size(relaxed_e, sigma_guess, params.beta)
    m0 = max(m0, min_pilot)
    vals = []
    for s, bs in zip(block_samplers, block_sizes):
        nj = max(1, int(round(m0 * bs / total)))
        vals.append(np.asarray(s(nj, rng), dtype=np.float64))
    pilot = np.concatenate(vals)
    stats = stats_fn(pilot) if stats_fn is not None else None
    if stats is not None:
        sketch0, sigma, lo = (float(x) for x in stats)
        if pilot.size <= 1:
            sigma = sigma_guess
    else:
        sketch0 = float(np.mean(pilot))
        sigma = (float(np.std(pilot, ddof=1)) if pilot.size > 1
                 else sigma_guess)
        lo = float(np.min(pilot))
    if sigma <= 0:
        sigma = 1e-9
    # Footnote 1: translate so all data are positive — ONLY when the pilot
    # actually sees non-positive values (shifting redistributes leverage
    # mass, so we never shift gratuitously: strictly-positive data like
    # exponential/salary keep the paper's exact geometry).  When shifting,
    # add a 1-sigma margin below the pilot minimum to guard later draws.
    shift = 0.0
    if lo <= 0.0:
        shift = -lo + 1.0 * sigma
    return PilotResult(sketch0=sketch0, sigma=sigma, pilot_size=int(pilot.size),
                       shift=shift, values=pilot)


def array_sampler(data: np.ndarray) -> Callable[[int, np.random.Generator], np.ndarray]:
    """Uniform-with-replacement sampler over an in-memory block."""
    data = np.asarray(data)

    def sample(n: int, rng: np.random.Generator) -> np.ndarray:
        idx = rng.integers(0, data.size, size=n)
        return data[idx]

    return sample


def distribution_sampler(draw: Callable[[int, np.random.Generator], np.ndarray]
                         ) -> Callable[[int, np.random.Generator], np.ndarray]:
    """Sampler over a synthetic 'infinite' block described by a distribution —
    how the paper's 10^10..10^16-row experiments are realized (uniform
    sampling from i.i.d. data == sampling the distribution)."""
    return draw
