"""Data boundaries (paper §IV-A1) and deviation degree / q selection (§IV-A4).

The boundaries divide the value axis into TS/S/N/L/TL using the *sketch
estimator* ``sketch0`` (not the true mean — that is the point: the later
iteration corrects sketch0's deviation) and the pilot sigma.

The ``*_batch`` variants are the host-side vectorized mirrors used by the
batched engine: same comparisons, same constants, elementwise over stacked
blocks, bit-identical per lane to the scalar versions.
"""
from __future__ import annotations

import numpy as np

from .types import Boundaries, IslaParams


def make_boundaries(sketch0: float, sigma: float, params: IslaParams) -> Boundaries:
    if sigma <= 0:
        raise ValueError(f"sigma must be positive, got {sigma}")
    if not (0.0 < params.p1 < params.p2):
        raise ValueError(f"need 0 < p1 < p2, got p1={params.p1} p2={params.p2}")
    return Boundaries(
        s_lo=sketch0 - params.p2 * sigma,
        s_hi=sketch0 - params.p1 * sigma,
        l_lo=sketch0 + params.p1 * sigma,
        l_hi=sketch0 + params.p2 * sigma,
    )


def deviation_degree(u: float, v: float) -> float:
    """dev = |S| / |L| (§IV-A4).  Guards v == 0 with +inf."""
    if v <= 0:
        return float("inf")
    return float(u) / float(v)


def choose_q(dev: float, params: IslaParams) -> float:
    """Leverage allocating parameter q (§IV-A4 + §VIII 'Parameters').

    - no obvious deviation                      -> q = 1
    - mild deviation  (dev in (0.94,0.97)∪(1.03,1.06)) -> q' = 5
    - strong deviation (beyond the mild band)    -> q' = 10
    and q = 1/q' when |S| > |L| (shrink the S leverage mass), q = q'
    otherwise.
    """
    lo_strong, lo_mild = params.mild_lo, 0.97
    hi_mild, hi_strong = 1.03, params.mild_hi
    if lo_mild <= dev <= hi_mild:
        return 1.0
    if (lo_strong <= dev < lo_mild) or (hi_mild < dev <= hi_strong):
        qp = params.q_mild
    else:
        qp = params.q_strong
    if dev > 1.0:  # |S| > |L|
        return 1.0 / qp
    return qp


def is_balanced(dev: float, params: IslaParams) -> bool:
    """Case 5 trigger (§V-C): |S| ≈ |L|."""
    return params.balanced_lo < dev < params.balanced_hi


def deviation_degree_batch(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Vectorized ``deviation_degree``: u/v with +inf where v == 0."""
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        dev = u / v
    return np.where(v > 0, dev, np.inf)


def choose_q_batch(dev: np.ndarray, params: IslaParams) -> np.ndarray:
    """Vectorized ``choose_q`` — identical thresholds and constants."""
    dev = np.asarray(dev, dtype=np.float64)
    lo_strong, lo_mild = params.mild_lo, 0.97
    hi_mild, hi_strong = 1.03, params.mild_hi
    mild = (((lo_strong <= dev) & (dev < lo_mild))
            | ((hi_mild < dev) & (dev <= hi_strong)))
    qp = np.where(mild, params.q_mild, params.q_strong)
    q = np.where(dev > 1.0, 1.0 / qp, qp)
    return np.where((lo_mild <= dev) & (dev <= hi_mild), 1.0, q)


def is_balanced_batch(dev: np.ndarray, params: IslaParams) -> np.ndarray:
    """Vectorized Case 5 trigger."""
    dev = np.asarray(dev, dtype=np.float64)
    return (params.balanced_lo < dev) & (dev < params.balanced_hi)
