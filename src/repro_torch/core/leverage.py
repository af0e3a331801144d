"""Leverage scores, normalization and re-weighted probabilities (paper §IV).

This module implements the *per-sample* definitions.  They are used by tests
and by the reference estimator; production paths never materialize
per-sample leverages — Theorem 3 (see ``estimator.py``) collapses everything
into region moments.

Definitions (paper §IV-A2/3, appendix A):
  deviation factor   h_i     = a_i^2 / (sum of squares of ALL S+L samples)
  leverage score     S data  : 1 - h_i
                     L data  :     h_i
  theoretical sums   levSum_S / levSum_L = q * u / v   and they sum to 1
                       =>  levSum_S = q*u / (q*u + v),  levSum_L = v / (q*u + v)
  normalization      fac_region = (sum of scores in region) / (theoretical sum)
  normalized lev     lev_i = score_i / fac_region
  probability        prob_i = alpha * lev_i + (1 - alpha) / (u + v)      (Eq. 2)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def deviation_factors(values: np.ndarray, total_square_sum: float) -> np.ndarray:
    v = np.asarray(values, dtype=np.float64)
    if total_square_sum <= 0:
        raise ValueError("total square sum must be positive (positive data)")
    return v * v / total_square_sum


def leverage_scores(xs: np.ndarray, ys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Raw (un-normalized) leverage scores for S samples ``xs`` and L samples
    ``ys``."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    t2 = float(np.sum(xs * xs) + np.sum(ys * ys))
    hx = deviation_factors(xs, t2)
    hy = deviation_factors(ys, t2)
    return 1.0 - hx, hy


def theoretical_sums(u: int, v: int, q: float) -> Tuple[float, float]:
    """Target leverage mass per region under Constraints 1+2 with allocator q."""
    if u <= 0 or v <= 0:
        raise ValueError(f"need samples in both regions, got u={u} v={v}")
    denom = q * u + v
    return q * u / denom, v / denom


def normalization_factors(xs: np.ndarray, ys: np.ndarray, q: float
                          ) -> Tuple[float, float]:
    """fac_x, fac_y — appendix A step 2.

    fac_x = (u + v/q) * (1 - sum(x^2) / (u * T2))
    fac_y = (q*u/v + 1) * (sum(y^2) / T2)
    """
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    u, v = len(xs), len(ys)
    sx2 = float(np.sum(xs * xs))
    sy2 = float(np.sum(ys * ys))
    t2 = sx2 + sy2
    fac_x = (u + v / q) * (1.0 - sx2 / (u * t2))
    fac_y = (q * u / v + 1.0) * (sy2 / t2)
    return fac_x, fac_y


def normalized_leverages(xs: np.ndarray, ys: np.ndarray, q: float
                         ) -> Tuple[np.ndarray, np.ndarray]:
    score_x, score_y = leverage_scores(xs, ys)
    fac_x, fac_y = normalization_factors(xs, ys, q)
    return score_x / fac_x, score_y / fac_y


def probabilities(xs: np.ndarray, ys: np.ndarray, q: float, alpha: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Eq. 2: prob_i = alpha * lev_i + (1 - alpha) * unif_i."""
    lev_x, lev_y = normalized_leverages(xs, ys, q)
    m = len(xs) + len(ys)
    unif = 1.0 / m
    return alpha * lev_x + (1.0 - alpha) * unif, alpha * lev_y + (1.0 - alpha) * unif
