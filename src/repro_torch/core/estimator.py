"""The l-estimator and Theorem 3's closed form mu_hat = f(alpha) = k*alpha + c.

Theorem 3 is the systems heart of the paper: k and c depend only on
(u, v, Sx, Sx2, Sx3, Sy, Sy2, Sy3) — the streaming region moments — so
 * no sample storage is required,
 * the estimate is invariant to sampling order,
 * blocks/devices exchange 8 numbers, not samples.

With  T2 = Sx2 + Sy2:
  term_S = (T2*Sx - Sx3) / ((1 + v/(q*u)) * (u*T2 - Sx2))
  term_L = v*Sy3 / ((q*u + v) * Sy2)
  c      = (Sx + Sy) / (u + v)                     # uniform S∪L average
  k      = term_S + term_L - c

(The paper's appendix prints ``c = (u+v)/(Sx+Sy)`` — an obvious typo; the
main-text Theorem 3 and Example 1/Table II use (Sx+Sy)/(u+v), which we
verified reproduces the paper's printed intermediate values exactly.)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .types import RegionMoments


def theorem3_kc(param_s: RegionMoments, param_l: RegionMoments, q: float
                ) -> Tuple[float, float]:
    """Closed-form (k, c) from region moments.  Host path: float64."""
    u = float(param_s.count)
    v = float(param_l.count)
    sx, sx2, sx3 = float(param_s.s1), float(param_s.s2), float(param_s.s3)
    sy, sy2, sy3 = float(param_l.s1), float(param_l.s2), float(param_l.s3)
    if u <= 0 or v <= 0:
        raise ValueError(f"Theorem 3 needs samples in S and L (u={u}, v={v})")
    t2 = sx2 + sy2
    if t2 <= 0 or sy2 <= 0:
        raise ValueError("square sums must be positive (positive data assumed)")
    denom_s = (1.0 + v / (q * u)) * (u * t2 - sx2)
    term_s = (t2 * sx - sx3) / denom_s
    term_l = v * sy3 / ((q * u + v) * sy2)
    c = (sx + sy) / (u + v)
    k = term_s + term_l - c
    return k, c


def theorem3_kc_batch(mom_s: np.ndarray, mom_l: np.ndarray, q: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized Theorem 3 over stacked blocks: (n, 4) S/L moment rows
    ``(count, s1, s2, s3)`` and per-block q -> per-block (k, c).

    The arithmetic mirrors ``theorem3_kc`` expression-for-expression so each
    lane is bit-identical to the scalar path (float64, same operation order).
    Lanes with an empty region or non-positive square sums produce garbage
    (inf/nan) instead of raising — callers mask them out, exactly like the
    torch path in ``distributed.py``.
    """
    mom_s = np.asarray(mom_s, dtype=np.float64)
    mom_l = np.asarray(mom_l, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    u, sx, sx2, sx3 = (mom_s[:, 0], mom_s[:, 1], mom_s[:, 2], mom_s[:, 3])
    v, sy, sy2, sy3 = (mom_l[:, 0], mom_l[:, 1], mom_l[:, 2], mom_l[:, 3])
    with np.errstate(divide="ignore", invalid="ignore"):
        t2 = sx2 + sy2
        denom_s = (1.0 + v / (q * u)) * (u * t2 - sx2)
        term_s = (t2 * sx - sx3) / denom_s
        term_l = v * sy3 / ((q * u + v) * sy2)
        c = (sx + sy) / (u + v)
        k = term_s + term_l - c
    return k, c


def l_estimator(alpha: float, k: float, c: float) -> float:
    """mu_hat = f(alpha) = k * alpha + c (Theorem 3)."""
    return k * alpha + c


def l_estimator_direct(xs, ys, q: float, alpha: float) -> float:
    """Per-sample reference: mu_hat = sum(prob_i * a_i) with Eq. 2
    probabilities.  Used by tests to pin Theorem 3 against §IV-B / appendix A
    step 5 — must equal ``l_estimator(alpha, *theorem3_kc(...))``."""
    from .leverage import probabilities

    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    px, py = probabilities(xs, ys, q, alpha)
    return float(np.sum(px * xs) + np.sum(py * ys))


def moments_from_values(values) -> RegionMoments:
    """Float64 host moments of a value array (one region)."""
    v = np.asarray(values, dtype=np.float64)
    return RegionMoments(
        count=float(v.size),
        s1=float(np.sum(v)),
        s2=float(np.sum(v * v)),
        s3=float(np.sum(v * v * v)),
    )
