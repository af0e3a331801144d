"""Iterative modulation of the two estimators (paper §V + Alg. 2).

State: (alpha, sketch, d) with d = D(alpha, sketch) = k*alpha + c - sketch.
Every round multiplies d by eta (=0.5): |Delta d| = (1-eta)*|d|, split between
the l-estimator move (k*delta_alpha) and the sketch move (delta_sketch) by the
step-length factor lambda — the *smaller* mover takes lambda x the larger one
(§V-D), with per-case directions and dominance (§V-C):

  Case 1: D0<0, |S|<|L|  (c < sketch0 < mu)    mu_hat ↑ dominant, sketch ↑
  Case 2: D0<0, |S|>|L|  (c, mu < sketch0)     sketch ↓ dominant, alpha ↑ slightly
  Case 3: D0>0, |S|<|L|  (c, mu > sketch0)     sketch ↑ dominant, alpha ↑ slightly
  Case 4: D0>0, |S|>|L|  (c > sketch0 > mu)    mu_hat ↓ dominant, sketch ↓
  Case 5: |S| ≈ |L|                            return sketch0 unchanged

In cases 1/4 the l-estimator is the dominant mover: delta_alpha carries
whatever sign makes k*delta_alpha point the required way (alpha may go
negative — §V-C Case 4 says so explicitly).  In cases 2/3 alpha is *increased*
("we slightly increase alpha for better answers"), so the mu_hat move
k*delta_alpha inherits sign(k); the sketch move dominates and the |k*dalpha| =
lambda * dsketch relation of §V-D ties their magnitudes.

Termination: |d| <= thr after t = ceil(log2(|D0|/thr)) rounds (§VI-B).

``iterate`` is the faithful Alg. 2 loop; ``solve_closed_form`` evaluates the
same recursion algebraically (geometric series) — tests assert they agree to
1e-12.  The closed form is what the jit/distributed path uses (no
data-dependent trip counts on device).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from .boundaries import is_balanced, is_balanced_batch, deviation_degree_batch
from .types import IslaParams

CASE_BALANCED = 5


def classify_case(d0: float, u: float, v: float, params: IslaParams) -> int:
    """Map (sign(D0), |S| vs |L|) to the modulation case (§V-C)."""
    dev = float("inf") if v == 0 else u / v
    if is_balanced(dev, params):
        return CASE_BALANCED
    if d0 < 0 and u < v:
        return 1
    if d0 < 0 and u >= v:
        return 2
    if d0 >= 0 and u < v:
        return 3
    return 4


@dataclasses.dataclass
class ModulationResult:
    avg: float
    alpha: float
    sketch: float
    d: float
    n_iter: int
    case: int


def _directions(case: int, k: float) -> Tuple[float, float, bool]:
    """Return (mu_hat direction, sketch direction, mu_dominant).

    Directions are the sign of the *applied* change of each estimator.
    In cases 2/3 the mu_hat direction is sign(k) because alpha strictly
    increases.
    """
    sk = 1.0 if k >= 0 else -1.0
    if case == 1:
        return +1.0, +1.0, True
    if case == 2:
        return sk, -1.0, False
    if case == 3:
        return sk, +1.0, False
    if case == 4:
        return -1.0, -1.0, True
    raise ValueError(f"no directions for case {case}")


def n_iterations(d0: float, thr: float, eta: float) -> int:
    """t = ceil(log_{1/eta}(|D0|/thr)); 0 if already converged."""
    ad = abs(d0)
    if ad <= thr or thr <= 0:
        return 0
    return int(math.ceil(math.log(ad / thr) / math.log(1.0 / eta)))


def run_modulation(k: float, c: float, sketch0: float, u: float, v: float,
                   params: IslaParams, max_iter: int = 200) -> ModulationResult:
    """Faithful Alg. 2 (python loop, float64)."""
    eta, lam, thr = params.eta, params.lam, params.thr
    d0 = c - sketch0
    case = classify_case(d0, u, v, params)
    if case == CASE_BALANCED:
        return ModulationResult(avg=sketch0, alpha=0.0, sketch=sketch0,
                                d=d0, n_iter=0, case=case)
    alpha, sketch, d = 0.0, sketch0, d0
    dir_mu, dir_sk, mu_dom = _directions(case, k)
    n = 0
    while abs(d) > thr and n < max_iter:
        shrink = (1.0 - eta) * abs(d)     # |Delta d| this round
        # Solve step magnitudes:  Delta d = dir_mu*s_mu - dir_sk*s_sk
        # with the lambda tie  min = lam * max  and dominance per case.
        if mu_dom:
            # s_mu dominant, s_sk = lam * s_mu.
            # cases 1/4: dir_mu == dir_sk -> |Delta d| = s_mu * (1 - lam).
            s_mu = shrink / (1.0 - lam)
            s_sk = lam * s_mu
        else:
            # s_sk dominant, s_mu = lam * s_sk.
            # Delta d = dir_mu*lam*s_sk - dir_sk*s_sk; the required sign of
            # Delta d is -sign(d).  Magnitude: |dir_mu*lam - dir_sk| * s_sk.
            gain = abs(dir_mu * lam - dir_sk)
            s_sk = shrink / gain
            s_mu = lam * s_sk
        d_alpha = (dir_mu * s_mu) / k if k != 0.0 else 0.0
        alpha = alpha + d_alpha
        sketch = sketch + dir_sk * s_sk
        d = eta * d                        # by construction: d <- eta*d
        n += 1
    avg = k * alpha + c
    return ModulationResult(avg=avg, alpha=alpha, sketch=sketch, d=d,
                            n_iter=n, case=case)


def lambda_star(p1: float, p2: float) -> float:
    """Calibrated step-length factor (beyond-paper, from the paper's own
    Theorem 1).

    For normal data with S/L bands at (p1, p2) sigma around sketch0, a sketch
    deviation delta puts the uniform S∪L mean c on the *opposite* side of mu
    at distance kappa*delta, with

        kappa = [p1*phi(p1) - p2*phi(p2)] / [Phi(p2) - Phi(p1)]

    (first-order truncated-normal geometry; = 0.2381 for the paper's default
    p1=0.5, p2=2).  Theorem 1 says the unbiased step ratio is
    lambda = eps/(eps+eps') — i.e. exactly kappa — and the two estimators are
    in Fig. 1's *first* configuration (mu between them), so they must move
    toward each other.  See DESIGN.md §5 and EXPERIMENTS.md §Perf(algorithm).
    """
    phi = lambda z: math.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    Phi = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
    num = p1 * phi(p1) - p2 * phi(p2)
    den = Phi(p2) - Phi(p1)
    return num / den


def solve_calibrated(k: float, c: float, sketch0: float, u: float, v: float,
                     params: IslaParams) -> ModulationResult:
    """Calibrated modulation (ISLA-C): identical machinery — two estimators,
    iterative eta-contraction of D, alpha carries the l-estimator — but the
    directions follow the *measured* geometry (opposite sides, Fig. 1 case 1)
    and lambda = lambda_star(p1, p2).

    Fixed point: both estimators meet at  (c + kappa*sketch0) / (1 + kappa),
    reached as the t -> inf limit of the same geometric iteration; we evaluate
    the t = ceil(log2(|D0|/thr)) truncation like the faithful mode.
    """
    eta, thr = params.eta, params.thr
    lam = lambda_star(params.p1, params.p2)
    d0 = c - sketch0
    # Calibrated mode always modulates: even a balanced |S|/|L| leaves useful
    # information in c, and the kappa-weighted meeting point is unbiased for
    # any sketch deviation (including ~0).  The case id is kept for
    # diagnostics only.
    case = classify_case(d0, u, v, params)
    t = n_iterations(d0, thr, eta)
    total_shrink = (1.0 - eta ** t) * abs(d0)
    # mu_hat (the closer estimator, deviation kappa*delta) takes the lambda
    # share and moves TOWARD sketch; sketch takes the 1 share moving toward
    # mu_hat: |Delta d| per round = (1 + lam) * s_sk.
    s_sk_total = total_shrink / (1.0 + lam)
    s_mu_total = lam * s_sk_total
    sgn = 1.0 if d0 > 0 else -1.0      # mu_hat above sketch -> mu_hat moves down
    mu_move = -sgn * s_mu_total
    sketch = sketch0 + sgn * s_sk_total
    alpha = mu_move / k if k != 0.0 else 0.0
    avg = k * alpha + c
    return ModulationResult(avg=avg, alpha=alpha, sketch=sketch,
                            d=(eta ** t) * d0, n_iter=t, case=case)


def empirical_geometry(pilot_values, sketch0: float, sigma: float,
                       params: IslaParams):
    """(kappa_hat, b0): slope and offset of the S∪L band conditional mean,
    measured on the pilot's empirical distribution (beyond-paper, ISLA-E).

    Model: c(delta) = mu + b0 + kappa*delta for sketch0 = mu - delta.
    b0 captures skew (non-zero for exponential/lognormal data); kappa is the
    paper's Theorem-1 deviation ratio.  Estimated by evaluating the band
    mean at band centers sketch0 and sketch0 -+ h (central difference).
    """
    import numpy as np
    vals = np.asarray(pilot_values, dtype=np.float64)
    h = 0.25 * sigma

    def band_mean(center: float) -> float:
        lo1, hi1 = center - params.p2 * sigma, center - params.p1 * sigma
        lo2, hi2 = center + params.p1 * sigma, center + params.p2 * sigma
        m = ((vals > lo1) & (vals < hi1)) | ((vals > lo2) & (vals < hi2))
        if not np.any(m):
            return center
        return float(np.mean(vals[m]))

    c0 = band_mean(sketch0)
    # shifting the CENTER by -h == sketch error delta = +h
    c_minus = band_mean(sketch0 - h)
    c_plus = band_mean(sketch0 + h)
    kappa = (c_minus - c_plus) / (2.0 * h)
    kappa = max(min(kappa, 0.9), -0.9)
    mu_p = float(np.mean(vals))
    b0 = c0 - mu_p - kappa * (mu_p - sketch0)
    return kappa, b0


def solve_empirical(k: float, c: float, sketch0: float, u: float, v: float,
                    params: IslaParams, kappa: float, b0: float
                    ) -> ModulationResult:
    """ISLA-E: same two-estimator iteration, with the geometry (lambda = kappa,
    plus the skew offset b0) measured from the pilot.  Fixed point:
        mu = (c - b0 + kappa * sketch0) / (1 + kappa)
    reached by the same eta-contraction; evaluated in closed form."""
    eta, thr = params.eta, params.thr
    c_adj = c - b0
    d0 = c_adj - sketch0
    case = classify_case(d0, u, v, params)
    t = n_iterations(d0, thr, eta)
    shrink = (1.0 - eta ** t) * abs(d0)
    s_sk_total = shrink / (1.0 + kappa)
    s_mu_total = kappa * s_sk_total
    sgn = 1.0 if d0 > 0 else -1.0
    avg = c_adj - sgn * s_mu_total
    sketch = sketch0 + sgn * s_sk_total
    alpha = (avg - c) / k if k != 0.0 else 0.0
    return ModulationResult(avg=avg, alpha=alpha, sketch=sketch,
                            d=(eta ** t) * d0, n_iter=t, case=case)


# ---------------------------------------------------------------------------
# Vectorized (batched) solvers — the host mirror of the per-block scalar path,
# evaluated over stacked blocks as one array computation.  Each lane is
# bit-identical (float64) to the corresponding scalar solver: same expression
# order, and the two spots where numpy's SIMD transcendentals can drift an
# ulp from libm (log in the iteration count, pow in the eta-contraction) are
# routed through the exact scalar functions.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModulationBatchResult:
    """Struct-of-arrays ``ModulationResult`` over n blocks."""

    avg: np.ndarray
    alpha: np.ndarray
    sketch: np.ndarray
    d: np.ndarray
    n_iter: np.ndarray   # integral-valued float64
    case: np.ndarray     # int64

    def __len__(self) -> int:
        return self.avg.shape[0]

    def row(self, i: int) -> ModulationResult:
        return ModulationResult(
            avg=float(self.avg[i]), alpha=float(self.alpha[i]),
            sketch=float(self.sketch[i]), d=float(self.d[i]),
            n_iter=int(self.n_iter[i]), case=int(self.case[i]))


def classify_case_batch(d0: np.ndarray, u: np.ndarray, v: np.ndarray,
                        params: IslaParams) -> np.ndarray:
    """Vectorized ``classify_case`` (same §V-C table)."""
    d0 = np.asarray(d0, dtype=np.float64)
    dev = deviation_degree_batch(u, v)
    case = np.where(d0 < 0, np.where(u < v, 1, 2), np.where(u < v, 3, 4))
    return np.where(is_balanced_batch(dev, params), CASE_BALANCED, case)


def _directions_batch(case: np.ndarray, k: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized ``_directions``; balanced lanes get placeholder directions
    (they are overlaid with the sketch0 fallback by the caller)."""
    sk = np.where(k >= 0, 1.0, -1.0)
    dir_mu = np.where(case == 1, 1.0, np.where(case == 4, -1.0, sk))
    dir_sk = np.where((case == 1) | (case == 3), 1.0, -1.0)
    mu_dom = (case == 1) | (case == 4)
    return dir_mu, dir_sk, mu_dom


def n_iterations_batch(d0: np.ndarray, thr: float, eta: float) -> np.ndarray:
    """Vectorized ``n_iterations``; bit-identical per lane.

    Fast path uses ``np.log``; numpy's SIMD log can differ from libm's by an
    ulp, which only matters when the ratio lands within rounding distance of
    an integer — those rare lanes are recomputed with ``math.log`` so the
    ceil agrees with the scalar path exactly.
    """
    ad = np.abs(np.asarray(d0, dtype=np.float64))
    zeros = np.zeros(ad.shape, dtype=np.float64)
    if thr <= 0:
        return zeros
    active = ad > thr
    if not np.any(active):
        return zeros
    denom = math.log(1.0 / eta)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.log(ad / thr) / denom
    t = np.ceil(r)
    risky = active & (np.abs(r - np.rint(r)) < 1e-9)
    for i in np.nonzero(risky)[0]:
        t[i] = math.ceil(math.log(ad[i] / thr) / denom)
    return np.where(active, t, 0.0)


def _eta_pow(eta: float, t: np.ndarray) -> np.ndarray:
    """``eta ** t`` per lane via CPython pow (numpy's vectorized pow drifts
    an ulp from it for non-dyadic eta).  t is integral-valued with few
    distinct values — ceil(log2(|D0|/thr)) — so a small unique-table pass."""
    out = np.empty(t.shape, dtype=np.float64)
    for tv in np.unique(t):
        out[t == tv] = eta ** int(tv)
    return out


def solve_closed_form_batch(k: np.ndarray, c: np.ndarray, sketch0,
                            u: np.ndarray, v: np.ndarray,
                            params: IslaParams) -> ModulationBatchResult:
    """Vectorized ``solve_closed_form`` over stacked blocks.

    This is also the batched stand-in for mode="faithful": the closed form
    evaluates Alg. 2's recursion algebraically (tests pin loop == closed form
    to 1e-12), so the batched engine never runs a data-dependent loop.
    """
    eta, lam, thr = params.eta, params.lam, params.thr
    k = np.asarray(k, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    sketch0 = np.broadcast_to(
        np.asarray(sketch0, dtype=np.float64), k.shape)
    d0 = c - sketch0
    case = classify_case_batch(d0, u, v, params)
    t = n_iterations_batch(d0, thr, eta)
    eta_t = _eta_pow(eta, t)
    total_shrink = (1.0 - eta_t) * np.abs(d0)
    dir_mu, dir_sk, mu_dom = _directions_batch(case, k)
    with np.errstate(divide="ignore", invalid="ignore"):
        s_mu_mudom = total_shrink / (1.0 - lam)
        gain = np.abs(dir_mu * lam - dir_sk)
        s_sk_skdom = total_shrink / gain
        s_mu_total = np.where(mu_dom, s_mu_mudom, lam * s_sk_skdom)
        s_sk_total = np.where(mu_dom, lam * s_mu_mudom, s_sk_skdom)
        alpha = np.where(k != 0.0, (dir_mu * s_mu_total) / k, 0.0)
    sketch = sketch0 + dir_sk * s_sk_total
    avg = k * alpha + c
    d = eta_t * d0
    balanced = case == CASE_BALANCED
    return ModulationBatchResult(
        avg=np.where(balanced, sketch0, avg),
        alpha=np.where(balanced, 0.0, alpha),
        sketch=np.where(balanced, sketch0, sketch),
        d=np.where(balanced, d0, d),
        n_iter=np.where(balanced, 0.0, t),
        case=case.astype(np.int64))


def solve_calibrated_batch(k: np.ndarray, c: np.ndarray, sketch0,
                           u: np.ndarray, v: np.ndarray,
                           params: IslaParams) -> ModulationBatchResult:
    """Vectorized ``solve_calibrated`` (ISLA-C); modulates every lane."""
    eta, thr = params.eta, params.thr
    lam = lambda_star(params.p1, params.p2)
    k = np.asarray(k, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    sketch0 = np.broadcast_to(
        np.asarray(sketch0, dtype=np.float64), k.shape)
    d0 = c - sketch0
    case = classify_case_batch(d0, u, v, params)
    t = n_iterations_batch(d0, thr, eta)
    eta_t = _eta_pow(eta, t)
    total_shrink = (1.0 - eta_t) * np.abs(d0)
    s_sk_total = total_shrink / (1.0 + lam)
    s_mu_total = lam * s_sk_total
    sgn = np.where(d0 > 0, 1.0, -1.0)
    mu_move = -sgn * s_mu_total
    sketch = sketch0 + sgn * s_sk_total
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(k != 0.0, mu_move / k, 0.0)
    avg = k * alpha + c
    return ModulationBatchResult(avg=avg, alpha=alpha, sketch=sketch,
                                 d=eta_t * d0, n_iter=t,
                                 case=case.astype(np.int64))


def solve_empirical_batch(k: np.ndarray, c: np.ndarray, sketch0,
                          u: np.ndarray, v: np.ndarray, params: IslaParams,
                          kappa: float, b0: float) -> ModulationBatchResult:
    """Vectorized ``solve_empirical`` (ISLA-E) with shared pilot geometry."""
    eta, thr = params.eta, params.thr
    k = np.asarray(k, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    sketch0 = np.broadcast_to(
        np.asarray(sketch0, dtype=np.float64), k.shape)
    c_adj = c - b0
    d0 = c_adj - sketch0
    case = classify_case_batch(d0, u, v, params)
    t = n_iterations_batch(d0, thr, eta)
    eta_t = _eta_pow(eta, t)
    shrink = (1.0 - eta_t) * np.abs(d0)
    s_sk_total = shrink / (1.0 + kappa)
    s_mu_total = kappa * s_sk_total
    sgn = np.where(d0 > 0, 1.0, -1.0)
    avg = c_adj - sgn * s_mu_total
    sketch = sketch0 + sgn * s_sk_total
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(k != 0.0, (avg - c) / k, 0.0)
    return ModulationBatchResult(avg=avg, alpha=alpha, sketch=sketch,
                                 d=eta_t * d0, n_iter=t,
                                 case=case.astype(np.int64))


def solve_closed_form(k: float, c: float, sketch0: float, u: float, v: float,
                      params: IslaParams) -> ModulationResult:
    """Algebraic evaluation of ``run_modulation``.

    Over t rounds the total shrink is sum_{i=1..t} (1-eta)*eta^{i-1}*|D0|
    = (1 - eta^t)*|D0|, split per-round in a constant ratio, so the total
    mu_hat displacement is the same constant fraction of the total shrink.
    """
    eta, lam, thr = params.eta, params.lam, params.thr
    d0 = c - sketch0
    case = classify_case(d0, u, v, params)
    if case == CASE_BALANCED:
        return ModulationResult(avg=sketch0, alpha=0.0, sketch=sketch0,
                                d=d0, n_iter=0, case=case)
    t = n_iterations(d0, thr, eta)
    total_shrink = (1.0 - eta ** t) * abs(d0)
    dir_mu, dir_sk, mu_dom = _directions(case, k)
    if mu_dom:
        s_mu_total = total_shrink / (1.0 - lam)
        s_sk_total = lam * s_mu_total
    else:
        gain = abs(dir_mu * lam - dir_sk)
        s_sk_total = total_shrink / gain
        s_mu_total = lam * s_sk_total
    alpha = (dir_mu * s_mu_total) / k if k != 0.0 else 0.0
    sketch = sketch0 + dir_sk * s_sk_total
    avg = k * alpha + c
    return ModulationResult(avg=avg, alpha=alpha, sketch=sketch,
                            d=(eta ** t) * d0, n_iter=t, case=case)
