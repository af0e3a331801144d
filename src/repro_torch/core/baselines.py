"""Baselines the paper compares against (§VIII):

 * US  — plain uniform sampling: answer = mean(sample).
 * MV  — measure-biased on values (sample+seek Eq. 4 re-weighting):
         answer = sum(prob_i * a_i) with prob_i = a_i / sum(a).
         For N(mu, sigma) this converges to (sigma^2 + mu^2)/mu — e.g. 104
         for N(100, 20) — which is exactly Table IV's MV row.
 * MVB — measure-biased on values *and* boundaries: samples are split into the
         5 regions; each region receives probability mass n_region/m; within a
         region, mass is proportional to value (paper §VIII-C example:
         sample 30 in L={30,35} of a 5-sample draw gets (2/5)*(30/65)).

All take the *uniform* sample a block drew; they differ only in re-weighting,
mirroring how the paper implements them.
"""
from __future__ import annotations

import numpy as np

from .types import Boundaries, classify_np


def uniform_avg(samples: np.ndarray) -> float:
    s = np.asarray(samples, dtype=np.float64)
    return float(np.mean(s))


def mv_avg(samples: np.ndarray) -> float:
    s = np.asarray(samples, dtype=np.float64)
    tot = float(np.sum(s))
    if tot == 0.0:
        return 0.0
    prob = s / tot
    return float(np.sum(prob * s))


def mvb_avg(samples: np.ndarray, boundaries: Boundaries) -> float:
    s = np.asarray(samples, dtype=np.float64)
    m = s.size
    codes = classify_np(s, boundaries)
    answer = 0.0
    for region in np.unique(codes):
        vals = s[codes == region]
        region_sum = float(np.sum(vals))
        if region_sum == 0.0:
            continue
        region_mass = vals.size / m
        # prob_i = (n_r / m) * (a_i / sum_r a); answer += sum(prob_i * a_i)
        answer += region_mass * float(np.sum(vals * vals)) / region_sum
    return answer
