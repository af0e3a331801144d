"""Summarization module (paper §II-B): combine block partials.

final = sum_j avg_j * |B_j| / M — block partials weighted by block size.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def summarize(partials: Sequence[float], block_sizes: Sequence[int]) -> float:
    p = np.asarray(partials, dtype=np.float64)
    w = np.asarray(block_sizes, dtype=np.float64)
    if p.shape != w.shape:
        raise ValueError(f"shape mismatch {p.shape} vs {w.shape}")
    total = float(np.sum(w))
    if total <= 0:
        raise ValueError("total data size must be positive")
    return float(np.sum(p * w) / total)
