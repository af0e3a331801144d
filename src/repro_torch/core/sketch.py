"""Mergeable HyperLogLog sketch plane.

The ISLA tick never keeps sampled rows — only mergeable per-cell state —
and HyperLogLog registers satisfy exactly that contract: the merge of two
register planes is the elementwise ``max``, which is associative,
commutative and idempotent, so ANY partition of a stream into ticks folds
to the bit-identical one-pass plane.  This module is the host twin (the
device plane's ``uint32``-limb twin is not in this slice of the port):

* the 64-bit hash (splitmix64) over ``numpy.uint64``,
* the register encoding ``hash -> (bucket j, rank rho)``,
* the standard HLL estimator with small-range correction, and
* the group fold (max over a store's block axis).

Hash input contract: registers are keyed on the RAW float64 bit pattern
of the measure value (``np.float64`` canonicalized, then bitcast), never
on shifted or scaled copies — so host, device and mesh routes, and
distinct anchors, hash the same 64 bits and build identical planes.  No
Python ``hash`` anywhere: planes are reproducible across interpreters.
"""
from __future__ import annotations

import math

import numpy as np

# -- geometry --------------------------------------------------------------

P = 12                      # register-index bits
M = 1 << P                  # 4096 registers per cell
RHO_MAX = 53                # 52 remaining hash bits, all-zero rem -> 53
ALPHA_M = 0.7213 / (1.0 + 1.079 / M)
REL_ERROR = 1.04 / math.sqrt(M)   # ~1.625% standard error at m=2^12

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)

_REM_MASK = np.uint64((1 << 52) - 1)


# -- host twin (numpy uint64) ---------------------------------------------

def splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over a ``uint64`` array (wrapping mod 2^64)."""
    z = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = z + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * _C1
        z = (z ^ (z >> np.uint64(27))) * _C2
        return z ^ (z >> np.uint64(31))


def value_bits(values) -> np.ndarray:
    """The raw 64-bit pattern of each measure value (the hash input).

    ``np.float64`` canonicalization happens HERE, before the bitcast, so
    every caller — host ingest, device pane builder, subprocess audit —
    hashes identical bits for identical streams.
    """
    v = np.ascontiguousarray(np.asarray(values, dtype=np.float64))
    return v.view(np.uint64).reshape(v.shape)


def hash_values(values) -> np.ndarray:
    """64-bit hash of raw measure values (host twin)."""
    return splitmix64(value_bits(values))


def encode(h: np.ndarray):
    """``hash -> (j, rho)``: bucket = top 12 bits, rank = leading-zero
    count of the remaining 52 bits + 1 (all-zero remainder -> 53).

    The rank is exact integer work: the remainder is < 2^52 so its
    float64 image is exact and ``np.frexp`` reads off the bit length
    (``frexp(0)`` reports exponent 0, giving rho = 53 for free).
    """
    h = np.asarray(h, dtype=np.uint64)
    j = (h >> np.uint64(52)).astype(np.int64)
    rem = (h & _REM_MASK).astype(np.float64)      # exact: rem < 2^52
    _, exp = np.frexp(rem)
    rho = (RHO_MAX - exp).astype(np.uint8)
    return j, rho


def scatter_max(regs: np.ndarray, seg: np.ndarray, j: np.ndarray,
                rho: np.ndarray) -> None:
    """In-place ``regs[seg, j] = max(regs[seg, j], rho)`` (the host merge).

    ``rho == 0`` rows are neutral (registers are non-negative), so masked
    samples can ride the scatter with a zeroed rank instead of a gather.
    """
    np.maximum.at(regs, (np.asarray(seg, dtype=np.int64), j), rho)


# -- estimation ------------------------------------------------------------

def estimate(regs: np.ndarray) -> np.ndarray:
    """The HLL cardinality estimate over the trailing register axis.

    Harmonic-mean raw estimate with the standard small-range correction
    (linear counting when E <= 2.5 m and empty registers remain); runs in
    host float64 for every route, so host/device/mesh answers differ only
    through the register plane — which is bit-identical by construction.
    """
    r = np.asarray(regs)
    s = np.exp2(-r.astype(np.float64)).sum(axis=-1)
    e = ALPHA_M * M * M / s
    v = (r == 0).sum(axis=-1)
    lin = M * np.log(M / np.maximum(v, 1))
    return np.where((e <= 2.5 * M) & (v > 0), lin, e)


def fold_groups(regs: np.ndarray, n_groups: int) -> np.ndarray:
    """Fold a store's ``(n_groups * n_blocks, M)`` register plane to one
    ``(n_groups, M)`` row per group — max over the block axis."""
    r = np.asarray(regs)
    return r.reshape(n_groups, -1, M).max(axis=1)


def distinct_error(estimate_value: float, beta_z: float) -> float:
    """Half-width of the HLL estimate at a beta z-score: the standard
    ~1.04/sqrt(m) relative standard error scaled to the estimate."""
    return float(beta_z * REL_ERROR * max(estimate_value, 0.0))
