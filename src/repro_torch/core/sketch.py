"""Mergeable HyperLogLog sketch plane.

The ISLA tick never keeps sampled rows — only mergeable per-cell state —
and HyperLogLog registers satisfy exactly that contract: the merge of two
register planes is the elementwise ``max``, which is associative,
commutative and idempotent, so ANY partition of a stream into ticks folds
to the bit-identical one-pass plane.  This module holds everything the
host and device routes share:

* the 64-bit hash (splitmix64) in two twin implementations — a host
  ``numpy.uint64`` version and a torch ``uint32``-limb version (torch has
  no ``+``, ``>>`` or ``<`` on ``torch.uint64``, and ``int64 >>`` is an
  arithmetic shift, so the 64-bit mix is spelled out in 32-bit limbs held
  in int64 tensors) — that agree bit for bit; the ``isla_sketch`` CUDA
  kernel mixes in native 64-bit integers and is held against the limb
  twin,
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


def value_limbs(values):
    """Raw measure bits as ``(hi, lo)`` uint32 limb arrays — the form the
    tagged tick's callers hand ``DeviceStack.tick`` (``hash_limbs``)."""
    bits = value_bits(values)
    hi = (bits >> np.uint64(32)).astype(np.uint32)
    lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


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


# -- torch twin (uint32 limbs in int64 tensors) ----------------------------
#
# Every limb is an int64 tensor holding a value in [0, 2^32), masked back
# into that range after each op, so right shifts are logical and no
# product exceeds 2^48 (a 32x32 product would overflow int64, which is
# undefined in C++ even where torch happens to wrap).  Bit-identical to
# the numpy twin on every input (audited in tests/test_torch_sketch.py).

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def bits_limbs(bits):
    """An int64 tensor of raw 64-bit patterns as ``(hi, lo)`` limb
    tensors (int64 in [0, 2^32)): the arithmetic ``>>`` of a negative
    pattern is masked back to the logical one."""
    return (bits >> 32) & _M32, bits & _M32


def _add64(ahi, alo, bhi: int, blo: int):
    lo = (alo + blo) & _M32
    carry = (lo < blo).to(lo.dtype)
    return (ahi + bhi + carry) & _M32, lo


def _mulmod32(a, b: int):
    """``(a * b) mod 2^32`` from the 16-bit halves of ``a``."""
    return ((a & _M16) * b + ((((a >> 16) * b) & _M16) << 16)) & _M32


def _mul64(ahi, alo, bhi: int, blo: int):
    """``(a * b) mod 2^64`` over limbs: the low 32x32 -> 64 product via
    16-bit sub-limbs, cross terms folded into the high limb mod 2^32."""
    a0, a1 = alo & _M16, alo >> 16
    b0, b1 = blo & _M16, blo >> 16
    p00 = a0 * b0
    mid = a0 * b1 + (p00 >> 16)
    mid2 = a1 * b0 + (mid & _M16)
    lo = ((p00 & _M16) | (mid2 << 16)) & _M32
    hi = a1 * b1 + (mid >> 16) + (mid2 >> 16)
    hi = (hi + _mulmod32(alo, bhi) + _mulmod32(ahi, blo)) & _M32
    return hi, lo


def _xsr64(hi, lo, s: int):
    """``x >> s`` for 0 < s < 32 over limbs."""
    return hi >> s, ((lo >> s) | (hi << (32 - s))) & _M32


def splitmix64_graph(hi, lo):
    """The torch splitmix64 twin over ``(hi, lo)`` limb tensors (int64 in
    [0, 2^32), see ``bits_limbs``)."""
    hi, lo = _add64(hi, lo, 0x9E3779B9, 0x7F4A7C15)
    thi, tlo = _xsr64(hi, lo, 30)
    hi, lo = _mul64(hi ^ thi, lo ^ tlo, 0xBF58476D, 0x1CE4E5B9)
    thi, tlo = _xsr64(hi, lo, 27)
    hi, lo = _mul64(hi ^ thi, lo ^ tlo, 0x94D049BB, 0x133111EB)
    thi, tlo = _xsr64(hi, lo, 31)
    return hi ^ thi, lo ^ tlo


def encode_graph(hi, lo):
    """Torch ``hash -> (j, rho)`` over limb tensors: ``j`` (int64) the top
    12 bits, ``rho`` (uint8) the leading-zero count of the low 52 bits
    plus 1 — read off the exact float64 image of the < 2^52 remainder, as
    the host ``encode`` does (``frexp(0)`` gives 53)."""
    import torch

    j = hi >> 20
    rem = ((hi & 0xFFFFF) << 32) | lo
    _, exp = torch.frexp(rem.to(torch.float64))
    return j, (RHO_MAX - exp).to(torch.uint8)


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
