"""Core datatypes for ISLA (Iterative Scheme for Leverage-based Aggregation).

Everything here is deliberately tiny: the whole point of
the paper is that a block's sampling state is four scalars per region
(``counter, sum, squareSum, cubeSum`` — Alg. 1), so the distributed state that
crosses the wire is O(1) regardless of sample size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np

Array = Any

# Region codes used throughout (paper §IV-A1, Fig. 3).
REGION_TS = 0  # too small   (-inf, sketch0 - p2*sigma]
REGION_S = 1   # small       (sketch0 - p2*sigma, sketch0 - p1*sigma)
REGION_N = 2   # normal      [sketch0 - p1*sigma, sketch0 + p1*sigma]
REGION_L = 3   # large       (sketch0 + p1*sigma, sketch0 + p2*sigma)
REGION_TL = 4  # too large   [sketch0 + p2*sigma, +inf)
NUM_REGIONS = 5
REGION_NAMES = ("TS", "S", "N", "L", "TL")


@dataclasses.dataclass
class RegionMoments:
    """Streaming moments of the samples that fell into one region.

    Matches the paper's ``param_S`` / ``param_L`` arrays exactly
    (Alg. 1, ``updateParams``): counter, sum, square sum, cube sum.
    """

    count: Array  # number of samples in the region
    s1: Array     # sum of values
    s2: Array     # sum of squared values
    s3: Array     # sum of cubed values

    @staticmethod
    def zeros(dtype=np.float32) -> "RegionMoments":
        z = np.zeros((), dtype)
        return RegionMoments(count=z, s1=z, s2=z, s3=z)

    @staticmethod
    def zeros_np() -> "RegionMoments":
        return RegionMoments(count=0.0, s1=0.0, s2=0.0, s3=0.0)

    def update(self, a) -> "RegionMoments":
        """Alg. 1 ``updateParams`` — add one sample."""
        return RegionMoments(
            count=self.count + 1,
            s1=self.s1 + a,
            s2=self.s2 + a * a,
            s3=self.s3 + a * a * a,
        )

    def merge(self, other: "RegionMoments") -> "RegionMoments":
        """Moments are additive — this is what makes ISLA distributable and
        its online extension (§VII-A) trivial."""
        return RegionMoments(
            count=self.count + other.count,
            s1=self.s1 + other.s1,
            s2=self.s2 + other.s2,
            s3=self.s3 + other.s3,
        )

    def scaled(self, scale) -> "RegionMoments":
        """Moments of ``scale * a`` given moments of ``a``.

        ISLA is exactly equivariant under value scaling (leverages are scale
        invariant; k, c scale linearly) — this is the fp32-safety lever used
        by the distributed path.
        """
        return RegionMoments(
            count=self.count,
            s1=self.s1 * scale,
            s2=self.s2 * scale * scale,
            s3=self.s3 * scale * scale * scale,
        )

    @staticmethod
    def from_values(values, mask=None) -> "RegionMoments":
        """Vectorized Alg. 1 inner loop over an array of samples."""
        v = np.asarray(values)
        if mask is None:
            mask = np.ones(v.shape, dtype=v.dtype)
        else:
            mask = np.asarray(mask, dtype=v.dtype)
        vm = v * mask
        return RegionMoments(
            count=np.sum(mask),
            s1=np.sum(vm),
            s2=np.sum(vm * v),
            s3=np.sum(vm * v * v),
        )

    def as_vector(self):
        return np.asarray([self.count, self.s1, self.s2, self.s3],
                          dtype=np.float32)

    @staticmethod
    def from_vector(vec) -> "RegionMoments":
        return RegionMoments(count=vec[0], s1=vec[1], s2=vec[2], s3=vec[3])

    def to_float(self) -> "RegionMoments":
        """Host-side float64 view (numpy scalars -> python floats)."""
        return RegionMoments(
            count=float(self.count), s1=float(self.s1),
            s2=float(self.s2), s3=float(self.s3))



@dataclasses.dataclass(frozen=True)
class Predicate:
    """A WHERE clause over sampled rows: the conjunction of an optional
    half-open range ``[lo, hi)`` and an optional equality on one column.

    The half-open range means adjacent range predicates tile the value axis
    without double counting.  ``eq`` is meant for categorical / integer-coded
    columns, where float equality on codes is exact.  Frozen and hashable so
    query planners can key shared work by ``(where, group_by)``.
    """

    column: str = "value"
    lo: Optional[float] = None   # value >= lo
    hi: Optional[float] = None   # value <  hi
    eq: Optional[float] = None   # value == eq

    def mask(self, columns: Mapping[str, np.ndarray]) -> np.ndarray:
        """Boolean match mask over a dict of equal-length column arrays."""
        if self.column not in columns:
            raise KeyError(
                f"predicate column {self.column!r} not in sampled rows "
                f"(have: {sorted(columns)})")
        col = np.asarray(columns[self.column])
        m = np.ones(col.shape, dtype=bool)
        if self.eq is not None:
            m &= col == self.eq
        if self.lo is not None:
            m &= col >= self.lo
        if self.hi is not None:
            m &= col < self.hi
        return m

    def describe(self) -> str:
        parts = []
        if self.lo is not None:
            parts.append(f"{self.column} >= {self.lo:g}")
        if self.hi is not None:
            parts.append(f"{self.column} < {self.hi:g}")
        if self.eq is not None:
            parts.append(f"{self.column} == {self.eq:g}")
        return " AND ".join(parts) if parts else "TRUE"

    def interval_status(self, lo, hi, count=None) -> np.ndarray:
        """Zone-map interval evaluation: decide per block whether this
        predicate *provably* matches none / all / some of the block's rows,
        given only the block's inclusive column bounds ``[lo, hi]``.

        The three-way verdict is what makes pruning sound: ``ZONE_EMPTY``
        and ``ZONE_FULL`` are proofs (the planner may skip the draw or the
        mask), while ``ZONE_PARTIAL`` only means "cannot decide from
        bounds" and falls back to the sampled-and-masked path.

        Parameters
        ----------
        lo, hi : array_like
            Inclusive per-block min / max of this predicate's column.
        count : array_like, optional
            Per-block row counts; blocks with ``count == 0`` are
            ``ZONE_EMPTY`` regardless of bounds.

        Returns
        -------
        numpy.ndarray of int8
            One of ``ZONE_EMPTY`` / ``ZONE_PARTIAL`` / ``ZONE_FULL`` per
            block.

        Examples
        --------
        >>> p = Predicate(column="day", eq=2.0)
        >>> p.interval_status([0., 2., 1.], [1., 2., 3.]).tolist()
        [0, 2, 1]
        """
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        empty = np.zeros(lo.shape, dtype=bool)
        full = np.ones(lo.shape, dtype=bool)
        if self.eq is not None:
            empty |= (self.eq < lo) | (self.eq > hi)
            full &= (lo == self.eq) & (hi == self.eq)
        if self.lo is not None:
            empty |= hi < self.lo
            full &= lo >= self.lo
        if self.hi is not None:
            empty |= lo >= self.hi
            full &= hi < self.hi
        if count is not None:
            empty |= np.asarray(count) == 0
        out = np.full(lo.shape, ZONE_PARTIAL, dtype=np.int8)
        out[full] = ZONE_FULL
        out[empty] = ZONE_EMPTY  # empty wins (e.g. count == 0)
        return out


# Zone-map verdicts (per block, per predicate) — see
# ``Predicate.interval_status`` and ``ZoneMap.status``.
ZONE_EMPTY = 0    # the predicate provably matches NO row of the block
ZONE_PARTIAL = 1  # bounds cannot decide; sample and mask as before
ZONE_FULL = 2     # the predicate provably matches EVERY row of the block


class ZoneMap:
    """Per-block summary statistics for predicate pruning.

    A zone map keeps, for every block, the inclusive ``[lo, hi]`` value
    bounds of each tracked column, the block's row count, and the measure
    column's streaming moments (count, sum, sum of squares).  From those
    bounds alone the planner can *prove* which blocks a ``Predicate``
    filters out entirely (``ZONE_EMPTY``) or keeps entirely
    (``ZONE_FULL``) — the remaining ``ZONE_PARTIAL`` blocks are the only
    ones that still need sampled-and-masked treatment.  The statistics are
    exact properties of the data, so the resulting prune is exact too: the
    skipped mass contributes a deterministic zero, not an estimate.

    The map is refreshed on ingest (``refresh`` folds a block's new rows
    into its bounds; bounds only widen) and versioned, so cached
    per-predicate verdicts invalidate automatically.

    Examples
    --------
    >>> zm = ZoneMap.from_tables(
    ...     [{"value": np.array([1., 2.]), "day": np.array([0., 0.])},
    ...      {"value": np.array([3., 4.]), "day": np.array([1., 1.])}])
    >>> zm.status(Predicate(column="day", eq=1.0)).tolist()
    [0, 2]
    """

    def __init__(self, n_blocks: int, measure: str = "value"):
        self.n_blocks = int(n_blocks)
        self.measure = measure
        self.counts = np.zeros(self.n_blocks, dtype=np.int64)
        # column -> (lo, hi) inclusive bounds; empty blocks hold +/-inf so
        # any refresh widens them correctly.
        self.columns: dict = {}
        # measure moments per block: (count, sum, sumsq)
        self.moments = np.zeros((self.n_blocks, 3), dtype=np.float64)
        self.version = 0
        self._status_cache: dict = {}

    @staticmethod
    def from_tables(tables, measure: str = "value") -> "ZoneMap":
        """Build a zone map from per-block column dicts (the same tables
        ``multiquery.table_sampler`` wraps)."""
        zm = ZoneMap(len(tables), measure=measure)
        for b, table in enumerate(tables):
            zm.refresh(b, table)
        return zm

    def _ensure_column(self, name: str) -> None:
        if name not in self.columns:
            self.columns[name] = (
                np.full(self.n_blocks, np.inf, dtype=np.float64),
                np.full(self.n_blocks, -np.inf, dtype=np.float64))

    def refresh(self, block_id: int, columns: Mapping[str, np.ndarray]
                ) -> None:
        """Fold a block's (new) rows into its zones — bounds only widen,
        so refreshing with an append-only delta is exact."""
        b = int(block_id)
        n = 0
        for name, col in columns.items():
            col = np.asarray(col, dtype=np.float64)
            n = max(n, col.size)
            if col.size == 0:
                continue
            self._ensure_column(name)
            lo, hi = self.columns[name]
            lo[b] = min(lo[b], float(col.min()))
            hi[b] = max(hi[b], float(col.max()))
            if name == self.measure:
                self.moments[b, 0] += col.size
                self.moments[b, 1] += float(col.sum())
                self.moments[b, 2] += float((col * col).sum())
        self.counts[b] += n
        self.version += 1
        self._status_cache.clear()

    def status(self, predicate: Optional[Predicate]) -> np.ndarray:
        """Per-block ``ZONE_*`` verdicts for ``predicate``.

        ``None`` (no WHERE) is all-``ZONE_FULL``; a predicate over a
        column the map does not track is all-``ZONE_PARTIAL`` (no proof
        available, so no pruning — never unsound).  Verdicts are cached
        per (predicate, version).
        """
        if predicate is None:
            return np.full(self.n_blocks, ZONE_FULL, dtype=np.int8)
        key = (predicate, self.version)
        hit = self._status_cache.get(key)
        if hit is not None:
            return hit
        if predicate.column not in self.columns:
            out = np.full(self.n_blocks, ZONE_PARTIAL, dtype=np.int8)
        else:
            lo, hi = self.columns[predicate.column]
            out = predicate.interval_status(lo, hi, count=self.counts)
        out.setflags(write=False)
        self._status_cache[key] = out
        return out


@dataclasses.dataclass(frozen=True)
class StoreKey:
    """Identity of a persistent moment store in the incremental serving
    path: the re-segmentation work (``where``, ``group_by``) plus the
    resolved Phase 2 mode its passes were planned under.  Frozen/hashable —
    executors key warm stores and their sample ledgers off it."""

    where: Optional[Predicate] = None
    group_by: Optional[str] = None
    mode: str = "calibrated"

    def describe(self) -> str:
        sel = self.where.describe() if self.where is not None else "TRUE"
        return (f"where[{sel}] group_by[{self.group_by or '-'}] "
                f"mode={self.mode}")


@dataclasses.dataclass(frozen=True)
class AnswerKey:
    """Identity of an ANSWER in the admission tier's subsumption lattice:
    a :class:`StoreKey` plus the aggregate.  Two queries sharing an
    AnswerKey compute the same value from the same warm store — only
    their ``(e, beta)`` demands (and priorities) may differ, and demands
    form a partial order (see :func:`demand_dominates`): the stronger
    answer serves the weaker query with zero new samples.

    Examples
    --------
    >>> from repro_torch.core.engine import IslaQuery
    >>> k = AnswerKey.from_query(IslaQuery(agg="SUM", group_by="region"),
    ...                          default_mode="calibrated")
    >>> k.describe()
    'SUM where[TRUE] group_by[region] mode=calibrated'
    """

    agg: str
    store: StoreKey

    @classmethod
    def from_query(cls, query, default_mode: str) -> "AnswerKey":
        """Key a query's answer: its StoreKey (mode resolved to the
        executor default when unpinned) plus its aggregate."""
        return cls(agg=query.agg,
                   store=StoreKey(where=query.where,
                                  group_by=query.group_by,
                                  mode=query.mode or default_mode))

    def describe(self) -> str:
        return f"{self.agg} {self.store.describe()}"


def demand_dominates(e1: float, beta1: float,
                     e2: float, beta2: float) -> bool:
    """True iff an ``(e1, beta1)`` answer satisfies an ``(e2, beta2)``
    ask: at least as precise AND at least as confident.  This is the
    subsumption lattice's partial order — incomparable demands (tighter
    ``e`` but looser ``beta``) never subsume each other.

    >>> demand_dominates(0.05, 0.95, 0.1, 0.9)
    True
    >>> demand_dominates(0.05, 0.9, 0.1, 0.95)
    False
    """
    return e1 <= e2 and beta1 >= beta2


@dataclasses.dataclass(frozen=True)
class IslaParams:
    """All tunables of the scheme, defaults per the paper's §VIII setup."""

    e: float = 0.1                 # desired precision (user query)
    beta: float = 0.95             # confidence
    p1: float = 0.5                # inner data-boundary factor
    p2: float = 2.0                # outer data-boundary factor ("3-sigma rule" cut)
    eta: float = 0.5               # convergence speed: D -> eta * D per iteration
    lam: float = 0.8               # step-length factor lambda
    thr: float = 1e-4              # iteration threshold on |D|
    te: float = 3.0                # relaxed-precision factor for sketch0 (t_e > 1)
    # |S|/|L| ranges (§IV-A4, §VIII "Parameters"):
    balanced_lo: float = 0.99      # dev in (balanced_lo, balanced_hi) => Case 5
    balanced_hi: float = 1.01
    mild_lo: float = 0.94          # dev in (mild_lo,0.97)∪(1.03,mild_hi) => q'=5
    mild_hi: float = 1.06
    q_mild: float = 5.0
    q_strong: float = 10.0         # dev beyond mild range => q'=10
    min_region_count: int = 1      # guard: need >=1 sample in S and in L

    def replace(self, **kw) -> "IslaParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Boundaries:
    """Data-division criteria (paper §IV-A1): four cut points derived from
    sketch0 and sigma.  ``s_lo/s_hi`` bound the S region, ``l_lo/l_hi`` the L
    region."""

    s_lo: float  # sketch0 - p2*sigma
    s_hi: float  # sketch0 - p1*sigma
    l_lo: float  # sketch0 + p1*sigma
    l_hi: float  # sketch0 + p2*sigma

    def as_tuple(self) -> Tuple[float, float, float, float]:
        return (self.s_lo, self.s_hi, self.l_lo, self.l_hi)


@dataclasses.dataclass(frozen=True)
class Anchor:
    """The frozen classification frame a moment store accumulates under.

    An anchor bundles everything Phase 1 classification and Phase 2
    iteration are *conditioned on*: the region ``boundaries`` (§IV-A1 cut
    points), the ``sketch0`` Phase 2 starts from (shifted scale), the
    footnote-1 positivity ``shift``, and the pilot ``sigma`` the rate
    planner reads.  Boundaries and shift are FROZEN for the lifetime of any
    store built on the anchor — merged moments cannot be re-classified —
    while ``sketch0`` stays re-anchorable (``MomentStore.reanchor``), which
    is why :attr:`fingerprint` deliberately excludes it.

    ``refine_for_predicate`` is the per-key constructor (ROADMAP "boundary
    refinement under selective predicates"): a heavily measure-correlated
    ``WHERE`` starves the S/L regions of globally-derived boundaries, so a
    key's anchor is re-derived from the pilot rows *matching that
    predicate*, falling back to the global anchor when the matching
    support is too thin to trust.

    Parameters
    ----------
    boundaries : Boundaries
        Region cut points on the shifted value axis.
    sketch0 : float
        Phase 2 starting sketch, shifted scale (``pilot mean + shift``).
    shift : float
        Footnote-1 translation applied to raw values before the math.
    sigma : float
        ddof-1 standard deviation of the anchor's source rows (raw scale —
        sigma is shift-invariant).
    support : int
        Number of pilot rows the statistics derive from.
    source : str
        ``"global"`` (whole pilot) or ``"refined"`` (predicate-matching
        pilot rows).
    skew : float
        Standardized third moment of the anchor's source rows
        (``engine.sample_skew`` — degenerate slices clamp to 0).  A
        refined anchor carries its OWN sub-population's shape, so the
        planner can resolve mode="auto" per key instead of from the
        global pilot.  Like ``sigma``, a statistic — excluded from
        :attr:`fingerprint`.

    Examples
    --------
    >>> a = Anchor(Boundaries(60., 90., 110., 140.), 100.0, 0.0, 20.0,
    ...            support=512)
    >>> a.refine_for_predicate({}, None, IslaParams()) is a
    True
    """

    boundaries: Boundaries
    sketch0: float
    shift: float
    sigma: float
    support: int = 0
    source: str = "global"
    skew: float = 0.0

    @property
    def fingerprint(self) -> Tuple:
        """Hashable identity of the FROZEN part of the anchor.

        Two stores whose anchors share a fingerprint accumulated moments
        under identical classification frames and may merge; a differing
        fingerprint invalidates only stores keyed on it.  ``sketch0`` and
        ``sigma`` are excluded: re-anchoring a store's sketch (or a sigma
        re-estimate) does not re-classify its accumulated moments.
        """
        return (self.boundaries.as_tuple(), self.shift)

    @staticmethod
    def from_pilot(pilot, params: "IslaParams") -> "Anchor":
        """The global anchor — exactly the frame ``aggregate()`` derives
        from a ``PilotResult``."""
        from .boundaries import make_boundaries
        from .engine import sample_skew
        sketch0 = pilot.sketch0 + pilot.shift
        skew = (sample_skew(pilot.values) if pilot.values is not None
                else 0.0)
        return Anchor(
            boundaries=make_boundaries(sketch0, pilot.sigma, params),
            sketch0=sketch0, shift=pilot.shift, sigma=pilot.sigma,
            support=int(pilot.pilot_size), source="global", skew=skew)

    def refine_for_predicate(self, pilot_columns: Mapping[str, np.ndarray],
                             where: Optional["Predicate"],
                             params: "IslaParams",
                             measure: str = "value",
                             min_support: int = 64) -> "Anchor":
        """Derive a per-predicate anchor from the matching pilot rows.

        Returns ``self`` (the global anchor) whenever refinement cannot
        improve on it: no predicate, no pilot rows captured, the predicate
        matches *every* pilot row (the refined frame would be the global
        frame re-estimated), fewer than ``min_support`` matching rows, or
        a degenerate (non-positive) matching sigma.

        Parameters
        ----------
        pilot_columns : mapping of str to ndarray
            The captured pilot rows (equal-length column arrays).
        where : Predicate or None
            The key's WHERE clause.
        params : IslaParams
            Supplies the ``p1``/``p2`` boundary factors.
        measure : str
            Name of the aggregated column inside ``pilot_columns``.
        min_support : int
            Minimum matching pilot rows before the refined statistics are
            trusted over the global ones.

        Returns
        -------
        Anchor
            A ``source="refined"`` anchor over the matching rows, or
            ``self`` on fallback.
        """
        if where is None or not pilot_columns or measure not in pilot_columns:
            return self
        m = np.asarray(where.mask(pilot_columns), dtype=bool)
        if m.size == 0 or bool(np.all(m)):
            return self
        vals = np.asarray(pilot_columns[measure], dtype=np.float64)[m]
        if vals.size < max(int(min_support), 2):
            return self
        sigma = float(np.std(vals, ddof=1))
        if not np.isfinite(sigma) or sigma <= 0:
            return self
        mean = float(np.mean(vals))
        lo = float(np.min(vals))
        # Same footnote-1 rule as run_pilot: shift only when the matching
        # rows actually reach non-positive values, with a 1-sigma margin.
        shift = 0.0 if lo > 0.0 else -lo + sigma
        sketch0 = mean + shift
        from .boundaries import make_boundaries
        from .engine import sample_skew
        return Anchor(
            boundaries=make_boundaries(sketch0, sigma, params),
            sketch0=sketch0, shift=shift, sigma=sigma,
            support=int(vals.size), source="refined",
            skew=sample_skew(vals))

    def planning_sigma(self, beta: float = 0.95) -> float:
        """Upper-confidence sigma for Eq. 1 rate planning.

        A refined anchor's sigma is estimated from its (often few)
        matching pilot rows; planning the sample size at sigma-hat
        exactly would under-shoot the required m about half the time
        (se(sigma-hat) ~ sigma / sqrt(2 n)).  Inflating by that
        estimation uncertainty keeps the earned-bound rate near beta
        while staying far below the pooled-sigma bill the refinement
        replaced.
        """
        if self.support < 2:
            return self.sigma
        from .preestimation import z_score
        return self.sigma * (1.0 + z_score(beta)
                             / math.sqrt(2.0 * self.support))

    def describe(self) -> str:
        b = self.boundaries
        return (f"anchor[{self.source}] sketch0={self.sketch0:g} "
                f"sigma={self.sigma:g} shift={self.shift:g} "
                f"S=({b.s_lo:g},{b.s_hi:g}) L=({b.l_lo:g},{b.l_hi:g}) "
                f"support={self.support}")


@dataclasses.dataclass
class BlockResult:
    """Partial answer of one block (Alg. 2 output + bookkeeping)."""

    block_id: int
    avg: float
    alpha: float
    sketch: float
    case: int
    n_iter: int
    u: int                 # |S|
    v: int                 # |L|
    n_sampled: int
    param_s: RegionMoments
    param_l: RegionMoments


@dataclasses.dataclass
class BlockResultsBatch:
    """Columnar (struct-of-arrays) view of n blocks' partial answers.

    The batched engine produces this instead of n ``BlockResult`` objects —
    building tens of thousands of dataclasses would reintroduce the per-block
    Python cost the batched path exists to remove.  It satisfies the sequence
    protocol, materializing ``BlockResult`` rows on demand, so existing
    consumers (``for b in result.blocks``) keep working unchanged.
    """

    avg: np.ndarray        # (n,) float64 partial answers
    alpha: np.ndarray      # (n,)
    sketch: np.ndarray     # (n,)
    case: np.ndarray       # (n,) int64
    n_iter: np.ndarray     # (n,) integral
    mom_s: np.ndarray      # (n, 4) S-region moments (count, s1, s2, s3)
    mom_l: np.ndarray      # (n, 4) L-region moments
    n_sampled: np.ndarray  # (n,) samples drawn per block

    def __len__(self) -> int:
        return self.avg.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = int(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return BlockResult(
            block_id=i, avg=float(self.avg[i]), alpha=float(self.alpha[i]),
            sketch=float(self.sketch[i]), case=int(self.case[i]),
            n_iter=int(self.n_iter[i]), u=int(self.mom_s[i, 0]),
            v=int(self.mom_l[i, 0]), n_sampled=int(self.n_sampled[i]),
            param_s=RegionMoments(*(float(x) for x in self.mom_s[i])),
            param_l=RegionMoments(*(float(x) for x in self.mom_l[i])))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


@dataclasses.dataclass
class AggregateResult:
    """Final ISLA answer + provenance."""

    answer: float
    sketch0: float
    sigma: float
    sampling_rate: float
    sample_size: int
    blocks: list
    boundaries: Boundaries

    def __float__(self) -> float:
        return float(self.answer)


def region_of(value: float, b: Boundaries) -> int:
    """Scalar classifier — reference semantics for the vectorized paths."""
    if value <= b.s_lo:
        return REGION_TS
    if value < b.s_hi:
        return REGION_S
    if value <= b.l_lo:
        return REGION_N
    if value < b.l_hi:
        return REGION_L
    return REGION_TL


def classify(values, b: Boundaries):
    """Vectorized region codes.  Region edges follow §IV-A1 exactly:
    TS: (-inf, s_lo]; S: (s_lo, s_hi); N: [s_hi, l_lo]; L: (l_lo, l_hi);
    TL: [l_hi, inf)."""
    return classify_np(values, b)


def classify_np(values: np.ndarray, b: Boundaries) -> np.ndarray:
    v = np.asarray(values)
    code = np.full(v.shape, REGION_N, dtype=np.int32)
    code[v <= b.s_lo] = REGION_TS
    code[(v > b.s_lo) & (v < b.s_hi)] = REGION_S
    code[(v > b.l_lo) & (v < b.l_hi)] = REGION_L
    code[v >= b.l_hi] = REGION_TL
    return code
