"""Relational multi-query ISLA: N concurrent bounded-error SQL-shaped
aggregates — WHERE, GROUP BY, per-query Phase 2 modes — from shared passes.

BlinkDB-style serving answers many simultaneous ``(e, beta, agg)`` queries
over shared samples; PS3-style planning uses summary statistics to decide
how much to sample where.  ISLA makes both cheap: Theorem 3 collapses any
sub-stream to 8 streaming moments, so a (group, block) cell is exactly as
summarizable as a block, and the whole relational surface rides the one
vectorized engine:

  planning    ``plan()`` parses each ``IslaQuery`` (``where: Predicate``,
              ``group_by: key``, ``mode``), resolves per-query Phase 2
              modes (``auto`` from pilot skew), groups queries by resolved
              mode, and plans ONE shared sampling rate per mode-group —
              the strictest Eq. 1 rate among the group's queries, inflated
              predicate-aware: GROUP BY multiplies by the group-key
              cardinality, WHERE divides by the predicate's selectivity as
              estimated on the pilot rows.
  execution   one pilot for the batch + one tagged sampling pass per
              mode-group.  Per distinct ``(where, group_by)`` key the pass's
              stream is re-segmented (segment id = group * n_blocks + block,
              ``engine.flat_segments``) and the SAME vectorized Phase 1 +
              Phase 2 machinery runs over the flattened cells — no
              per-group Python loop, host float64 or the torch device
              route (``distributed.phase2``) unchanged.
  answers     AVG    leverage-based mean per group               (§II-B)
              SUM    est. group population * mean (plain M * mean when
                     unpredicated — absolute bound M * e)
              COUNT  exact from catalog metadata when unpredicated;
                     estimated (M * match fraction) with a normal-binomial
                     bound under WHERE / GROUP BY
              VAR    E[X^2] - mean^2 per group from the pass's plain cell
                     moments and the leverage-corrected mean (best-effort)
              Bounds stay honest: a group's ``(e, beta)`` claim is reported
              only when its own matching-sample count reaches Eq. 1's m for
              its estimated sigma AND none of its populated cells hit the
              empty-region fallback; small/starved groups degrade to
              best-effort (bound None) — reported, never silently wrong.

The scalar per-block engine (``engine.run_block``) stays the bit-validated
reference oracle: every (group, block) cell's moments and partial answer are
bit-identical to running it over that cell's sub-stream in stream order.

Online / incremental serving: every pass accumulates into a ``MomentStore``
(the §VII-A state lifted onto the (group, block) axis).  One-shot batches
use ephemeral stores — bit-identical to the pre-store executor — while
``run(..., incremental=True)`` keys persistent stores by
``StoreKey(where, group_by, mode)``: the pilot anchor (boundaries, sketch0,
shift) is frozen on first use, repeat predicates are answered from the warm
moments, and a new query's (e, beta) tops up only the per-block sample
DEFICIT its Eq. 1 quota still demands (zero new samples when the deficit is
<= 0).  A tick ``budget`` is split across passes by marginal-error
reduction (``moment_store.split_budget``; ``budget_floor`` guarantees
every pass a QoS floor) — the deadline-aware serving path.
``chunk_blocks`` streams the row draw through block-sized chunks so
row columns are never materialized whole (bit-identical via the engine's
carry contract).

Per-key leverage anchors: the anchor is a per-``StoreKey`` object
(``types.Anchor``) — each distinct ``(where, group_by)`` key derives its
own boundaries/shift/sketch0 from the pilot rows MATCHING its predicate
(``Anchor.refine_for_predicate``; global fallback below
``anchor_min_support`` matching rows), so leverage separation survives
selective and measure-correlated WHEREs.  The planner rates refined keys
at their matching-rows sigma, warm-store reuse is keyed on the anchor
FINGERPRINT (frozen part only), and the drift guard checks each refined
key against its own anchor — a drifted sub-population resets only its
key (``drifted_keys``) while every other warm store survives.

This is the PyTorch port of ``repro.core.multiquery``: the planner,
composer, admission tier, zone pruning and drift guard are the
reference's host code; ``route="device"`` binds to the torch device
stores, whose tick runs the hand-written CUDA fold (and, for COUNT
DISTINCT keys, the CUDA HLL register merge) on the card; ``route="mesh"``
runs that tick on every shard of a cell mesh (``MeshDeviceStack``).
``run(pipeline=True)`` pipelines the mode-groups' ticks on every route:
each chunk's uploads, launches and stat copy run on one worker thread
(``distributed.launch_pool``) while the main thread draws the next
chunk, and a group composes one group later from stat rows read back
through pinned buffers and CUDA events, its answers the serial
schedule's bit for bit.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
import time
import warnings
from collections import OrderedDict
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import sketch as _sketch
from .engine import (AUTO_SKEW_THRESHOLD, MODES, IslaQuery, block_quotas,
                     phase2_iteration_batch, resolve_mode_and_geometry)
from .modulation import empirical_geometry
from .distributed import (launch_pool, phase2, pilot_stats_device,
                          resolve_device)
from .moment_store import (DeviceMomentStore, DeviceStack, MeshDeviceStack,
                           MomentStore, iter_chunked_draws,
                           proportional_allocate, split_budget)
from .preestimation import (required_sample_size, run_pilot, sampling_rate,
                            z_score)
from .summarize import summarize
from ..trace import book, stage_trace
from .types import (AggregateResult, Anchor, BlockResultsBatch,
                    Boundaries, IslaParams, Predicate, StoreKey, ZoneMap,
                    ZONE_EMPTY, ZONE_FULL, ZONE_PARTIAL, demand_dominates)

AGGREGATES = ("AVG", "SUM", "COUNT", "VAR", "count_distinct")
# Aggregates served from the store's mergeable HLL register plane rather
# than the moment rows; they ride the same pass/tick but their error bound
# is the sketch's ~1.04/sqrt(m) relative standard error, not Eq. 1.
SKETCH_AGGREGATES = ("count_distinct",)
# Aggregates answered exactly from catalog metadata — they never constrain
# the shared sampling rate.  Only the *unpredicated, ungrouped* form is
# exact: a WHERE or GROUP BY makes COUNT an estimate that consumes samples.
EXACT_AGGREGATES = ("COUNT",)
ROUTES = ("host", "device", "mesh")

# Predicate-aware planning floors the estimated selectivity so a predicate
# the pilot barely matched cannot demand a quasi-full scan on its own:
# Eq. 1 inflates the shared rate by 1/selectivity (only matching samples
# count toward any query's m), so selectivity -> 0 would push the rate to
# a full read of every block.  The floor caps that inflation at 100x —
# queries whose TRUE selectivity is below it draw fewer matching samples
# than their (e, beta) demands and degrade to a best-effort bound.  Zone
# maps move the floor to the right denominator: with per-block bounds the
# planner divides by the selectivity *within the residual (undecided)
# blocks only* — provably-empty mass is skipped outright and provably-full
# mass needs no inflation — so a block-clustered predicate stops hitting
# the floor at all.  When even the zone-bounded selectivity falls below
# the floor, the plan emits ``PlannedSelectivityFloorWarning`` instead of
# degrading silently.
MIN_PLANNED_SELECTIVITY = 0.01


class PlannedSelectivityFloorWarning(UserWarning):
    """A query's (zone-bounded) planned selectivity fell below
    ``MIN_PLANNED_SELECTIVITY``: the shared rate was capped at the floor's
    100x inflation, so the answer may not earn its requested (e, beta)
    and will report a best-effort bound."""

# Rows are dicts of equal-length columns; bare arrays mean "measure only".
RowSampler = Callable[[int, np.random.Generator],
                      Union[np.ndarray, Mapping[str, np.ndarray]]]


def table_sampler(columns: Mapping[str, np.ndarray]) -> RowSampler:
    """Uniform-with-replacement row sampler over an in-memory block table
    (the relational sibling of ``preestimation.array_sampler``)."""
    cols = {k: np.asarray(v) for k, v in columns.items()}
    if not cols:
        raise ValueError("table needs at least one column")
    sizes = {v.shape[0] for v in cols.values()}
    if len(sizes) != 1:
        raise ValueError(f"columns must share one length, got {sizes}")
    n_rows = sizes.pop()
    if n_rows == 0:
        raise ValueError("table must be non-empty")

    def sample(n: int, rng: np.random.Generator) -> Mapping[str, np.ndarray]:
        idx = rng.integers(0, n_rows, size=n)
        return {k: v[idx] for k, v in cols.items()}

    return sample


def _is_exact(q: IslaQuery) -> bool:
    return (q.agg in EXACT_AGGREGATES and q.where is None
            and q.group_by is None)


def _pass_key(q: IslaQuery) -> Tuple[Optional[Predicate], Optional[str]]:
    """(where, group_by) — the re-segmentation work shared across queries."""
    return (q.where, q.group_by)


# Per-block deficit vectors scale down to a budget with the same
# largest-remainder rounding the budget splitter's fallback uses.
_scale_quotas = proportional_allocate


@dataclasses.dataclass
class GroupAnswer:
    """One group's row of a GROUP BY answer.

    ``value`` is NaN when the group drew no matching samples (reported,
    never silently substituted); ``est_size`` is the estimated matching
    population of the group (sample-fraction scaled catalog sizes).
    """

    group: int
    value: float
    mean: float
    error_bound: Optional[float]   # on the aggregate scale; None=best-effort
    n_samples: int                 # matching samples observed for the group
    est_size: float


@dataclasses.dataclass
class QueryAnswer:
    """One query's answer + provenance shared with its batch-mates."""

    query: IslaQuery
    value: float          # on the aggregate's own scale
    mean: float           # the underlying leverage-based mean estimate
    error_bound: Optional[float]  # e on the aggregate scale; None = best-effort
    sampling_rate: float
    sample_size: int
    mode: Optional[str] = None          # resolved Phase 2 mode (provenance)
    pass_id: int = 0                    # which shared pass answered it
    groups: Optional[list] = None       # GroupAnswer rows when group_by
    n_matched: Optional[int] = None     # matching samples (where/group_by)
    est_population: Optional[float] = None  # estimated matching rows
    new_samples: Optional[int] = None   # rows drawn fresh for this answer's
                                        # pass (0 = served from warm store)
    half_width: Optional[float] = None  # OBSERVED normal half-width at the
                                        # query's beta, aggregate scale — the
                                        # OLA "answer so far + shrinking
                                        # bound" stream; None = undefined
    served: Optional[str] = None        # admission provenance: None =
                                        # computed, "dedupe" = fanned out
                                        # from an identical same-tick query,
                                        # "subsumed" = answer-cache serve
    dedupe_fanout: int = 1              # queries this computed answer served
                                        # in its tick (>= 1)

    def __float__(self) -> float:
        return float(self.value)


@dataclasses.dataclass
class SharedPass:
    """What one sampling pass produced — everything query composition needs."""

    result: AggregateResult       # mean-query provenance (blocks, boundaries)
    mean: float                   # un-shifted leverage-based mean
    ex2: Optional[float]          # E[X^2] of the shifted stream
    mean_shifted: float           # mean on the shifted stream
    data_size: int
    rate: float
    sample_size: int


@dataclasses.dataclass
class KeyedPass:
    """Per-(group, block) cell statistics for one ``(where, group_by)`` key,
    all on the flattened ``group * n_blocks + block`` segment axis reshaped
    to (n_groups, n_blocks).  Shifted-stream quantities throughout; the
    composer un-shifts."""

    n_groups: int
    partials: np.ndarray       # (G, B) per-cell Phase 2 answers
    cell_counts: np.ndarray    # (G, B) matching samples per cell
    cell_weights: np.ndarray   # (G, B) estimated matching population
    mean_g: np.ndarray         # (G,) leverage-weighted group means (NaN=empty)
    ex2_g: np.ndarray          # (G,) weighted second moments (NaN=empty)
    sigma_g: np.ndarray        # (G,) per-group sample sigma estimates
    plain_mean_g: np.ndarray   # (G,) unweighted matching-sample means
    n_g: np.ndarray            # (G,) matching samples per group
    w_g: np.ndarray            # (G,) estimated matching population per group
    degraded_g: np.ndarray     # (G,) bool: some populated cell hit fallback
    mean_all: float            # grand over matching rows (NaN if none)
    ex2_all: float
    sigma_all: float
    plain_mean_all: float      # unweighted matching-sample mean — always
    n_all: int                 # computed, even on need_mean=False passes
    w_all: float
    degraded_all: bool
    distinct_g: Optional[np.ndarray] = None  # (G,) HLL COUNT DISTINCT
                               # estimates (only on need_distinct passes)
    distinct_all: Optional[float] = None     # estimate over the grand fold


@dataclasses.dataclass
class ModeGroup:
    """One planned shared pass: the queries that resolved to one Phase 2
    mode, and the rate their strictest (predicate-aware) demand set.

    ``block_rates`` is the zone-map pruned plan: a per-block rate vector
    (elementwise max over the group's queries) where a block every query
    provably filters out is rated exactly 0 — no draw, no RNG consumption,
    a deterministic-zero contribution.  ``None`` (no zone map, or zones
    proved nothing) keeps the scalar ``rate`` plan bit-identically."""

    mode: str
    geometry: Optional[tuple]
    rate: float
    query_ids: list
    block_rates: Optional[np.ndarray] = None

    def describe(self) -> str:
        pruned = ""
        if self.block_rates is not None:
            pruned = (f" pruned_blocks="
                      f"{int(np.sum(self.block_rates <= 0.0))}")
        return (f"mode={self.mode} rate={self.rate:.3g} "
                f"queries={self.query_ids}{pruned}")


@dataclasses.dataclass
class QueryPlan:
    """The planner's output: one pilot, one mode-group per resolved Phase 2
    mode, each with a shared predicate-aware sampling rate, and one
    ``Anchor`` per distinct (where, group_by) pass key — refined from the
    predicate-matching pilot rows where support allows, the global anchor
    otherwise."""

    queries: list
    pilot: "object"               # PilotResult
    pilot_columns: Mapping[str, np.ndarray]
    boundaries: Boundaries        # the GLOBAL anchor's boundaries
    shifted_sketch0: float
    mode_groups: list
    anchor: Optional[Anchor] = None        # global anchor
    anchors: Optional[dict] = None         # pass key -> Anchor

    def key_anchor(self, key) -> Anchor:
        """The anchor a (where, group_by) pass key classifies under."""
        if self.anchors and key in self.anchors:
            return self.anchors[key]
        return self.anchor

    def describe(self) -> str:
        lines = [f"plan: {len(self.queries)} queries -> "
                 f"{len(self.mode_groups)} shared pass(es)"]
        for i, mg in enumerate(self.mode_groups):
            lines.append(f"  pass {i}: {mg.describe()}")
        if self.anchors:
            for key, a in self.anchors.items():
                if a.source == "refined":
                    where = key[0].describe() if key[0] else "TRUE"
                    lines.append(f"  key[{where}]: {a.describe()}")
        return "\n".join(lines)


@dataclasses.dataclass
class _CachedPlan:
    """One PlanCache entry: a compiled :class:`QueryPlan` (mode-group
    layout, per-block rate vectors, per-key anchors) plus everything its
    validity hangs on — the frozen pilot identity, the set of predicates
    it planned (per-key drift evicts by predicate), and the zone-map
    verdict snapshot it pruned under (a ``refresh`` that changed no
    verdict the plan actually used keeps the plan)."""

    plan: QueryPlan
    wheres: frozenset          # predicates the plan's pass keys touch
    zone_version: Optional[int]
    zone_status: dict          # where -> per-block verdict array (or None)


@dataclasses.dataclass
class _CachedAnswer:
    """One answer-cache entry: the strongest earned answer on an
    :class:`types.AnswerKey`, valid for subsumption service only while
    its store's sample ledger still reads ``stamp`` (any later top-up
    means a fresher answer exists — recompute, don't serve stale) and
    only for demands its ``(e, beta)`` dominates."""

    e: float
    beta: float
    answer: QueryAnswer
    skey: StoreKey             # the store the answer composed from
    stamp: int                 # store.total_sampled at compose time
    epoch: int = -1            # run epoch the stamp was last re-validated at


# Tick stage names, in execution order.  ``run`` and the device tier
# accumulate per-stage wall seconds under these keys
# (``MultiQueryExecutor.last_stage_times``); serve's admission loop
# reports them.
_STAGES = ("plan", "draw", "h2d", "launch", "readback", "compose")


class _StagedGroup:
    """One mode-group between its launch and its compose.

    ``_launch_group`` draws and dispatches the group's ticks and parks
    everything the compose half needs here; ``_compose_group`` picks it
    up — at once on the serial route, one mode-group later on the
    pipelined one (``run(pipeline=True)``), when ``pending`` holds the
    futures of its chunks' ticks still queued on the launch worker."""

    __slots__ = ("plan", "mg", "pass_id", "rng", "route",
                 "deadline_samples", "persistent", "budget_alloc",
                 "chunk_blocks", "default_mode", "group_stores",
                 "key_aggs", "keys", "dstores", "stack",
                 "device_resident", "covered", "new_samples", "timings",
                 "pending")


def _wait_all(futures) -> Optional[BaseException]:
    """Wait for every future of ``futures`` in order and return the first
    one's error (None if none failed).  Once one has failed, those not yet
    started are cancelled: they would meet the stack the first error left
    unusable, and their errors must not replace it.  Nothing submitted is
    left running, so the caller's next step cannot race the worker."""
    first = None
    for f in futures:
        if first is not None and f.cancel():
            continue
        err = f.exception()
        if first is None:
            first = err
    return first


class MultiQueryExecutor:
    """Shares one pilot + one tagged pass per mode-group across N queries.

    Each pass's sampling rate is driven by the *strictest* of its queries
    (max of the per-query predicate-aware Eq. 1 rates), so every answer
    carries at least its requested confidence wherever the estimated
    selectivity held.

    ``measure`` names the aggregated column when samplers return row dicts
    (bare-array samplers are treated as measure-only rows).
    ``group_domains`` maps each legal ``group_by`` key to its cardinality —
    catalog metadata, exactly like block sizes.
    ``zone_map`` (a ``types.ZoneMap``) enables zone-map block pruning:
    blocks a predicate provably filters out are planned at rate 0 (never
    drawn — a deterministic-zero contribution), provably-full blocks skip
    the mask evaluation, and the Eq. 1 selectivity inflation is bounded
    over only the residual mass (``zone_selectivity``).
    ``device`` is where ``route="device"`` (the default route) keeps its
    stores and runs its tick: ``"cuda"`` (the default; a device-route run
    raises without a card) or ``"cpu"`` (the kernels' plain PyTorch
    versions).  ``mesh`` is the cell mesh ``route="mesh"`` shards the
    stacked cell axis over (a ``launch.mesh.CellMesh``, or a sequence of
    devices, one a shard); None builds ``make_cell_mesh()`` on first use —
    one shard a visible card, or with ``device="cpu"`` one shard on the
    CPU.  ``route="host"`` is the float64 numpy route on the CPU, taken
    only when asked for.
    """

    def __init__(self, block_samplers: Sequence[RowSampler],
                 block_sizes: Sequence[int],
                 params: Optional[IslaParams] = None,
                 measure: str = "value",
                 group_domains: Optional[Mapping[str, int]] = None,
                 refine_anchors: bool = True,
                 anchor_min_support: int = 64,
                 zone_map: Optional[ZoneMap] = None,
                 plan_cache_size: int = 256,
                 device="cuda", mesh=None):
        if len(block_samplers) != len(block_sizes):
            raise ValueError("one sampler per block required")
        # Resolved on the device route's first use: the host route never
        # touches a card, so it runs where there is none.
        self._device_req = device
        self._device: Optional[torch.device] = None
        self.block_samplers = list(block_samplers)
        self.block_sizes = [int(b) for b in block_sizes]
        self.params = params if params is not None else IslaParams()
        self.data_size = int(sum(self.block_sizes))
        self.measure = measure
        self.group_domains = dict(group_domains or {})
        for key, card in self.group_domains.items():
            if int(card) < 1:
                raise ValueError(f"group domain {key!r} needs cardinality "
                                 f">= 1, got {card}")
        # Per-key boundary refinement: every distinct (where, group_by)
        # pass key derives its own Anchor from the pilot rows matching its
        # predicate (Anchor.refine_for_predicate), so leverage separation
        # survives selective and measure-correlated WHERE clauses; keys
        # with thin matching pilot support fall back to the global anchor.
        self.refine_anchors = bool(refine_anchors)
        self.anchor_min_support = int(anchor_min_support)
        # Zone-map pruning: per-block column bounds let the planner PROVE
        # which blocks a predicate filters out (rate them exactly 0) or
        # keeps whole (no mask evaluation), and bound the selectivity over
        # only the residual mass.  None disables pruning — every plan is
        # then the classic scalar-rate plan, bit-identically.
        if zone_map is not None and zone_map.n_blocks != len(block_sizes):
            raise ValueError(
                f"zone map covers {zone_map.n_blocks} blocks, executor "
                f"has {len(block_sizes)}")
        self.zone_map = zone_map
        # Incremental serving state: persistent per-key moment stores plus
        # the pilot anchor (boundaries / sketch0 / shift are frozen on the
        # first incremental run — merged moments cannot be re-classified).
        self._stores: "dict[StoreKey, MomentStore]" = {}
        self._anchor = None
        self._sigma_cache = {}  # (group_by, where) -> per-group sigmas,
        #                         valid only against the frozen anchor pilot
        self._key_anchors = {}  # where -> refined Anchor, frozen with the
        #                         pilot; per-key drift may re-derive an entry
        # Device-resident serving state (route="device"/"mesh",
        # incremental): per-StoreKey device mirrors holding the
        # authoritative moments, and the stacked launch sets built over
        # them per mode-group.
        self._device_stores: "dict[StoreKey, DeviceMomentStore]" = {}
        self._device_stacks: dict = {}
        # route="mesh": the cell mesh the stacked cell axis shards over
        # (built on first use when None).
        self.mesh = mesh
        # Admission tier (warm incremental serving only).  PlanCache:
        # compiled QueryPlans keyed on the priority-stripped batch +
        # (mode, route, overrides); valid only against the frozen pilot,
        # the keys' current anchors, and the zone verdicts the plan
        # pruned under — per-key drift resets and zone refreshes evict
        # exactly the affected entries.  Answer cache: the strongest
        # earned answer per AnswerKey — stored as the flat tuple
        # (agg, where, group_by, resolved mode) for cheap per-query
        # hashing — serving dominated (weaker-(e, beta)) queries with
        # zero new samples while the store ledger is unchanged.
        self.plan_cache_size = int(plan_cache_size)
        self._plan_cache: "OrderedDict[tuple, _CachedPlan]" = OrderedDict()
        self._answer_cache: "OrderedDict[tuple, _CachedAnswer]" = \
            OrderedDict()
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0
        self.plan_cache_evictions = 0
        self.answers_cached = 0
        self.answers_subsumed = 0
        self._run_epoch = 0  # bumped per run(); gates ledger re-validation
        # Tick telemetry: per-stage wall seconds of the LAST run() (plan,
        # draw, h2d, launch, readback, compose) — serve's admission loop
        # accumulates these per tick.
        self.last_stage_times: "dict[str, float]" = {}
        self.plans_prefetched = 0  # cross-tick prefetch_plan() warm hits


    @property
    def device(self) -> torch.device:
        """The device of ``route="device"``, checked on first use."""
        if self._device is None:
            self._device = resolve_device(self._device_req)
        return self._device

    def _active_mesh(self):
        """The mesh ``route="mesh"`` shards over: the one handed to the
        constructor (a sequence of devices becomes a ``CellMesh``), or,
        built here on first use, one shard a visible card (one shard on
        the CPU for an executor on the CPU)."""
        from ..launch.mesh import CellMesh, make_cell_mesh

        if self.mesh is None:
            self.mesh = (make_cell_mesh(devices=[self.device])
                         if self.device.type == "cpu" else make_cell_mesh())
        elif not isinstance(self.mesh, CellMesh):
            self.mesh = make_cell_mesh(devices=self.mesh)
        return self.mesh
    def reset_stores(self) -> None:
        """Drop all warm stores (host and device-resident) and the pilot
        anchor (e.g. after the underlying table changed enough that frozen
        boundaries went stale).  The next incremental run re-pilots and
        starts cold."""
        self._stores.clear()
        self._anchor = None
        self._sigma_cache.clear()
        self._key_anchors.clear()
        self._device_stores.clear()
        self._device_stacks.clear()
        self.plan_cache_evictions += len(self._plan_cache)
        self._plan_cache.clear()
        self._answer_cache.clear()

    # -- staleness ---------------------------------------------------------

    # Drift-guard defaults: pilot re-draw size and the sigma-ratio band a
    # stable table should stay inside.
    _DRIFT_PILOT = 512
    _DRIFT_SIGMA_RATIO = 2.0

    def _draw_probe(self, rng: np.random.Generator,
                    n: Optional[int] = None) -> Mapping[str, np.ndarray]:
        """Block-proportional probe rows (like ``run_pilot``'s draw) —
        full columns kept so per-key predicates can be re-evaluated."""
        n = self._DRIFT_PILOT if n is None else int(n)
        total = float(sum(self.block_sizes))
        draws = []
        for s, bs in zip(self.block_samplers, self.block_sizes):
            nj = max(1, int(round(n * bs / total)))
            draws.append(self._as_rows(s(nj, rng)))
        keys = set(draws[0])
        return {k: np.concatenate([r[k] for r in draws if k in r])
                for k in keys}

    @staticmethod
    def _stats_drifted(mean_ref: float, sigma_ref: float, probe: np.ndarray,
                       z_thresh: float, sigma_ratio: float,
                       ref_support: Optional[int] = None) -> bool:
        """THE drift criterion, shared by the global and per-key guards:
        probe mean more than ``z_thresh`` standard errors from the
        reference (under the larger of the two sigmas, so a variance
        blow-up cannot mask a mean shift), or a sigma ratio outside
        ``[1/sigma_ratio, sigma_ratio]``.  Fewer than two probe rows
        carry no evidence.

        ``ref_support`` is the row count the REFERENCE mean itself was
        estimated from: the comparison is then two-sample (se over
        ``1/n_probe + 1/ref_support``), so a refined anchor derived from
        a few dozen matching pilot rows is not flagged as drifted merely
        because a large probe resolves its own estimation noise."""
        if probe.size < 2:
            return False
        m = float(np.mean(probe))
        sig = float(np.std(probe, ddof=1))
        sig_max = max(sigma_ref, sig, 1e-12)
        n_eff = 1.0 / probe.size
        if ref_support:
            n_eff += 1.0 / float(ref_support)
        z_obs = abs(m - mean_ref) / (sig_max * math.sqrt(n_eff))
        ratio = max(sig, 1e-12) / max(sigma_ref, 1e-12)
        return bool(z_obs > z_thresh
                    or ratio > sigma_ratio or ratio < 1.0 / sigma_ratio)

    def check_drift(self, rng: np.random.Generator,
                    n: Optional[int] = None,
                    z_thresh: float = 6.0,
                    sigma_ratio: Optional[float] = None,
                    probe_columns: Optional[Mapping] = None) -> bool:
        """Cheap staleness probe against the frozen anchor: re-draw a
        small pilot (block-proportional, like ``run_pilot``) and compare
        its mean/sigma with the stored ``sketch0``/``sigma``.

        Returns True when the anchor no longer describes the table — the
        re-drawn mean sits more than ``z_thresh`` standard errors from the
        frozen sketch (under the larger of the two sigmas, so a variance
        blow-up cannot mask a mean shift), or the sigma ratio leaves
        ``[1/sigma_ratio, sigma_ratio]``.  False (no drift) when no
        anchor is frozen yet.  ``probe_columns`` reuses an already-drawn
        probe (the per-key guard shares one draw).
        """
        if self._anchor is None:
            return False
        pilot = self._anchor[0]
        sigma_ratio = (self._DRIFT_SIGMA_RATIO if sigma_ratio is None
                       else float(sigma_ratio))
        if probe_columns is None:
            probe_columns = self._draw_probe(rng, n)
        probe = self._measure_of(probe_columns)
        return self._stats_drifted(pilot.sketch0, pilot.sigma, probe,
                                   z_thresh, sigma_ratio,
                                   ref_support=pilot.pilot_size)

    def drifted_keys(self, probe_columns: Mapping[str, np.ndarray],
                     z_thresh: float = 6.0,
                     sigma_ratio: Optional[float] = None) -> "list":
        """Warm ``StoreKey``s whose own REFINED anchor the probe rows
        contradict — the predicate-matching probe mean/sigma is compared
        against the key's anchor (not the global one), so a drift confined
        to one predicate's sub-population invalidates only that key.
        Keys riding the global anchor are covered by ``check_drift``."""
        sigma_ratio = (self._DRIFT_SIGMA_RATIO if sigma_ratio is None
                       else float(sigma_ratio))
        out = []
        warm = {**{k: s.anchor for k, s in self._stores.items()},
                **{k: s.anchor for k, s in self._device_stores.items()}}
        measure = (self._measure_of(probe_columns) if warm
                   else np.zeros(0))
        for skey, anchor in warm.items():
            if anchor is None or anchor.source != "refined" \
                    or skey.where is None:
                continue
            try:
                m = skey.where.mask(probe_columns)
            except KeyError:
                continue  # probe lacks the predicate column: no evidence
            probe = measure[m]
            if self._stats_drifted(anchor.sketch0 - anchor.shift,
                                   anchor.sigma, probe, z_thresh,
                                   sigma_ratio,
                                   ref_support=anchor.support):
                out.append(skey)
        return out

    def _drop_key_state(self, skey: StoreKey,
                        stores: Optional[dict] = None) -> None:
        """Tear down ONE key's warm state everywhere it lives — host
        store, device mirror (releasing its stack so surviving members
        get their state back), per-key sigma cache, and exactly the
        cached plans / answers that touch this key's predicate.  Every
        other key's store AND cached plan survives untouched."""
        (self._stores if stores is None else stores).pop(skey, None)
        dst = self._device_stores.pop(skey, None)
        if dst is not None and dst._owner is not None:
            dst._owner.release()
        self._sigma_cache.pop((skey.group_by, skey.where), None)
        self._evict_where(skey.where)

    def _evict_where(self, where: Optional[Predicate]) -> None:
        """Evict exactly the cached plans and answers whose pass keys
        include ``where`` — never the whole cache (an unrelated key's
        cached plan must survive a neighbor's drift reset)."""
        stale = [k for k, e in self._plan_cache.items() if where in e.wheres]
        for k in stale:
            del self._plan_cache[k]
        self.plan_cache_evictions += len(stale)
        for akey in [k for k in self._answer_cache if k[1] == where]:
            del self._answer_cache[akey]

    def _reset_key(self, skey: StoreKey,
                   probe_columns: Optional[Mapping] = None) -> None:
        """Drop ONE key's warm state (host store, device mirror, cached
        refined anchor) — every other key's store survives untouched.
        When probe rows are given, the key's anchor is re-derived from
        them immediately (fallback: the frozen global anchor), so the
        key's next store classifies against the drifted sub-population's
        actual frame."""
        self._drop_key_state(skey)
        self._key_anchors.pop(skey.where, None)
        if probe_columns is not None and self._anchor is not None \
                and skey.where is not None and self.refine_anchors:
            g = Anchor.from_pilot(self._anchor[0], self.params)
            self._key_anchors[skey.where] = g.refine_for_predicate(
                probe_columns, skey.where, self.params,
                measure=self.measure,
                min_support=self.anchor_min_support)

    # -- row plumbing ------------------------------------------------------

    def _as_rows(self, drawn) -> Mapping[str, np.ndarray]:
        if isinstance(drawn, Mapping):
            return {k: np.asarray(v) for k, v in drawn.items()}
        return {self.measure: np.asarray(drawn)}

    def _measure_of(self, rows: Mapping[str, np.ndarray]) -> np.ndarray:
        if self.measure not in rows:
            raise KeyError(f"measure column {self.measure!r} not in sampled "
                           f"rows (have: {sorted(rows)})")
        return np.asarray(rows[self.measure], dtype=np.float64)

    def _draw_and_ingest(self, group_stores: Mapping[Tuple, MomentStore],
                         quotas: np.ndarray, rng: np.random.Generator,
                         chunk_blocks: Optional[int] = None) -> None:
        """One tagged pass at explicit per-block quotas, folded into every
        key's store — each store receiving the stream translated by ITS
        OWN anchor shift (per-key anchors may shift differently).

        Per-block draws run in block order (the identical RNG stream the
        plain engine consumes); zero-quota blocks are skipped (deficit
        top-ups).  With ``chunk_blocks`` the rows are drawn and ingested
        that many blocks at a time and dropped immediately — row columns
        are never materialized whole, and the store's carry contract keeps
        the accumulated moments bit-identical to the unchunked draw.
        """
        counted = set()       # one logical round per store per pass
        for chunk, columns, block_ids in self._iter_row_chunks(
                quotas, rng, chunk_blocks):
            raw = self._measure_of(columns)
            shifted = {}      # shift value -> translated stream (shared)
            for key, store in group_stores.items():
                where, group_by = key
                if store.shift not in shifted:
                    shifted[store.shift] = raw + store.shift
                values = shifted[store.shift]
                mask = self._zone_mask(where, columns, block_ids)
                gids = (self._group_ids(group_by, columns)[0]
                        if group_by is not None else None)
                store.ingest(values, block_ids, chunk.chunk_quotas,
                             group_ids=gids, mask=mask,
                             count_round=id(store) not in counted,
                             raw_values=(raw if store.has_sketch
                                         else None))
                counted.add(id(store))

    def _iter_row_chunks(self, quotas: np.ndarray,
                         rng: np.random.Generator,
                         chunk_blocks: Optional[int]):
        """Row-sampler adapter over the SHARED chunked draw loop
        (``moment_store.iter_chunked_draws`` — the same RNG-order /
        quota-padding / round-count contract ``MomentStore.
        continue_rounds`` obeys): yields ``(chunk, columns, block_ids)``
        per chunk with cross-chunk column-agreement validation."""
        quotas = np.asarray(quotas, dtype=np.int64).reshape(-1)
        expected_cols = None  # column agreement holds across the WHOLE pass
        for chunk in iter_chunked_draws(self.block_samplers, quotas, rng,
                                        chunk_blocks):
            raws = [self._as_rows(r) for r in chunk.raws]
            for r in raws:
                if expected_cols is None:
                    expected_cols = set(r)
                elif set(r) != expected_cols:
                    raise ValueError(
                        "block samplers must agree on columns; got "
                        f"{sorted(expected_cols)} vs {sorted(r)}")
            columns = {k: np.concatenate([r[k] for r in raws])
                       for k in expected_cols}
            block_ids = np.repeat(np.asarray(chunk.idx, dtype=np.intp),
                                  [int(quotas[j]) for j in chunk.idx])
            yield chunk, columns, block_ids

    def _zone_mask(self, where: Optional[Predicate],
                   columns: Mapping[str, np.ndarray],
                   block_ids: np.ndarray) -> Optional[np.ndarray]:
        """Predicate match mask with zone short-cuts: rows of provably-full
        blocks are True and rows of provably-empty blocks are False WITHOUT
        evaluating the predicate; only residual-block rows pay the
        comparison.  Bit-identical to ``where.mask`` — the zone verdicts
        are proofs over exact data bounds, never estimates."""
        if where is None:
            return None
        if self.zone_map is None:
            return where.mask(columns)
        status = self.zone_map.status(where)
        if where.column not in columns:
            where.mask(columns)  # raise the standard KeyError
        st = status[np.asarray(block_ids, dtype=np.intp)]
        out = np.empty(st.shape, dtype=bool)
        out[st == ZONE_FULL] = True
        out[st == ZONE_EMPTY] = False
        part = st == ZONE_PARTIAL
        if np.any(part):
            col = np.asarray(columns[where.column])
            out[part] = where.mask({where.column: col[part]})
        return out

    def _target_quotas(self, mg: ModeGroup,
                       deadline_samples: Optional[int]) -> np.ndarray:
        """A mode-group's per-block sample targets: the zone-pruned
        ``block_rates`` plan when present (provably-empty blocks get
        quota 0 — never drawn, no RNG consumed), the scalar ``rate``
        otherwise."""
        rate = mg.block_rates if mg.block_rates is not None else mg.rate
        return np.asarray(
            block_quotas(self.block_sizes, rate, deadline_samples),
            dtype=np.int64)

    def _group_ids(self, key: str, columns: Mapping[str, np.ndarray]
                   ) -> Tuple[np.ndarray, int]:
        if key not in columns:
            raise KeyError(f"group_by column {key!r} not in sampled rows "
                           f"(have: {sorted(columns)})")
        col = np.asarray(columns[key])
        ids = col.astype(np.intp)
        if not np.array_equal(ids, col):
            raise ValueError(f"group_by column {key!r} must be integer-coded")
        return ids, int(self.group_domains[key])

    # -- planning ----------------------------------------------------------

    @staticmethod
    def sampled_queries(queries: Sequence[IslaQuery]) -> "list[IslaQuery]":
        """Queries whose answers actually consume samples (plain COUNT is
        exact from catalog metadata, so its (e, beta) never drives the
        rate; predicated/grouped COUNT is an estimate and does)."""
        return [q for q in queries if not _is_exact(q)]

    def selectivity(self, where: Predicate,
                    pilot_columns: Mapping[str, np.ndarray]
                    ) -> Optional[float]:
        """Predicate match fraction on the pilot rows — PS3-style summary
        statistics steering the sample budget.  None when the pilot saw no
        rows (all-exact planning probe)."""
        if not pilot_columns:
            return None
        m = where.mask(pilot_columns)
        if m.size == 0:
            return None
        return float(np.mean(m))

    def group_sigmas(self, q: IslaQuery,
                     pilot_columns: Mapping[str, np.ndarray]
                     ) -> "list[float]":
        """Per-group pilot sigma estimates for a GROUP BY query (ddof=1,
        where-masked when the query carries a predicate).  Groups with
        fewer than two matching pilot rows are skipped — the pooled-sigma
        floor in ``_query_rate`` covers them."""
        key = q.group_by
        if (key is None or not pilot_columns or key not in pilot_columns
                or self.measure not in pilot_columns):
            return []
        # Warm incremental ticks re-plan against the SAME frozen pilot
        # (identity-checked), where these sigmas are immutable.
        cacheable = (self._anchor is not None
                     and pilot_columns is self._anchor[1])
        ckey = (key, q.where)
        if cacheable and ckey in self._sigma_cache:
            return self._sigma_cache[ckey]
        col = np.asarray(pilot_columns[key])
        vals = np.asarray(pilot_columns[self.measure], dtype=np.float64)
        m = (q.where.mask(pilot_columns) if q.where is not None
             else np.ones(col.shape, dtype=bool))
        card = int(self.group_domains[key])
        gids = col.astype(np.intp)
        # rows with non-integer or out-of-domain codes carry no sigma vote
        valid = m & (gids == col) & (gids >= 0) & (gids < card)
        gids, gv = gids[valid], vals[valid]
        # One segmented pass instead of a per-group scan: ddof-1 sigma from
        # per-group (count, sum, sumsq) bincounts.
        n = np.bincount(gids, minlength=card).astype(np.float64)
        s1 = np.bincount(gids, weights=gv, minlength=card)
        s2 = np.bincount(gids, weights=gv * gv, minlength=card)
        ok = n >= 2
        safe_n = np.maximum(n, 2.0)
        var = np.maximum(s2 / safe_n - (s1 / safe_n) ** 2, 0.0)
        sig = np.sqrt(var * safe_n / (safe_n - 1.0))
        out = [float(s) for s, good in zip(sig, ok) if good and s > 0]
        if cacheable:
            self._sigma_cache[ckey] = out
        return out

    def _query_rate(self, q: IslaQuery, sigma: float,
                    pilot_columns: Mapping[str, np.ndarray],
                    anchor: Optional[Anchor] = None) -> float:
        """Predicate-aware Eq. 1: base rate for (e, beta), times the group
        cardinality (each group needs its own m), over the estimated
        selectivity (only matching samples count toward any group's m).

        GROUP BY rates take the group-wise max over per-group pilot sigmas
        — a heteroscedastic group whose own sigma exceeds the pooled one
        gets the m its variance actually demands.  The pooled sigma stays
        a floor: the same pass also answers the grand (ungrouped)
        aggregate, whose bound the pooled sigma drives.

        A REFINED per-key ``anchor`` replaces the pooled pilot sigma with
        the matching rows' own sigma — at its upper-confidence value
        (``Anchor.planning_sigma``), since it was estimated from few
        matching rows: a measure-correlated predicate that selects a
        low-variance slice is no longer planned at the whole table's
        variance (the sample-budget half of boundary refinement; the
        boundary half keeps the S/L regions populated so the bound is
        actually earned at that smaller m).
        """
        base, card = self._query_base_rate(q, sigma, pilot_columns, anchor)
        factor = card
        if q.where is not None:
            sel = self.selectivity(q.where, pilot_columns)
            if sel is not None:
                if (sel < MIN_PLANNED_SELECTIVITY
                        and self._zone_masses(q.where) is None):
                    # With a helpful zone map the scalar rate is
                    # provenance only — the pruned plan warns (or not)
                    # from its own zone-bounded selectivity.
                    self._warn_floor(q.where, sel)
                factor /= max(sel, MIN_PLANNED_SELECTIVITY)
        return min(1.0, base * factor)

    def _query_base_rate(self, q: IslaQuery, sigma: float,
                         pilot_columns: Mapping[str, np.ndarray],
                         anchor: Optional[Anchor]) -> Tuple[float, float]:
        """The selectivity-free half of the Eq. 1 demand: the (group-wise
        max) base rate and the group-cardinality factor."""
        if anchor is not None and anchor.source == "refined":
            sigma = anchor.planning_sigma(q.beta)
        base = sampling_rate(q.e, sigma, q.beta, self.data_size)
        card = 1.0
        if q.group_by is not None:
            for sg in self.group_sigmas(q, pilot_columns):
                base = max(base,
                           sampling_rate(q.e, sg, q.beta, self.data_size))
            card = float(self.group_domains[q.group_by])
        return base, card

    @staticmethod
    def _warn_floor(where: Predicate, sel: float) -> None:
        warnings.warn(
            f"planned selectivity {sel:.3g} for where[{where.describe()}] "
            f"is below MIN_PLANNED_SELECTIVITY={MIN_PLANNED_SELECTIVITY}: "
            f"the rate inflation is capped, so the answer may miss its "
            f"(e, beta) and degrade to a best-effort bound",
            PlannedSelectivityFloorWarning, stacklevel=4)

    def zone_selectivity(self, where: Predicate,
                         pilot_columns: Mapping[str, np.ndarray]
                         ) -> Optional[float]:
        """Zone-bounded selectivity: the predicate's estimated matching
        fraction over the ACTIVE (non-provably-empty) mass only, with the
        provably-full mass counted exactly.

        This is the pruned plan's replacement for the pilot-only
        ``selectivity()``: empty blocks contribute neither matches nor
        draws (they leave both numerator and denominator), and full
        blocks contribute their exact sizes to both — only the residual
        blocks still lean on the pilot estimate, clipped into the
        ``[0, resid_mass]`` range the zone bounds allow.  Returns
        ``None`` when no zone map is attached or the zones prove nothing.
        """
        zp = self._zone_masses(where)
        if zp is None:
            return None
        full_mass, resid_mass, active_mass = zp
        if active_mass <= 0.0:
            return 0.0
        sel_pilot = self.selectivity(where, pilot_columns)
        if sel_pilot is None:
            matched = float(active_mass)  # no pilot: no inflation either
        else:
            matched_resid = np.clip(
                sel_pilot * self.data_size - full_mass, 0.0, resid_mass)
            matched = full_mass + float(matched_resid)
        return matched / active_mass

    def _zone_masses(self, where: Optional[Predicate]
                     ) -> Optional[Tuple[float, float, float]]:
        """(full_mass, resid_mass, active_mass) under the zone map, or
        None when pruning cannot help this predicate."""
        if self.zone_map is None or where is None:
            return None
        status = self.zone_map.status(where)
        if not np.any(status != ZONE_PARTIAL):
            return None  # zones prove nothing: keep the scalar plan
        sizes = np.asarray(self.block_sizes, dtype=np.float64)
        full_mass = float(sizes[status == ZONE_FULL].sum())
        resid_mass = float(sizes[status == ZONE_PARTIAL].sum())
        return full_mass, resid_mass, full_mass + resid_mass

    def _query_block_rates(self, q: IslaQuery, sigma: float,
                           pilot_columns: Mapping[str, np.ndarray],
                           anchor: Optional[Anchor]
                           ) -> Optional[np.ndarray]:
        """Zone-map pruned per-block Eq. 1 rates for one query.

        The query needs ``m = base * card * data_size`` MATCHING samples;
        uniform row sampling at rate r samples matching rows at that same
        rate r, so the pruned plan is a single rate over the active
        (full + residual) blocks —

            rho = base * card * data_size
                  / max(matching_mass, floor * active_mass)

        with ``matching_mass`` the zone-bounded matching estimate
        (``zone_selectivity`` times the active mass) — and exactly 0 on
        every provably-empty block.  With no zone map (or unhelpful
        zones) this degenerates to the scalar plan: active mass =
        data_size and matching mass = sel * data_size recover the classic
        ``base * card / max(sel, floor)``.  Returns None to keep that
        scalar plan.
        """
        zp = self._zone_masses(q.where)
        if zp is None:
            return None
        full_mass, resid_mass, active_mass = zp
        status = self.zone_map.status(q.where)
        rates = np.zeros(len(self.block_sizes), dtype=np.float64)
        if active_mass <= 0.0:
            return rates  # every block provably empty: deterministic zero
        base, card = self._query_base_rate(q, sigma, pilot_columns, anchor)
        sel_zone = self.zone_selectivity(q.where, pilot_columns)
        if sel_zone < MIN_PLANNED_SELECTIVITY:
            self._warn_floor(q.where, sel_zone)
        rho = (base * card * self.data_size
               / (max(sel_zone, MIN_PLANNED_SELECTIVITY) * active_mass))
        rates[status != ZONE_EMPTY] = min(1.0, rho)
        return rates

    def _group_block_rates(self, queries: Sequence[IslaQuery],
                           sigma: float,
                           pilot_columns: Mapping[str, np.ndarray],
                           anchors: Optional[dict]
                           ) -> Optional[np.ndarray]:
        """One mode-group's pruned plan: the elementwise max (union of
        demands) of its queries' per-block rates.  Queries the zones
        cannot help contribute their scalar rate on EVERY block, so a
        block is rated 0 only when every query of the group provably
        filters it out.  None when no query benefits — the scalar plan
        stays authoritative (and bit-identical to the pre-zone planner).
        """
        if self.zone_map is None:
            return None
        sampled = self.sampled_queries(queries)
        if not sampled:
            return None
        anchors = anchors or {}
        per_block = np.zeros(len(self.block_sizes), dtype=np.float64)
        scalar = 0.0
        any_zone = False
        for q in sampled:
            anchor = anchors.get(_pass_key(q))
            br = self._query_block_rates(q, sigma, pilot_columns, anchor)
            if br is None:
                scalar = max(scalar, self._query_rate(q, sigma,
                                                      pilot_columns,
                                                      anchor=anchor))
            else:
                any_zone = True
                per_block = np.maximum(per_block, br)
        if not any_zone:
            return None
        return np.minimum(np.maximum(per_block, scalar), 1.0)

    def plan_rate(self, queries: Sequence[IslaQuery], sigma: float,
                  pilot_columns: Optional[Mapping[str, np.ndarray]] = None,
                  anchors: Optional[dict] = None) -> float:
        """max over the sample-consuming queries of the predicate-aware
        Eq. 1 rate — the shared sample must satisfy the strictest demand.
        ``anchors`` (pass key -> Anchor) supplies refined per-key sigmas."""
        sampled = self.sampled_queries(queries)
        if not sampled:  # all-exact batch: one minimal probe pass
            return sampling_rate(self.params.e, sigma, self.params.beta,
                                 self.data_size)
        cols = pilot_columns if pilot_columns is not None else {}
        anchors = anchors or {}
        return max(self._query_rate(q, sigma, cols,
                                    anchor=anchors.get(_pass_key(q)))
                   for q in sampled)

    def validate(self, queries: Sequence[IslaQuery]) -> None:
        if not queries:
            raise ValueError("need at least one query")
        for q in queries:
            if q.agg not in AGGREGATES:
                raise ValueError(
                    f"unknown aggregate {q.agg!r}; expected one of "
                    f"{AGGREGATES}")
            if q.e <= 0:
                raise ValueError(f"precision must be positive, got {q.e}")
            if not (math.isfinite(q.priority) and q.priority > 0):
                raise ValueError(
                    f"priority must be finite and > 0, got {q.priority}")
            if q.mode is not None and q.mode not in MODES:
                raise ValueError(f"unknown mode {q.mode!r}; expected one of "
                                 f"{MODES}")
            if q.where is not None and not isinstance(q.where, Predicate):
                raise ValueError(f"where must be a Predicate, got "
                                 f"{type(q.where).__name__}")
            if q.group_by is not None and q.group_by not in \
                    self.group_domains:
                raise ValueError(
                    f"unknown group_by key {q.group_by!r}; declare its "
                    f"cardinality via group_domains (have: "
                    f"{sorted(self.group_domains)})")

    # Blocks are i.i.d.-shaped for the bootstrap's purposes (it only seeds
    # the relaxed pilot size), so the executor bootstraps sigma from a
    # strided subset of blocks instead of all of them — at 1000+ blocks the
    # full per-block bootstrap is pure Python-call overhead.
    _BOOTSTRAP_BLOCKS = 128
    _BOOTSTRAP_PER_BLOCK = 64

    def _run_pilot(self, queries: Sequence[IslaQuery],
                   rng: np.random.Generator, params: IslaParams,
                   sigma_guess: Optional[float], stats_fn
                   ) -> Tuple["object", Mapping[str, np.ndarray]]:
        """Pilot over the measure column; the full pilot rows are captured
        so the planner can estimate predicate selectivities from them."""
        captured = []

        def capture(sampler):
            def f(n, r):
                rows = self._as_rows(sampler(n, r))
                captured.append(rows)
                return self._measure_of(rows)
            return f

        if sigma_guess is None:
            stride = max(len(self.block_samplers)
                         // self._BOOTSTRAP_BLOCKS, 1)
            boot = []
            for s in self.block_samplers[::stride]:
                rows = self._as_rows(s(self._BOOTSTRAP_PER_BLOCK, rng))
                captured.append(rows)
                boot.append(self._measure_of(rows))
            sigma_guess = float(np.std(np.concatenate(boot)))
            if sigma_guess <= 0:
                sigma_guess = 1e-9
        pilot = run_pilot([capture(s) for s in self.block_samplers],
                          self.block_sizes, params, rng,
                          sigma_guess=sigma_guess, stats_fn=stats_fn)
        if captured:
            keys = set(captured[0])
            columns = {k: np.concatenate([r[k] for r in captured if k in r])
                       for k in keys}
        else:
            columns = {}
        return pilot, columns

    def _pilot_stats_fn(self, route: str):
        """Device-route pilot (the mesh route's too): the ``pilot_stats``
        kernel on the executor's device.  There is no host fallback — on
        these routes the pilot runs on the device, or the run fails."""
        if route not in ("device", "mesh"):
            return None
        return functools.partial(pilot_stats_device, device=self.device)

    def plan(self, queries: Sequence[IslaQuery], rng: np.random.Generator,
             mode: str = "calibrated", route: str = "device",
             rate_override: Optional[float] = None,
             sigma_guess: Optional[float] = None,
             pilot=None, pilot_columns=None) -> QueryPlan:
        """Parse + plan a query batch: run the pilot, resolve each query's
        Phase 2 mode, group queries by resolved mode, and set one shared
        predicate-aware rate per mode-group.

        Passing a cached ``pilot`` (+ its ``pilot_columns``) skips the
        pilot draw entirely — the warm incremental path, where the anchor
        (boundaries, sketch0, shift) must stay frozen so merged store
        moments remain classifiable."""
        self.validate(queries)
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; expected one of "
                             f"{ROUTES}")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of "
                             f"{MODES}")
        sampled = self.sampled_queries(queries) or [
            IslaQuery(e=self.params.e, beta=self.params.beta)]
        params = self.params.replace(e=min(q.e for q in sampled),
                                     beta=max(q.beta for q in sampled))
        if pilot is None:
            pilot, pilot_columns = self._run_pilot(
                queries, rng, params, sigma_guess,
                self._pilot_stats_fn(route))
        elif pilot_columns is None:
            pilot_columns = {}
        global_anchor = Anchor.from_pilot(pilot, params)
        shifted_sketch0 = global_anchor.sketch0
        boundaries = global_anchor.boundaries
        anchors = {_pass_key(q): None for q in queries}
        for key in anchors:
            anchors[key] = self._key_anchor(key, global_anchor,
                                            pilot_columns, params)

        # Resolve each distinct requested mode once (the "auto" heuristic
        # and the ISLA-E geometry fit live in resolve_mode_and_geometry).
        # "auto" under a REFINED anchor resolves per pass key instead:
        # the key's matching-row skew picks the solver (a skewed WHERE
        # slice riding a symmetric table must get "empirical", not the
        # table-wide "calibrated" — and vice versa), and an empirical
        # key's ISLA-E geometry is fitted from its matching pilot rows in
        # its own anchor frame.  Such keys bucket into their own
        # mode-group so the per-key geometry stays representable.
        resolved_cache = {}
        buckets = {}
        for i, q in enumerate(queries):
            requested = q.mode if q.mode is not None else mode
            pk = _pass_key(q)
            anchor = anchors.get(pk)
            if (requested == "auto" and anchor is not None
                    and anchor.source == "refined"):
                ck = ("auto:key", pk)
                if ck not in resolved_cache:
                    resolved_cache[ck] = self._resolve_key_mode(
                        anchor, pk, pilot, pilot_columns, params)
                resolved, geometry = resolved_cache[ck]
                bkey = (resolved, pk if geometry is not None else None)
            else:
                if requested not in resolved_cache:
                    resolved_cache[requested] = resolve_mode_and_geometry(
                        pilot, params, requested)
                resolved, geometry = resolved_cache[requested]
                bkey = (resolved, None)
            buckets.setdefault(bkey, (geometry, []))[1].append(i)

        mode_groups = []
        for (resolved, _), (geometry, ids) in buckets.items():
            qs = [queries[i] for i in ids]
            rate = (rate_override if rate_override is not None
                    else self.plan_rate(qs, pilot.sigma, pilot_columns,
                                        anchors=anchors))
            block_rates = (None if rate_override is not None
                           else self._group_block_rates(
                               qs, pilot.sigma, pilot_columns, anchors))
            mode_groups.append(ModeGroup(mode=resolved, geometry=geometry,
                                         rate=rate, query_ids=ids,
                                         block_rates=block_rates))
        return QueryPlan(queries=list(queries), pilot=pilot,
                         pilot_columns=pilot_columns, boundaries=boundaries,
                         shifted_sketch0=shifted_sketch0,
                         mode_groups=mode_groups, anchor=global_anchor,
                         anchors=anchors)

    # -- admission tier: plan cache + answer subsumption -------------------

    def _plan_entry_valid(self, entry: _CachedPlan) -> bool:
        """A cached plan survives a zone-map ``refresh`` iff no verdict
        it actually pruned under changed — the version bump alone proves
        nothing about THIS plan's predicates.  Verdicts that did hold
        re-pin the entry to the fresh version (one array compare per
        predicate, then O(1) again)."""
        if self.zone_map is None:
            return entry.zone_version is None
        if entry.zone_version == self.zone_map.version:
            return True
        for where, old in entry.zone_status.items():
            if not np.array_equal(self.zone_map.status(where), old):
                return False
        entry.zone_version = self.zone_map.version
        return True

    def _plan_cached(self, queries: Sequence[IslaQuery],
                     rng: np.random.Generator, mode: str, route: str,
                     rate_override: Optional[float],
                     sigma_guess: Optional[float]) -> QueryPlan:
        """``plan()`` through the PlanCache — the warm incremental path,
        where planning consumes no RNG (frozen pilot) and the compiled
        artifacts (mode-group layout, block rate vectors, per-key
        anchors) are pure functions of the batch shape, the frozen
        anchors, and the zone verdicts.  Priorities are stripped from
        the cache key (they steer only the budget waterfill, never the
        plan), so tenants re-weighting a steady workload still hit."""
        pilot, pilot_columns = self._anchor
        norm = tuple(q if q.priority == 1.0
                     else dataclasses.replace(q, priority=1.0)
                     for q in queries)
        ckey = (norm, mode, route, rate_override, sigma_guess)
        entry = self._plan_cache.get(ckey)
        if entry is not None:
            if self._plan_entry_valid(entry):
                self.plan_cache_hits += 1
                self._plan_cache.move_to_end(ckey)
                return entry.plan
            del self._plan_cache[ckey]
            self.plan_cache_evictions += 1
        self.plan_cache_misses += 1
        plan = self.plan(list(norm), rng, mode=mode, route=route,
                         rate_override=rate_override,
                         sigma_guess=sigma_guess, pilot=pilot,
                         pilot_columns=pilot_columns)
        wheres = frozenset(q.where for q in norm)
        zver, zstat = None, {}
        if self.zone_map is not None:
            zver = self.zone_map.version
            zstat = {w: self.zone_map.status(w)
                     for w in wheres if w is not None}
        self._plan_cache[ckey] = _CachedPlan(
            plan=plan, wheres=wheres, zone_version=zver, zone_status=zstat)
        while len(self._plan_cache) > self.plan_cache_size:
            self._plan_cache.popitem(last=False)
            self.plan_cache_evictions += 1
        return plan

    def prefetch_plan(self, queries: Sequence[IslaQuery],
                      mode: str = "calibrated", route: str = "device",
                      rate_override: Optional[float] = None,
                      sigma_guess: Optional[float] = None) -> bool:
        """Cross-tick plan prefetch: compile (or touch) the PlanCache
        entry for ``queries`` NOW — e.g. while the serve loop sits idle
        between ticks with the next tick's batch already queued — so
        that tick's plan stage is a pure cache hit.

        Warm planning consumes no RNG against the frozen pilot, so the
        prefetch is stream-invisible: the next ``run()``'s draws are
        bit-identical whether or not it happened.  Returns False (no-op)
        on a cold executor (no frozen anchor — cold planning WOULD
        consume RNG) or an empty batch."""
        if self._anchor is None or not queries:
            return False
        self._plan_cached(list(queries), None, mode, route,
                          rate_override, sigma_guess)
        self.plans_prefetched += 1
        return True

    def _cache_answer(self, q: IslaQuery, ans: QueryAnswer, skey: StoreKey,
                      stamp: int, default_mode: str) -> None:
        """Record an earned, fully-covered answer for subsumption service.
        At an unchanged ledger stamp a strictly weaker new entry never
        displaces a dominating one (the strong answer serves more asks);
        any fresher stamp always wins — only it can validate."""
        akey = (q.agg, q.where, q.group_by, q.mode or default_mode)
        prev = self._answer_cache.get(akey)
        if prev is not None and prev.stamp == stamp \
                and demand_dominates(prev.e, prev.beta, q.e, q.beta):
            return
        self._answer_cache[akey] = _CachedAnswer(
            e=q.e, beta=q.beta, answer=ans, skey=skey, stamp=stamp,
            epoch=self._run_epoch)
        self._answer_cache.move_to_end(akey)
        self.answers_cached += 1
        while len(self._answer_cache) > 4 * self.plan_cache_size:
            self._answer_cache.popitem(last=False)

    def lookup_answer(self, query: IslaQuery,
                      mode: str = "calibrated") -> Optional[QueryAnswer]:
        """Serve ``query`` from the subsumption answer cache with ZERO
        new samples, or return None.

        A hit requires an earned answer on the same :class:`AnswerKey`
        whose ``(e, beta)`` dominates the ask (``demand_dominates``: at
        least as precise AND at least as confident — the served bound is
        therefore never looser than asked) and whose store ledger is
        byte-unchanged since compose time (``total_sampled`` stamp; the
        device mirror is the authoritative ledger on the device
        route).  ``mode`` is the run-level default the query's own
        ``mode`` field would fall back to.  The returned answer carries
        ``new_samples=0`` and ``served="subsumed"``."""
        if self._anchor is None:
            return None
        akey = (query.agg, query.where, query.group_by, query.mode or mode)
        entry = self._answer_cache.get(akey)
        if entry is None:
            return None
        if not demand_dominates(entry.e, entry.beta, query.e, query.beta):
            return None
        if entry.epoch != self._run_epoch:
            # Ledger stamps only move inside run(); re-sum the ledger at
            # most once per run epoch, not per served query.
            led = self._device_stores.get(entry.skey)
            if led is None:
                led = self._stores.get(entry.skey)
            if led is None or led.total_sampled != entry.stamp:
                # Store gone or topped up since compose: a fresher answer
                # exists (or will) — drop the stale entry instead of
                # serving.
                self._answer_cache.pop(akey, None)
                return None
            entry.epoch = self._run_epoch
        self.answers_subsumed += 1
        ans = copy.copy(entry.answer)  # field-introspection-free replace
        ans.query = query
        ans.new_samples = 0
        ans.served = "subsumed"
        ans.dedupe_fanout = 1
        return ans

    def _key_anchor(self, key, global_anchor: Anchor,
                    pilot_columns: Mapping[str, np.ndarray],
                    params: IslaParams) -> Anchor:
        """One pass key's anchor: refined from the predicate-matching
        pilot rows when enabled and supported, the global anchor
        otherwise.  Refined anchors are cached against the FROZEN pilot
        (same identity check as the sigma cache), so warm incremental
        ticks re-plan under byte-identical frames — except where a
        per-key drift reset re-derived the entry from fresher probe rows
        (``_reset_key``), which deliberately wins over re-refining from
        the stale pilot."""
        where, _ = key
        if not self.refine_anchors or where is None:
            return global_anchor
        cacheable = (self._anchor is not None
                     and pilot_columns is self._anchor[1])
        if cacheable and where in self._key_anchors:
            return self._key_anchors[where]
        a = global_anchor.refine_for_predicate(
            pilot_columns, where, params, measure=self.measure,
            min_support=self.anchor_min_support)
        if cacheable:
            self._key_anchors[where] = a
        return a

    def _resolve_key_mode(self, anchor: Anchor, key, pilot,
                          pilot_columns: Mapping[str, np.ndarray],
                          params: IslaParams):
        """Per-key mode="auto" resolution from the REFINED anchor's own
        matching-row skew (``Anchor.skew`` — degenerate slices clamp to
        0, so a near-constant sub-population stays "calibrated").

        When the key resolves "empirical", the ISLA-E band geometry is
        fitted from the pilot rows matching its predicate, in the KEY'S
        anchor frame (its sketch0/sigma/shift) — the global pilot's band
        means say nothing about the slice's conditional shape.  Falls
        back to the global empirical fit when the frozen pilot no longer
        yields matching rows (e.g. the anchor was re-derived from probe
        rows after a per-key drift reset)."""
        if abs(anchor.skew) <= AUTO_SKEW_THRESHOLD:
            return "calibrated", None
        where, _ = key
        vals = None
        if pilot_columns and self.measure in pilot_columns \
                and where is not None:
            try:
                m = np.asarray(where.mask(pilot_columns), dtype=bool)
            except KeyError:
                m = None
            if m is not None and m.any():
                vals = np.asarray(pilot_columns[self.measure],
                                  dtype=np.float64)[m]
        if vals is None or vals.size < 2:
            return resolve_mode_and_geometry(pilot, params, "empirical")
        geometry = empirical_geometry(vals + anchor.shift, anchor.sketch0,
                                      anchor.sigma, params)
        return "empirical", geometry

    # -- execution ---------------------------------------------------------

    def _partials(self, mom_s: np.ndarray, mom_l: np.ndarray,
                  sketch0: float, sigma: float, params: IslaParams,
                  mode: str, geometry, route: str) -> np.ndarray:
        """Phase 2 over stacked (n, 4) cells on the chosen route."""
        if route in ("device", "mesh"):
            return self._device_partials(mom_s, mom_l, sketch0, sigma,
                                         params, mode, geometry)
        return phase2_iteration_batch(mom_s, mom_l, sketch0, params,
                                      mode=mode, geometry=geometry).avg

    def _device_partials(self, mom_s_host: np.ndarray,
                         mom_l_host: np.ndarray, sketch0: float,
                         sigma: float, params: IslaParams, mode: str,
                         geometry) -> np.ndarray:
        """Device route: stacked (n, 4) moments through the branchless
        torch Phase 2 on the executor's device (fp32, scale-normalized —
        ISLA is exactly scale-equivariant)."""
        scale = max(abs(sketch0), sigma, 1e-12)
        pows = np.array([1.0, scale, scale * scale, scale ** 3])
        f32, dev = torch.float32, self.device
        mom_s = torch.as_tensor(mom_s_host / pows, dtype=f32, device=dev)
        mom_l = torch.as_tensor(mom_l_host / pows, dtype=f32, device=dev)
        dev_mode = "faithful" if mode == "faithful_cf" else mode
        dev_geometry = None
        if geometry is not None:
            kappa, b0 = geometry
            dev_geometry = (float(np.float32(kappa)),
                            float(np.float32(b0 / scale)))
        # thr is an absolute stopping threshold on the value axis — it
        # must ride the same normalization or the shrink stops
        # log2(scale) rounds early.
        avg = phase2(mom_s, mom_l, float(np.float32(sketch0 / scale)),
                     params.replace(thr=params.thr / scale),
                     mode=dev_mode, geometry=dev_geometry)
        return avg.to("cpu", torch.float64).numpy() * scale

    def _base_stats(self, plan: QueryPlan, mg: ModeGroup,
                    store: MomentStore, route: str) -> SharedPass:
        """The plain measure pass over ALL samples accumulated in the
        (None, None) key's store — the pre-relational SharedPass every
        unpredicated, ungrouped query composes from."""
        pilot = plan.pilot
        params = self.params
        n = len(self.block_sizes)
        mom_s, mom_l = store.mom_s, store.mom_l
        quotas = store.n_sampled
        if route in ("device", "mesh"):
            partials = self._device_partials(
                mom_s, mom_l, store.sketch0, pilot.sigma, params,
                mg.mode, mg.geometry)
            # avg-only provenance: the torch Phase 2 returns partial answers,
            # not the (alpha, sketch, case) diagnostics of the host solvers.
            blocks = BlockResultsBatch(
                avg=partials, alpha=np.zeros(n), sketch=np.zeros(n),
                case=np.zeros(n, dtype=np.int64), n_iter=np.zeros(n),
                mom_s=mom_s, mom_l=mom_l, n_sampled=quotas)
        else:
            res = phase2_iteration_batch(mom_s, mom_l, store.sketch0,
                                         params, mode=mg.mode,
                                         geometry=mg.geometry)
            partials = res.avg
            blocks = BlockResultsBatch(
                avg=res.avg, alpha=res.alpha, sketch=res.sketch,
                case=res.case, n_iter=res.n_iter, mom_s=mom_s, mom_l=mom_l,
                n_sampled=quotas)

        mean_shifted = summarize(partials, self.block_sizes)
        sample_size = int(quotas.sum())  # actually drawn (deadline-aware)
        ex2 = None
        if store.has_totals:
            # Block-weighted second moment of the shifted stream (VAR
            # reads it).  Blocks a budget-capped draw never reached carry
            # no E[x^2] evidence — averaging them in as zero would drag
            # VAR toward 0 silently, so they are excluded from the weight.
            totals = store.totals
            cnt = totals[:, 0]
            per_block = totals[:, 2] / np.maximum(cnt, 1.0)
            visited = cnt > 0
            if np.all(visited):
                ex2 = summarize(per_block, self.block_sizes)
            elif np.any(visited):
                sizes = np.asarray(self.block_sizes, dtype=np.float64)
                ex2 = float(np.sum(per_block[visited] * sizes[visited])
                            / np.sum(sizes[visited]))
            else:
                ex2 = float("nan")
        result = AggregateResult(
            answer=mean_shifted - store.shift, sketch0=pilot.sketch0,
            sigma=pilot.sigma, sampling_rate=mg.rate,
            sample_size=sample_size, blocks=blocks,
            boundaries=plan.boundaries)
        return SharedPass(result=result, mean=result.answer, ex2=ex2,
                          mean_shifted=mean_shifted,
                          data_size=self.data_size, rate=mg.rate,
                          sample_size=sample_size)

    def _keyed_stats(self, plan: QueryPlan, mg: ModeGroup,
                     store: MomentStore, route: str,
                     need_mean: bool = True,
                     need_distinct: bool = False) -> KeyedPass:
        """Compose one (where, group_by) key's per-cell statistics from its
        store's accumulated (group, block) moments.

        ``need_mean=False`` (COUNT/count_distinct-only keys) skips Phase 2
        — the cell counts alone answer the query; the mean-side fields
        come back NaN and must not be read.  ``need_distinct=True``
        (count_distinct keys) additionally folds the store's HLL register
        plane per group and estimates cardinalities."""
        params = self.params
        n_b = store.n_blocks
        n_groups = store.n_groups
        totals = store.totals
        sigma = (store.anchor.sigma if store.anchor is not None
                 else plan.pilot.sigma)
        if need_mean and store.has_regions:
            mom_s, mom_l = store.mom_s, store.mom_l
            partials = self._partials(
                mom_s, mom_l, store.sketch0, sigma,
                params, mg.mode, mg.geometry, route).reshape(n_groups, n_b)
        else:
            mom_s = mom_l = np.zeros((n_groups * n_b, 4))
            partials = np.full((n_groups, n_b), np.nan)

        cnt = totals[:, 0].reshape(n_groups, n_b)
        s1 = totals[:, 1].reshape(n_groups, n_b)
        s2 = totals[:, 2].reshape(n_groups, n_b)
        sizes = np.asarray(self.block_sizes, dtype=np.float64)
        drawn = np.asarray(store.n_sampled, dtype=np.float64)
        # Estimated matching population per cell: catalog block size scaled
        # by the cell's observed match fraction of the block's cumulative
        # draw (a block a budget-capped draw never reached carries none).
        weights = sizes[None, :] * cnt / np.maximum(drawn, 1.0)[None, :]
        w_g = weights.sum(axis=1)
        n_g = cnt.sum(axis=1).astype(np.int64)
        populated = w_g > 0

        safe_w = np.where(populated, w_g, 1.0)
        mean_g = np.where(populated,
                          (partials * weights).sum(axis=1) / safe_w, np.nan)
        safe_cnt = np.maximum(cnt, 1.0)
        ex2_g = np.where(populated,
                         ((s2 / safe_cnt) * weights).sum(axis=1) / safe_w,
                         np.nan)
        # Plain per-group sample sigma (for the Eq. 1 "bound earned" check).
        safe_n = np.maximum(n_g, 1).astype(np.float64)
        samp_mean = s1.sum(axis=1) / safe_n
        samp_var = np.maximum(s2.sum(axis=1) / safe_n - samp_mean ** 2, 0.0)
        sigma_g = np.where(n_g >= 2,
                           np.sqrt(samp_var * safe_n
                                   / np.maximum(safe_n - 1.0, 1.0)), np.nan)
        # A populated cell that fell back to sketch0 (starved S/L regions)
        # degrades its group's bound to best-effort — the fallback answer is
        # the paper's relaxed-confidence sketch, not an (e, beta) estimate.
        fallback = ((mom_s[:, 0] < params.min_region_count)
                    | (mom_l[:, 0] < params.min_region_count)
                    ).reshape(n_groups, n_b)
        degraded_g = np.any(fallback & (cnt > 0), axis=1)

        w_all = float(w_g.sum())
        n_all = int(n_g.sum())
        if w_all > 0:
            contrib = np.where(populated, mean_g * w_g, 0.0)
            mean_all = float(contrib.sum() / w_all)
            contrib2 = np.where(populated, ex2_g * w_g, 0.0)
            ex2_all = float(contrib2.sum() / w_all)
        else:
            mean_all, ex2_all = float("nan"), float("nan")
        tot_mean = float(s1.sum() / max(n_all, 1))
        tot_var = max(float(s2.sum() / max(n_all, 1)) - tot_mean ** 2, 0.0)
        sigma_all = (math.sqrt(tot_var * n_all / max(n_all - 1, 1))
                     if n_all >= 2 else float("nan"))
        distinct_g = None
        distinct_all = None
        if need_distinct:
            folded = store.group_registers()
            distinct_g = _sketch.estimate(folded)
            distinct_all = float(_sketch.estimate(folded.max(axis=0)))
        return KeyedPass(
            n_groups=n_groups, partials=partials, cell_counts=cnt,
            cell_weights=weights, mean_g=mean_g, ex2_g=ex2_g,
            sigma_g=sigma_g,
            plain_mean_g=np.where(n_g > 0, samp_mean, np.nan),
            n_g=n_g, w_g=w_g, degraded_g=degraded_g,
            mean_all=mean_all, ex2_all=ex2_all, sigma_all=sigma_all,
            plain_mean_all=(tot_mean if n_all else float("nan")),
            n_all=n_all, w_all=w_all,
            degraded_all=bool(degraded_g.any()),
            distinct_g=distinct_g, distinct_all=distinct_all)

    # -- device-resident execution -----------------------------------------

    @staticmethod
    def _device_mode(mode: str) -> str:
        """Host mode -> branchless torch Phase 2 mode (the loop-based
        "faithful_cf" alias maps onto the device case table)."""
        return "faithful" if mode == "faithful_cf" else mode

    def _ensure_device_store(self, mg: ModeGroup, key,
                             host_store: MomentStore) -> DeviceMomentStore:
        """The device-resident mirror of one ``StoreKey``.  Created fresh
        on device (no upload at all) for a cold key; a host store that
        already accumulated moments (e.g. earlier host-route ticks) is
        promoted with a one-time cold-start upload.  After this the
        device copy is authoritative — moments never come back."""
        skey = StoreKey(where=key[0], group_by=key[1], mode=mg.mode)
        dst = self._device_stores.get(skey)
        if dst is not None and dst.anchor is not None \
                and host_store.anchor is not None \
                and dst.anchor.fingerprint != host_store.anchor.fingerprint:
            # Stale device mirror under a replaced anchor (per-key reset):
            # release it from its stack (survivors keep their state) and
            # rebuild from the fresh host store.
            if dst._owner is not None:
                dst._owner.release()
            self._device_stores.pop(skey, None)
            dst = None
        if dst is not None and dst.has_sketch != host_store.has_sketch:
            # The key's sketch shape changed (a distinct ask arrived and
            # _group_stores rebuilt the host store cold): the old mirror
            # has no register history to keep — rebuild to match.
            if dst._owner is not None:
                dst._owner.release()
            self._device_stores.pop(skey, None)
            dst = None
        if dst is None:
            warm = (host_store.mom_s.any() or host_store.totals.any()
                    or host_store.n_sampled.any())
            if warm:
                dst = DeviceMomentStore.from_host(host_store,
                                                  self.block_sizes,
                                                  device=self.device)
            else:
                dst = DeviceMomentStore.fresh_device(
                    host_store.n_blocks, host_store.boundaries,
                    host_store.sketch0, self.block_sizes,
                    shift=host_store.shift,
                    n_groups=host_store.n_groups,
                    anchor=host_store.anchor,
                    has_sketch=host_store.has_sketch, device=self.device)
            self._device_stores[skey] = dst
        return dst

    def _device_group(self, mg: ModeGroup, group_stores: Mapping,
                      route: str = "device"
                      ) -> Tuple[list, dict, DeviceStack]:
        """One mode-group's stacked launch set: every key's device store
        concatenated onto one cell axis (``DeviceStack``; the mesh-sharded
        ``MeshDeviceStack`` on route="mesh"), cached across ticks so
        steady state re-uploads nothing."""
        keys = list(group_stores)
        dstores = {k: self._ensure_device_store(mg, k, group_stores[k])
                   for k in keys}
        ck = (mg.mode,
              tuple(StoreKey(where=k[0], group_by=k[1], mode=mg.mode)
                    for k in keys))
        stack = self._device_stacks.get(ck)
        mesh = route == "mesh"
        if (stack is None or stack._released
                or isinstance(stack, MeshDeviceStack) != mesh
                or [id(s) for s in stack.stores]
                != [id(dstores[k]) for k in keys]):
            members = [dstores[k] for k in keys]
            stack = (MeshDeviceStack(members, self._active_mesh()) if mesh
                     else DeviceStack(members))
            # Evict entries the adoption released (a key-set change must
            # not pin dead stacked-state copies in device memory).
            self._device_stacks = {
                k: s for k, s in self._device_stacks.items()
                if not s._released}
            self._device_stacks[ck] = stack
        return keys, dstores, stack

    def _draw_and_tick_device(self, stack: DeviceStack, keys: list,
                              dstores: dict, draw: np.ndarray,
                              rng: np.random.Generator,
                              mg: ModeGroup,
                              chunk_blocks: Optional[int],
                              timings=None,
                              defer_stats: bool = False,
                              launch_async: bool = False) -> list:
        """The device-resident pass: the SAME chunked row draw as the
        host path (shared ``iter_chunked_draws`` contract — identical RNG
        stream), but each chunk is folded into every key's store by ONE
        fused tick over the stacked cells instead of per-key host
        bincounts.  Each key's samples enter the tick in that key's OWN
        anchor frame.  An fp32 stack takes the dense payload: the full
        chunk stream crosses once as a block-major pane, plus each key's
        GROUP BY codes / predicate mask, and each key recovers its frame
        from the pane via the stack's per-key affine.  A float64 stack
        takes the tagged payload, as the reference's executor does (the
        bit-exact carry fold; ``DeviceStack.tick(dense=...)`` folds a
        float64 stack too, within 1e-12 of it): each key's matched slice
        is shifted (and scaled) on the host, placed by ``key_seg``, and
        the stack folds the concatenated stream in order by its (key,
        block) run table (``key_runs``; a sketch stack's registers key on
        the raw values' limbs).

        ``launch_async=True`` (the pipelined route) submits each chunk's
        payload build and tick (``run_chunk``) to the one launch worker
        (``distributed.launch_pool``) and returns the futures: the main
        thread goes on to draw the next chunk's rows (the RNG stays on the
        main thread, in serial order) while the worker builds and
        launches this one.  The worker runs the chunks in submission
        order, the serial order, so every cell folds in the serial order
        and the bits are the serial route's; at most three drawn chunks
        wait in its queue.  A chunk's error is raised here or at compose
        (``_wait_all``), the first chunk's first."""
        dev_mode = self._device_mode(mg.mode)
        dense = stack.dtype != torch.float64
        tick_kw = dict(mode=dev_mode, geometry=mg.geometry,
                       timings=timings, defer_stats=defer_stats)

        def run_chunk(chunk, columns, block_ids):
            raw = self._measure_of(columns)
            if dense:
                key_gids, key_valids = [], []
                gid_cache, mask_cache = {}, {}  # shared panes dedupe
                for where, group_by in keys:
                    if where is None:
                        key_valids.append(None)
                    else:
                        if where not in mask_cache:
                            mask_cache[where] = self._zone_mask(
                                where, columns, block_ids)
                        key_valids.append(mask_cache[where])
                    if group_by is None:
                        key_gids.append(None)
                    else:
                        if group_by not in gid_cache:
                            gid_cache[group_by] = self._group_ids(
                                group_by, columns)[0]
                        key_gids.append(gid_cache[group_by])
                stack.tick(self.params, values=raw,
                           quotas=chunk.chunk_quotas,
                           dense=(key_gids, key_valids),
                           count_round=chunk.first, **tick_kw)
                return
            segs, vals, his, los, runs = [], [], [], [], []
            if stack.has_sketch:
                # Register hashes key on the RAW (unshifted) float64 bits
                # — shared across every key regardless of anchor frame.
                hhi, hlo = _sketch.value_limbs(raw)
            shifted = {}  # (shift, scale) -> prepared stream (shared)
            run_cache = {}  # where -> the key's per-block run lengths
            for k_i, key in enumerate(keys):
                where, group_by = key
                dst = dstores[key]
                fkey = (dst.shift, dst.scale)
                if fkey not in shifted:
                    shifted[fkey] = (raw + dst.shift) / dst.scale
                values = shifted[fkey]
                mask = self._zone_mask(where, columns, block_ids)
                gids = (self._group_ids(group_by, columns)[0]
                        if group_by is not None else None)
                segs.append(stack.key_seg(k_i, dst, block_ids, gids, mask))
                vals.append(values if mask is None else values[mask])
                # Each key's slice is block-major: its (key, block) runs
                # ride the stream, so the fold needs no sort.
                if where not in run_cache:
                    run_cache[where] = stack.key_runs(chunk.chunk_quotas,
                                                      mask)
                runs.append(run_cache[where])
                if stack.has_sketch:
                    his.append(hhi if mask is None else hhi[mask])
                    los.append(hlo if mask is None else hlo[mask])
            stack.tick(self.params, values=np.concatenate(vals),
                       seg=np.concatenate(segs), quotas=chunk.chunk_quotas,
                       count_round=chunk.first, runs=np.stack(runs),
                       hash_limbs=((np.concatenate(his), np.concatenate(los))
                                   if stack.has_sketch else None),
                       **tick_kw)

        if not launch_async:
            for chunk, columns, block_ids in self._iter_row_chunks(
                    draw, rng, chunk_blocks):
                run_chunk(chunk, columns, block_ids)
            return []
        pending = []
        chunks = self._iter_row_chunks(draw, rng, chunk_blocks)
        try:
            while True:
                with stage_trace("isla:draw"):
                    item = next(chunks, None)
                if item is None:
                    return pending
                pending.append(launch_pool().submit(run_chunk, *item))
                if len(pending) > 2:
                    pending[-3].result()  # bound the queued drawn rows
        except BaseException:
            err = _wait_all(pending)
            if err is not None:
                raise err
            raise

    def _keyed_stats_device(self, dst: DeviceMomentStore,
                            need_distinct: bool = False) -> KeyedPass:
        """``_keyed_stats`` served from the device tick's group-stat rows:
        the host reads O(groups) reduced statistics, never per-cell
        moments.  Per-cell fields of the ``KeyedPass`` are None — the
        composers only read group-level fields.  ``need_distinct=True``
        reads the tick's folded O(groups) register rows the same way."""
        rows = dst._rows
        s = dst.scale
        n_g = rows[:, 0]
        w_g = rows[:, 1]
        populated = w_g > 0
        safe_w = np.where(populated, w_g, 1.0)
        mean_g = np.where(populated, rows[:, 2] * s / safe_w, np.nan)
        ex2_g = np.where(populated, rows[:, 3] * s * s / safe_w, np.nan)
        s1 = rows[:, 4] * s
        s2 = rows[:, 5] * s * s
        safe_n = np.maximum(n_g, 1.0)
        samp_mean = s1 / safe_n
        samp_var = np.maximum(s2 / safe_n - samp_mean ** 2, 0.0)
        sigma_g = np.where(
            n_g >= 2,
            np.sqrt(samp_var * safe_n / np.maximum(safe_n - 1.0, 1.0)),
            np.nan)
        degraded_g = rows[:, 6] > 0
        w_all = float(w_g.sum())
        n_all = int(round(float(n_g.sum())))
        if w_all > 0:
            mean_all = float(rows[:, 2].sum()) * s / w_all
            ex2_all = float(rows[:, 3].sum()) * s * s / w_all
        else:
            mean_all, ex2_all = float("nan"), float("nan")
        tot_mean = float(s1.sum() / max(n_all, 1))
        tot_var = max(float(s2.sum() / max(n_all, 1)) - tot_mean ** 2, 0.0)
        sigma_all = (math.sqrt(tot_var * n_all / max(n_all - 1, 1))
                     if n_all >= 2 else float("nan"))
        distinct_g = None
        distinct_all = None
        if need_distinct:
            folded = dst.group_registers()
            distinct_g = _sketch.estimate(folded)
            distinct_all = float(_sketch.estimate(folded.max(axis=0)))
        return KeyedPass(
            n_groups=dst.n_groups, partials=None, cell_counts=None,
            cell_weights=None, mean_g=mean_g, ex2_g=ex2_g, sigma_g=sigma_g,
            plain_mean_g=np.where(n_g > 0, samp_mean, np.nan),
            n_g=np.round(n_g).astype(np.int64), w_g=w_g,
            degraded_g=degraded_g, mean_all=mean_all, ex2_all=ex2_all,
            sigma_all=sigma_all,
            plain_mean_all=(tot_mean if n_all else float("nan")),
            n_all=n_all, w_all=w_all,
            degraded_all=bool(degraded_g.any()),
            distinct_g=distinct_g, distinct_all=distinct_all)

    def _base_stats_device(self, plan: QueryPlan, mg: ModeGroup,
                           dst: DeviceMomentStore) -> SharedPass:
        """``_base_stats`` for a device-resident plain key: the host
        fetches only the (n_blocks,) partial answers and the catalog-
        weighted E[x^2] scalar; provenance carries avg-only blocks
        (moments stay resident — reported as zeros, like the device
        route's alpha/sketch diagnostics)."""
        pilot = plan.pilot
        partials = dst.partials_host()           # answers, shifted scale
        mean_shifted = summarize(partials, self.block_sizes)
        rows = dst._rows
        den = float(rows[0, 8])
        ex2 = (float(rows[0, 7]) * dst.scale ** 2 / den if den > 0
               else float("nan"))
        n = len(self.block_sizes)
        sample_size = dst.total_sampled
        blocks = BlockResultsBatch(
            avg=partials, alpha=np.zeros(n), sketch=np.zeros(n),
            case=np.zeros(n, dtype=np.int64), n_iter=np.zeros(n),
            mom_s=np.zeros((n, 4)), mom_l=np.zeros((n, 4)),
            n_sampled=dst.n_sampled.copy())
        result = AggregateResult(
            answer=mean_shifted - dst.shift, sketch0=pilot.sketch0,
            sigma=pilot.sigma, sampling_rate=mg.rate,
            sample_size=sample_size, blocks=blocks,
            boundaries=plan.boundaries)
        return SharedPass(result=result, mean=result.answer, ex2=ex2,
                          mean_shifted=mean_shifted,
                          data_size=self.data_size, rate=mg.rate,
                          sample_size=sample_size)

    # -- composition -------------------------------------------------------

    def _count_bound(self, w: float, n_drawn: int,
                     beta_z: float) -> Optional[float]:
        """Normal-binomial half-width for an estimated COUNT.

        The match fraction is clamped away from {0, 1} by ~1/n (rule-of-
        three flavor): an all-matching or none-matching draw must not claim
        a ±0 bound the sample cannot support.
        """
        if n_drawn <= 0:
            return None
        p = min(max(w / self.data_size, 0.0), 1.0)
        edge = 1.0 / (n_drawn + 2.0)
        p = min(max(p, edge), 1.0 - edge)
        return beta_z * self.data_size * math.sqrt(p * (1.0 - p) / n_drawn)

    def _compose_plain(self, q: IslaQuery, sp: SharedPass, mg: ModeGroup,
                       pass_id: int) -> QueryAnswer:
        """Pre-relational composition — byte-compatible with the flat
        executor: AVG/SUM from the leverage mean, COUNT exact, VAR from the
        shared pass's second moment."""
        # The (e, beta) guarantee requires Eq. 1's sample size; when a
        # deadline cap or a rate_override truncated the draw below it,
        # report best-effort (None) instead of an unearned bound.
        met = sp.sample_size >= required_sample_size(
            q.e, sp.result.sigma, q.beta)
        # OBSERVED half-width at the query's beta — the progressive
        # "answer so far + shrinking bound" stream; unlike error_bound it
        # is reported even before Eq. 1's m is met.
        hw = None
        if sp.sample_size > 0 and math.isfinite(sp.result.sigma):
            hw = (z_score(q.beta) * sp.result.sigma
                  / math.sqrt(sp.sample_size))
        if q.agg == "AVG":
            value, bound, half = sp.mean, (q.e if met else None), hw
        elif q.agg == "SUM":
            value = sp.data_size * sp.mean
            bound = sp.data_size * q.e if met else None
            half = sp.data_size * hw if hw is not None else None
        elif q.agg == "COUNT":
            value, bound, half = float(sp.data_size), 0.0, 0.0
        else:  # VAR — shift-invariant: both terms are on the shifted stream
            value = max(sp.ex2 - sp.mean_shifted * sp.mean_shifted, 0.0)
            bound, half = None, None
        return QueryAnswer(
            query=q, value=float(value), mean=sp.mean, error_bound=bound,
            sampling_rate=sp.rate, sample_size=sp.sample_size, mode=mg.mode,
            pass_id=pass_id, half_width=half)

    def _group_row(self, q: IslaQuery, kp: KeyedPass, g: int, shift: float,
                   n_drawn: int, beta_z: float) -> GroupAnswer:
        n = int(kp.n_g[g])
        w = float(kp.w_g[g])
        mean = float(kp.mean_g[g]) - shift if n else float("nan")
        degraded = bool(kp.degraded_g[g])
        sigma = float(kp.sigma_g[g])
        met = (n > 0 and not degraded and not math.isnan(sigma)
               and n >= required_sample_size(q.e, sigma, q.beta))
        if q.agg == "AVG":
            value = mean
            bound = q.e if met else None
        elif q.agg == "SUM":
            value = w * mean if n else float("nan")
            bound = None  # est. population factor: always best-effort
        elif q.agg == "COUNT":
            value = w
            bound = self._count_bound(w, n_drawn, beta_z)
            # deterministic across batch compositions (see _compose_keyed)
            mean = float(kp.plain_mean_g[g]) - shift if n else float("nan")
        elif q.agg == "count_distinct":
            # HLL estimate over the group's folded register row; the bound
            # is the sketch's standard error — sample-size independent.
            value = float(kp.distinct_g[g])
            bound = _sketch.distinct_error(value, beta_z)
            mean = float(kp.plain_mean_g[g]) - shift if n else float("nan")
        else:  # VAR
            value = (max(float(kp.ex2_g[g]) - float(kp.mean_g[g]) ** 2, 0.0)
                     if n else float("nan"))
            bound = None
        return GroupAnswer(group=g, value=float(value), mean=mean,
                           error_bound=bound, n_samples=n, est_size=w)

    def _compose_keyed(self, q: IslaQuery, kp: KeyedPass, mg: ModeGroup,
                       pass_id: int, shift: float,
                       n_drawn: int) -> QueryAnswer:
        beta_z = z_score(q.beta)
        mean = (kp.mean_all - shift if kp.n_all else float("nan"))
        met = (kp.n_all > 0 and not kp.degraded_all
               and not math.isnan(kp.sigma_all)
               and kp.n_all >= required_sample_size(q.e, kp.sigma_all,
                                                    q.beta))
        # Observed half-width on the matching sub-population (progressive
        # shrinking-bound stream; None when no evidence exists yet).
        hw = None
        if kp.n_all > 0 and not math.isnan(kp.sigma_all):
            hw = beta_z * kp.sigma_all / math.sqrt(kp.n_all)
        if q.agg == "AVG":
            value = mean
            bound = q.e if met else None
            half = hw
        elif q.agg == "SUM":
            value = kp.w_all * mean if kp.n_all else float("nan")
            bound = None
            half = kp.w_all * hw if hw is not None else None
        elif q.agg == "COUNT":
            value = kp.w_all
            bound = self._count_bound(kp.w_all, n_drawn, beta_z)
            half = bound
            # COUNT never estimates a leverage mean (its key may have
            # skipped Phase 2 entirely); report the plain matching-sample
            # mean so the field is deterministic across batch compositions.
            mean = kp.plain_mean_all - shift if kp.n_all else float("nan")
        elif q.agg == "count_distinct":
            # The HLL estimate over every seen sample; unlike COUNT its
            # bound is the register plane's standard error, earned from
            # tick one — so distinct answers always cache/subsume.
            value = kp.distinct_all
            bound = _sketch.distinct_error(value, beta_z)
            half = bound
            mean = kp.plain_mean_all - shift if kp.n_all else float("nan")
        else:  # VAR
            value = (max(kp.ex2_all - kp.mean_all ** 2, 0.0)
                     if kp.n_all else float("nan"))
            bound, half = None, None
        groups = None
        if q.group_by is not None:
            groups = [self._group_row(q, kp, g, shift, n_drawn, beta_z)
                      for g in range(kp.n_groups)]
        return QueryAnswer(
            query=q, value=float(value), mean=mean, error_bound=bound,
            sampling_rate=mg.rate, sample_size=n_drawn, mode=mg.mode,
            pass_id=pass_id, groups=groups, n_matched=kp.n_all,
            est_population=kp.w_all, half_width=half)

    def _group_stores(self, plan: QueryPlan, mg: ModeGroup,
                      stores: Optional[dict]
                      ) -> Tuple[dict, dict]:
        """The per-key stores of one mode-group's pass.

        ``stores`` is the executor's persistent dict (incremental) — keys
        are looked up / created under ``StoreKey(where, group_by, mode)``
        and survive the run.  ``stores=None`` builds fresh ephemeral stores
        (the one-shot path — bit-identical to the pre-store executor).
        Returns ``(key -> store, key -> aggs)``.
        """
        key_aggs = {}
        for i in mg.query_ids:
            q = plan.queries[i]
            key_aggs.setdefault(_pass_key(q), set()).add(q.agg)
        n_b = len(self.block_sizes)
        out = {}
        for key, aggs in key_aggs.items():
            where, group_by = key
            anchor = plan.key_anchor(key)
            n_groups = (int(self.group_domains[group_by])
                        if group_by is not None else 1)
            if stores is not None:
                skey = StoreKey(where=where, group_by=group_by,
                                mode=mg.mode)
                st = stores.get(skey)
                if st is not None and st.anchor is not None \
                        and st.anchor.fingerprint != anchor.fingerprint:
                    # The key's anchor changed (a per-key drift reset
                    # re-derived it): moments classified under the old
                    # cuts cannot merge with the new frame.  Only THIS
                    # key goes cold — warm batch-mates are untouched —
                    # and the new frame is pinned as the key's anchor so
                    # later plans keep resolving to it.
                    self._drop_key_state(skey, stores)
                    if where is not None:
                        self._key_anchors[where] = anchor
                    st = None
                if st is not None and "count_distinct" in aggs \
                        and not st.has_sketch:
                    # A distinct ask arrived on a warm key without a
                    # sketch plane: registers must see EVERY ingested
                    # sample, and history cannot be re-hashed — the key
                    # goes cold and rebuilds with the plane attached.
                    self._drop_key_state(skey, stores)
                    st = None
                if st is None:
                    # Persistent stores always accumulate regions: a later
                    # batch may add an AVG to a key first seen COUNT-only,
                    # and past samples cannot be re-classified.
                    st = MomentStore.from_anchor(
                        n_b, anchor, n_groups=n_groups,
                        has_sketch=("count_distinct" in aggs))
                    stores[skey] = st
            elif key == (None, None):
                # The plain pass always keeps regions (its composed mean
                # is the leverage answer); totals feed VAR's ex2 and the
                # keyed composition count_distinct rides through.
                st = MomentStore.from_anchor(
                    n_b, anchor, n_groups=n_groups,
                    has_totals=("VAR" in aggs or "count_distinct" in aggs),
                    has_sketch=("count_distinct" in aggs))
            else:
                # Keyed passes always need totals (cell weights / counts);
                # COUNT/count_distinct-only keys skip the region sweep.
                st = MomentStore.from_anchor(
                    n_b, anchor, n_groups=n_groups,
                    has_regions=bool(aggs - {"COUNT", "count_distinct"}),
                    has_sketch=("count_distinct" in aggs))
            out[key] = st
        return out, key_aggs

    def _launch_group(self, plan: QueryPlan, mg: ModeGroup, pass_id: int,
                      rng: np.random.Generator, route: str,
                      deadline_samples: Optional[int],
                      prebuilt: Optional[Tuple[dict, dict]] = None,
                      persistent: bool = False,
                      budget_alloc: Optional[int] = None,
                      chunk_blocks: Optional[int] = None,
                      default_mode: str = "calibrated",
                      defer_stats: bool = False,
                      timings=None) -> _StagedGroup:
        """The draw-and-launch half of one mode-group's shared pass.

        ``prebuilt`` is this mode-group's ``(key -> store, key -> aggs)``
        pair from ``_group_stores`` (built once per run).  One-shot
        (``persistent=False``): fresh ephemeral stores, full-quota draw.
        Incremental: persistent stores, and the draw covers only the union
        per-block sample DEFICIT the batch still owes (zero draws when
        every store is already ahead of every quota), optionally scaled
        down to ``budget_alloc`` new samples.

        With ``defer_stats=True`` (the pipelined route) a device-resident
        group's chunk ticks run on the launch worker with their stats
        deferred: this returns once the rows are drawn and the ticks
        queued, and the :class:`_StagedGroup` composes later."""
        t0 = time.perf_counter()
        h0 = timings.get("h2d", 0.0) if timings is not None else 0.0
        l0 = timings.get("launch", 0.0) if timings is not None else 0.0
        target = self._target_quotas(mg, deadline_samples)
        group_stores, key_aggs = prebuilt
        # Device-resident serving: persistent stores on route="device"
        # (one device) or "mesh" (the cell axis sharded over a cell mesh)
        # keep their moments as torch tensors on the device between
        # ticks; the whole tick is one fused tick per mode-group and the
        # host reads only scalar answers / group stats.
        device_resident = bool(persistent and route in ("device", "mesh"))
        keys = dstores = stack = None
        if device_resident:
            keys, dstores, stack = self._device_group(mg, group_stores,
                                                      route)
        covered = persistent
        if persistent:
            union = np.zeros(len(self.block_sizes), dtype=np.int64)
            for key, st in group_stores.items():
                led = dstores[key] if device_resident else st
                union = np.maximum(union, led.deficit(target))
            draw = union
            if budget_alloc is not None:
                draw = _scale_quotas(union, int(budget_alloc))
                # A budget-truncated pass leaves deficit on the table: its
                # answers refine next tick, so they must not enter the
                # subsumption answer cache (a weaker ask served from one
                # would skip the top-up the uncached route still draws).
                covered = int(draw.sum()) == int(union.sum())
        else:
            draw = target
        new_samples = int(draw.sum())
        pending = []
        if device_resident:
            if new_samples:
                pending = self._draw_and_tick_device(
                    stack, keys, dstores, draw, rng, mg, chunk_blocks,
                    timings=timings, defer_stats=defer_stats,
                    launch_async=defer_stats)
            else:
                # Warm repeat: re-solve resident moments (served from the
                # stats cache when nothing changed — zero transfers).
                stack.tick(self.params, mode=self._device_mode(mg.mode),
                           geometry=mg.geometry, timings=timings,
                           defer_stats=defer_stats)
        elif new_samples:
            self._draw_and_ingest(group_stores, draw, rng,
                                  chunk_blocks=chunk_blocks)
        if timings is not None:
            # "draw" is the host-side remainder of this stage: everything
            # that is not a pane upload or a fused dispatch (RNG draws,
            # pane building, deficit math).  With the launches on the
            # worker its h2d and launch clocks run alongside this thread's
            # draws and are not taken off: the stage sum past the wall
            # clock is the overlap.
            spent = time.perf_counter() - t0
            if not pending:
                spent -= ((timings.get("h2d", 0.0) - h0)
                          + (timings.get("launch", 0.0) - l0))
            book(timings, "draw", max(spent, 0.0))
        sg = _StagedGroup()
        sg.plan, sg.mg, sg.pass_id, sg.rng = plan, mg, pass_id, rng
        sg.route, sg.deadline_samples = route, deadline_samples
        sg.persistent, sg.budget_alloc = persistent, budget_alloc
        sg.chunk_blocks, sg.default_mode = chunk_blocks, default_mode
        sg.group_stores, sg.key_aggs = group_stores, key_aggs
        sg.keys, sg.dstores, sg.stack = keys, dstores, stack
        sg.device_resident, sg.covered = device_resident, covered
        sg.new_samples, sg.timings = new_samples, timings
        sg.pending = pending
        return sg

    def _group_stale(self, sg: _StagedGroup) -> bool:
        """True when a per-key reset (drift) landed between ``sg``'s
        launch and its compose: the staged stores are no longer the
        executor's live stores for their keys, so composing from them
        would serve pre-reset stats."""
        if not sg.persistent:
            return False
        if sg.device_resident and sg.stack._released:
            return True
        for key in sg.group_stores:
            skey = StoreKey(where=key[0], group_by=key[1],
                            mode=sg.mg.mode)
            if sg.device_resident:
                if self._device_stores.get(skey) is not sg.dstores[key]:
                    return True
            elif self._stores.get(skey) is not sg.group_stores[key]:
                return True
        return False

    def _compose_group(self, sg: _StagedGroup) -> "list":
        """The compose half: every query of the mode-group composes from
        the staged pass (per distinct (where, group_by) key, one
        re-segmentation).  A pipelined group's queued ticks are waited for
        first (the first chunk's error raises here) and its deferred stat
        copies landed, each tick's run count checked; both waits are
        booked as "readback", not "compose"."""
        if sg.pending:
            # Drain the group's worker ticks before anything reads (or
            # stales) its stores: the wait is the pipeline's exposed
            # device time, booked where the serial route exposed it.
            t_w = time.perf_counter()
            err = _wait_all(sg.pending)
            sg.pending = []
            book(sg.timings, "readback", time.perf_counter() - t_w)
            if err is not None:
                raise err
        if sg.stack is not None:
            sg.stack._land_copies()  # a run-table fault raises here
        if self._group_stale(sg):
            # A drift reset dropped one of this group's keys after its
            # launch was staged.  The reset key's store went cold, so the
            # staged stats must not be served: rebuild the prebuilt pair
            # against the live store dict and re-run the group's launch
            # (the fresh draw legitimately advances the RNG — the reset
            # key NEEDS post-reset samples).
            prebuilt = self._group_stores(sg.plan, sg.mg, self._stores)
            sg = self._launch_group(
                sg.plan, sg.mg, sg.pass_id, sg.rng, sg.route,
                sg.deadline_samples, prebuilt, sg.persistent,
                sg.budget_alloc, sg.chunk_blocks, sg.default_mode,
                timings=sg.timings)
        plan, mg, pass_id, route = sg.plan, sg.mg, sg.pass_id, sg.route
        group_stores, key_aggs = sg.group_stores, sg.key_aggs
        device_resident, dstores = sg.device_resident, sg.dstores
        covered, new_samples = sg.covered, sg.new_samples
        default_mode, timings = sg.default_mode, sg.timings
        t0 = time.perf_counter()
        r0 = timings.get("readback", 0.0) if timings is not None else 0.0
        sp = None  # the plain pass is composed lazily: an all-relational
        keyed = {}  # batch never pays for it
        out = []
        for i in mg.query_ids:
            q = plan.queries[i]
            key = _pass_key(q)
            st = group_stores[key]
            if key == (None, None) and q.agg != "count_distinct":
                if sp is None:
                    sp = (self._base_stats_device(plan, mg, dstores[key])
                          if device_resident
                          else self._base_stats(plan, mg, st, route))
                ans = self._compose_plain(q, sp, mg, pass_id)
            else:
                if key not in keyed:
                    need_distinct = "count_distinct" in key_aggs[key]
                    keyed[key] = (
                        self._keyed_stats_device(
                            dstores[key], need_distinct=need_distinct)
                        if device_resident
                        else self._keyed_stats(
                            plan, mg, st, route,
                            need_mean=bool(key_aggs[key]
                                           - {"COUNT", "count_distinct"}),
                            need_distinct=need_distinct))
                n_drawn = (dstores[key].total_sampled if device_resident
                           else st.total_sampled)
                shift_k = (dstores[key].shift if device_resident
                           else st.shift)
                ans = self._compose_keyed(
                    q, keyed[key], mg, pass_id, shift_k, n_drawn)
            ans.new_samples = new_samples
            if covered and ans.error_bound is not None:
                # Earned + fully-covered: eligible to serve dominated
                # (weaker-(e, beta)) asks with zero new samples until the
                # store's ledger moves.
                stamp = (dstores[key].total_sampled if device_resident
                         else st.total_sampled)
                self._cache_answer(
                    q, ans, StoreKey(where=key[0], group_by=key[1],
                                     mode=mg.mode), stamp, default_mode)
            out.append((i, ans))
        if timings is not None:
            # A lazy row landed during compose is booked as "readback".
            rb = timings.get("readback", 0.0) - r0
            book(timings, "compose", time.perf_counter() - t0 - rb)
        return out

    def _execute_group(self, plan: QueryPlan, mg: ModeGroup, pass_id: int,
                       rng: np.random.Generator, route: str,
                       deadline_samples: Optional[int],
                       prebuilt: Optional[Tuple[dict, dict]] = None,
                       persistent: bool = False,
                       budget_alloc: Optional[int] = None,
                       chunk_blocks: Optional[int] = None,
                       default_mode: str = "calibrated",
                       timings=None) -> "list":
        """One shared sampling pass, launched and composed back to back."""
        return self._compose_group(self._launch_group(
            plan, mg, pass_id, rng, route, deadline_samples, prebuilt,
            persistent, budget_alloc, chunk_blocks, default_mode,
            timings=timings))

    def _budget_allocations(self, plan: QueryPlan,
                            queries: Sequence[IslaQuery],
                            deadline_samples: Optional[int],
                            budget: Optional[int],
                            mg_stores: "list",
                            budget_floor: Optional[int] = None) -> dict:
        """Split a run's NEW-sample budget across its mode-group passes by
        marginal-error reduction (``moment_store.split_budget``): the most
        uncertain stores — fewest matching samples, highest observed sigma
        — absorb the tick's budget first.  ``mg_stores`` holds each
        mode-group's prebuilt (key -> store, key -> aggs) pair.

        ``queries`` is the CALLER's batch (not ``plan.queries``, which a
        PlanCache hit strips of priorities): each pass waterfills at the
        max priority over the queries it answers, so a tenant's weight
        steers the sample split without ever touching the cached plan."""
        if budget is None:
            return {}
        deficits, n_now, sigmas, weights = [], [], [], []
        for mg, (group_stores, _) in zip(plan.mode_groups, mg_stores):
            target = self._target_quotas(mg, deadline_samples)
            union = np.zeros(len(self.block_sizes), dtype=np.int64)
            lo_n, hi_sig = None, float("nan")
            for key, st in group_stores.items():
                # Device-resident keys budget off the device mirror (the
                # authoritative ledger); its stats come from the cached
                # group rows, so this stays transfer-free.
                led = self._device_stores.get(
                    StoreKey(where=key[0], group_by=key[1], mode=mg.mode),
                    st)
                union = np.maximum(union, led.deficit(target))
                n = float(led.matched_total())
                lo_n = n if lo_n is None else min(lo_n, n)
                s = led.sample_sigma()
                if math.isfinite(s) and not math.isfinite(hi_sig):
                    hi_sig = s
                elif math.isfinite(s):
                    hi_sig = max(hi_sig, s)
            deficits.append(int(union.sum()))
            n_now.append(lo_n or 0.0)
            sigmas.append(hi_sig)
            weights.append(max(queries[i].priority for i in mg.query_ids))
        alloc = split_budget(n_now, sigmas, deficits, int(budget),
                             min_per_store=int(budget_floor or 0),
                             weights=weights)
        return {pass_id: int(a) for pass_id, a in enumerate(alloc)}

    def _shared_pass(self, queries: Sequence[IslaQuery],
                     rng: np.random.Generator, mode: str, route: str,
                     rate_override: Optional[float],
                     sigma_guess: Optional[float],
                     deadline_samples: Optional[int]) -> SharedPass:
        """Plan + execute one plain pass for a single-mode batch (compat
        shim over plan()/_base_stats; the full relational path is run())."""
        plan = self.plan(queries, rng, mode=mode, route=route,
                         rate_override=rate_override,
                         sigma_guess=sigma_guess)
        if len(plan.mode_groups) != 1:
            raise ValueError("_shared_pass serves single-mode batches; use "
                             "run() for mixed per-query modes")
        mg = plan.mode_groups[0]
        store = MomentStore.fresh(
            len(self.block_sizes), plan.boundaries, plan.shifted_sketch0,
            shift=plan.pilot.shift,
            has_totals=any(q.agg == "VAR" for q in queries))
        quotas = self._target_quotas(mg, deadline_samples)
        self._draw_and_ingest({(None, None): store}, quotas, rng)
        return self._base_stats(plan, mg, store, route)

    def run(self, queries: Sequence[IslaQuery], rng: np.random.Generator,
            mode: str = "calibrated", route: str = "device",
            rate_override: Optional[float] = None,
            sigma_guess: Optional[float] = None,
            deadline_samples: Optional[int] = None,
            incremental: bool = False,
            budget: Optional[int] = None,
            chunk_blocks: Optional[int] = None,
            drift_check: Optional[float] = None,
            budget_floor: Optional[int] = None,
            pipeline: bool = False) -> "list[QueryAnswer]":
        """Answer every query from one shared sampling pass per mode-group.

        Parameters
        ----------
        queries : sequence of IslaQuery
            The batch; answers come back in query order.
        rng : numpy.random.Generator
            Host RNG every draw (pilot + passes) consumes, in block order.
        mode : str, optional
            Default Phase 2 solver ("faithful", "faithful_cf",
            "calibrated", "empirical", "auto"); a query's own ``mode``
            field overrides it.  The planner groups queries by RESOLVED
            mode and runs one shared pass per group.
        route : str, optional
            Where the pilot, Phase 2 and (incrementally) the whole tick
            run: ``"device"`` (the default: torch on the executor's
            ``device``, fp32 with anchor-scale normalization; the
            incremental stores run float64, bit-exact against the host
            fold, when the torch default dtype is float64) or
            ``"host"`` (float64 numpy on the CPU, when asked for), or
            ``"mesh"`` (the device tick with its cell axis sharded over
            the executor's cell mesh — see its ``mesh`` argument; state
            stays per shard, and only O(groups) rows cross devices).
        rate_override : float, optional
            Bypass Eq. 1 and sample at exactly this rate (experiments).
        sigma_guess : float, optional
            Skip the pilot's sigma bootstrap with a prior estimate.
        deadline_samples : int, optional
            Cap every block's quota (the §VII-F time constraint).
            Answers below their Eq. 1 m degrade the bound honestly.
        incremental : bool, optional
            Serve with persistent state: the first run pilots and FREEZES
            the anchor (per-key refined anchors included), every pass
            merges into a per-``StoreKey`` ``MomentStore``, and later
            runs top up only the per-block sample deficit their queries
            still demand — a repeat predicate at the same (or looser)
            precision is answered from the warm store with ZERO new
            samples (``QueryAnswer.new_samples`` reports the top-up).
        budget : int, optional
            Incremental only: cap this run's total NEW samples, split
            across passes by marginal-error reduction
            (``moment_store.split_budget``) — the deadline-aware tick.
            Budget-starved answers degrade the bound honestly and refine
            over later ticks.
        chunk_blocks : int, optional
            Stream the row draw through chunks of that many blocks
            (O(one-chunk) row memory, bit-identical via the engine's
            carry contract).
        drift_check : float or True, optional
            Incremental only: probe the frozen anchors against a cheap
            pilot re-draw before planning.  A GLOBAL drift (probe mean
            beyond ``z`` standard errors of the frozen sketch, or a 2x
            sigma ratio) drops every warm store and re-pilots cold; a
            drift confined to one refined key's matching sub-population
            resets ONLY that key (its anchor is re-derived from the probe
            rows) while every other warm store survives.  ``True`` uses
            the default z = 6.0.
        budget_floor : int, optional
            Incremental + budget only: per-pass floor handed to
            ``split_budget(min_per_store=...)`` — a flood of new
            predicates cannot starve a nearly-converged store's small
            top-up (admission-loop QoS).
        pipeline : bool, optional
            Software-pipeline the mode-group passes: while group *k*'s
            chunk ticks run on the launch worker (``distributed.
            launch_pool``; uploads, launches and the stat copy on that
            thread's stream), the main thread draws group *k*'s next
            chunk and then group *k+1*'s rows, and group *k* composes one
            group later from stat rows whose copy into pinned host memory
            was started behind a CUDA event (``defer_stats``).  The RNG
            draw order and the per-cell merge order are the serial
            route's exactly (only *when* each stage runs moves; compose
            consumes no RNG), so answers, bounds, draw ledgers and
            float64 state are the serial route's bit for bit.  A chunk's
            error, or a run-table fault found at the readback, raises to
            the caller after every queued tick has ended.  Per-stage wall
            times land in ``last_stage_times`` either way.

        Returns
        -------
        list of QueryAnswer
            One answer per query, in query order, each carrying value,
            bound (None = best-effort), rate/pass provenance and — under
            WHERE / GROUP BY — per-group rows.

        Notes
        -----
        ``route="device"`` with ``incremental=True`` is the DEVICE-
        RESIDENT serving path: every ``StoreKey``'s moments live as torch
        tensors on the executor's device between runs, a mode-group's
        tick is one fused tick over all its keys' stacked cells (the CUDA
        fold onto the resident rows + Phase 2 + group stats), and the host
        reads only scalar answers and O(groups) statistics — moments
        never cross the host boundary in steady state.  Answers match the
        host float64 path within float32 tolerances (float64 stores, with
        the torch default dtype float64, hold the host fold's moment bits);
        per-block provenance
        is avg-only (moment columns report zeros).  The route must stay
        consistent for a given warm state — call ``reset_stores()``
        before switching an executor between warm host and device
        serving.

        ``route="mesh"`` is the same device-resident tick with the
        stacked cell axis SHARDED over a cell mesh (``MeshDeviceStack``):
        each shard keeps its block run's state resident on its device and
        runs the tick kernels on it, and the only cross-device step is
        the reduce of the O(groups) stat rows.  Per-key drift resets
        release state from every shard.  On a one-shard mesh the layout is
        exactly the ``"device"`` path's.
        """
        self._run_epoch += 1  # store ledgers may move: lookups re-validate
        times = self.last_stage_times = dict.fromkeys(_STAGES, 0.0)
        t_plan = time.perf_counter()
        if budget is not None and not incremental:
            raise ValueError(
                "budget caps the incremental deficit top-up; without "
                "incremental=True there is no store ledger to budget "
                "against (use deadline_samples for a per-block quota cap)")
        if budget_floor is not None and budget is None:
            raise ValueError(
                "budget_floor floors the per-pass budget split; it "
                "requires budget=")
        if drift_check is not None and not incremental:
            raise ValueError(
                "drift_check probes the frozen incremental anchor; it "
                "requires incremental=True")
        if incremental and drift_check is not None \
                and self._anchor is not None:
            z = 6.0 if drift_check is True else float(drift_check)
            probe = self._draw_probe(rng)
            if self.check_drift(rng, z_thresh=z, probe_columns=probe):
                self.reset_stores()
            else:
                # Global anchor still holds: check each warm REFINED key
                # against its own anchor; a drifted predicate resets (and
                # re-anchors) only itself.
                for skey in self.drifted_keys(probe, z_thresh=z):
                    self._reset_key(skey, probe_columns=probe)
        if incremental and self._anchor is not None:
            # Warm path: planning consumes no RNG against the frozen
            # pilot, so a PlanCache hit and a fresh plan are stream-
            # identical — a steady-state tick does zero Python planning.
            plan = self._plan_cached(queries, rng, mode, route,
                                     rate_override, sigma_guess)
        else:
            plan = self.plan(queries, rng, mode=mode, route=route,
                             rate_override=rate_override,
                             sigma_guess=sigma_guess)
            if incremental:
                self._anchor = (plan.pilot, plan.pilot_columns)
        stores = self._stores if incremental else None
        mg_stores = [self._group_stores(plan, mg, stores)
                     for mg in plan.mode_groups]
        alloc = (self._budget_allocations(plan, list(queries),
                                          deadline_samples, budget,
                                          mg_stores, budget_floor)
                 if incremental else {})
        times["plan"] = time.perf_counter() - t_plan
        answers = [None] * len(queries)

        def _collect(results):
            for i, ans in results:
                # The cached plan's queries are priority-stripped; hand
                # the caller back ITS query object.
                ans.query = queries[i]
                answers[i] = ans

        if not pipeline:
            for pass_id, mg in enumerate(plan.mode_groups):
                _collect(self._execute_group(
                    plan, mg, pass_id, rng, route, deadline_samples,
                    prebuilt=mg_stores[pass_id], persistent=incremental,
                    budget_alloc=alloc.get(pass_id),
                    chunk_blocks=chunk_blocks, default_mode=mode,
                    timings=times))
            return answers
        # Three-stage software pipeline over the mode-groups: group k's
        # ticks are queued with deferred stats, THEN group k-1 composes
        # (its worker ticks done or finishing, its stat copies landing
        # under group k's draw).  Draw and merge order are the serial
        # route's; only the compose moves, one group later.
        staged = []
        try:
            for pass_id, mg in enumerate(plan.mode_groups):
                staged.append(self._launch_group(
                    plan, mg, pass_id, rng, route, deadline_samples,
                    prebuilt=mg_stores[pass_id], persistent=incremental,
                    budget_alloc=alloc.get(pass_id),
                    chunk_blocks=chunk_blocks, default_mode=mode,
                    defer_stats=True, timings=times))
                if len(staged) == 2:
                    _collect(self._compose_group(staged.pop(0)))
            if staged:
                _collect(self._compose_group(staged.pop()))
        except BaseException:
            # Leave no tick of this run on the worker: the caller's next
            # step must not race it.  The error raised is the first one.
            for sg in staged:
                _wait_all(sg.pending)
            raise
        return answers


def multi_aggregate(block_samplers: Sequence[RowSampler],
                    block_sizes: Sequence[int],
                    queries: Sequence[IslaQuery],
                    rng: np.random.Generator,
                    params: Optional[IslaParams] = None,
                    **kw) -> "list[QueryAnswer]":
    """One-shot convenience: build an executor and run the query batch."""
    run_kw = {k: v for k, v in kw.items()
              if k not in ("measure", "group_domains")}
    ctor_kw = {k: v for k, v in kw.items()
               if k in ("measure", "group_domains")}
    return MultiQueryExecutor(block_samplers, block_sizes, params=params,
                              **ctor_kw).run(queries, rng, **run_kw)
