"""Persistent (group, block) moment state — the online mode as a subsystem.

The paper's signature big-data claim (§VII-A) is that a block's entire
sampling state is its 8 streaming moments, so answers can be refined round
after round without ever recording sampled rows.  ``MomentStore`` is that
state lifted onto the relational (group, block) axis:

 * ``mom_s`` / ``mom_l`` — stacked (n_groups * n_blocks, 4) float64 region
   moment rows on the flattened ``engine.flat_segments`` axis;
 * ``totals`` — (n_groups * n_blocks, 3) plain (count, s1, s2) rows of ALL
   matching samples per cell (the extra accumulators VAR / COUNT / group
   weights compose from);
 * ``n_sampled`` — (n_blocks,) cumulative per-block draws (including
   masked-out rows — the denominator of selectivity-scaled cell weights);
 * ``rounds``, plus the anchor the moments were accumulated under:
   ``boundaries`` (region cuts are FROZEN for the store's lifetime — merged
   moments cannot be re-classified), the Phase 2 ``sketch0`` (re-anchorable,
   see ``reanchor``) and the footnote-1 ``shift``.

``ingest`` merges a fresh tagged pass through the engine's carry-prepend
bincount continuation, so k short rounds are **bit-identical** per cell to
one pass over the concatenated stream; ``continue_rounds`` is the
vectorized §VII-A loop (draw, merge, re-run batched Phase 2), and
``split_budget`` is the deadline-aware allocator the serving tier uses to
divide a tick's sample budget across warm stores by marginal-error
reduction.

The DEVICE-RESIDENT layer keeps that state where the compute is:
``DeviceMomentStore`` holds the same rows as torch tensors on the device
between ticks, ``DeviceStack`` concatenates the warm stores of a
mode-group onto one stacked cell axis, and a continuation round is ONE
fused tick (fp32: ``distributed.fused_tick_dense``, the CUDA fold adds the
fresh samples onto the resident rows in place; float64:
``distributed.fused_tick``, the tagged CUDA fold continues each cell in
stream order, bit-identical to the host carry fold; then Phase 2 and the
group rows; a store with ``has_sketch`` also merges the fresh samples
into its resident HLL register plane through the CUDA ``isla_sketch``
kernel) — the host touches only scalar answers, O(groups) statistics and
folded register rows in steady state.  Stores may carry PER-KEY refined
anchors (``types.Anchor``): the stack keeps one bounds row per distinct
anchor, an inverse-anchor-scale vector and per-key pane affines, so
hetero-anchor keys still share the single tick.  ``iter_chunked_draws`` is the SHARED
chunked draw loop both serving draw paths ride (the RNG-order /
quota-padding / round-count contract).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..kernels.isla_moments import (RunTableError, TaggedRuns,
                                     check_run_count, tagged_run_table)
from . import sketch as _sketch
from .engine import (Sampler, block_quotas, flat_segments,
                     phase1_sampling_batch, phase2_iteration_batch,
                     sample_moments_batch)
from .modulation import ModulationBatchResult
from .summarize import summarize
from .types import Anchor, Boundaries, IslaParams
from ..trace import book, stage_trace


@dataclasses.dataclass
class DrawChunk:
    """One chunk of the shared chunked block-draw loop (see
    ``iter_chunked_draws``)."""

    start: int              # first block of the chunk (inclusive)
    end: int                # one past the last block of the chunk
    idx: "list[int]"        # blocks actually drawn (quota > 0), block order
    raws: list              # raw sampler outputs, aligned with ``idx``
    chunk_quotas: np.ndarray  # (n_blocks,) int64 — this chunk's quota rows
    first: bool             # True for the first non-empty chunk of the pass


def iter_chunked_draws(block_samplers: Sequence[Sampler],
                       quotas: np.ndarray, rng: np.random.Generator,
                       chunk_blocks: Optional[int] = None):
    """THE chunked draw loop: the RNG-order / quota-padding / round-count
    contract shared by ``multiquery._draw_and_ingest`` (row samplers
    fanning into several stores) and ``MomentStore.continue_rounds``
    (scalar samplers into one).  Both paths iterate this generator so they
    cannot silently diverge:

     * **RNG order** — samplers are invoked strictly in block order, one
       call per block with that block's full quota; zero-quota blocks are
       skipped WITHOUT consuming the RNG (deficit top-ups leave satisfied
       blocks' streams untouched).
     * **quota padding** — each chunk yields a full-width ``(n_blocks,)``
       quota row that is zero outside ``[start, end)``, so ingesting a
       chunk advances every store's cumulative ledger identically to the
       unchunked pass.
     * **round count** — exactly one yielded chunk carries ``first=True``
       (the first chunk that draws anything), so callers count one logical
       round per pass regardless of chunking; an all-zero pass yields
       nothing and counts no round.
    """
    n_b = len(block_samplers)
    quotas = np.asarray(quotas, dtype=np.int64).reshape(-1)
    if quotas.shape != (n_b,):
        raise ValueError(f"quotas must be ({n_b},), got {quotas.shape}")
    step = n_b if chunk_blocks is None else int(chunk_blocks)
    if step < 1:
        raise ValueError(f"chunk_blocks must be >= 1, got {chunk_blocks}")
    first = True
    for start in range(0, n_b, step):
        end = min(start + step, n_b)
        idx = [j for j in range(start, end) if quotas[j] > 0]
        if not idx:
            continue
        raws = [block_samplers[j](int(quotas[j]), rng) for j in idx]
        chunk_quotas = np.zeros(n_b, dtype=np.int64)
        chunk_quotas[start:end] = quotas[start:end]
        yield DrawChunk(start=start, end=end, idx=idx, raws=raws,
                       chunk_quotas=chunk_quotas, first=first)
        first = False


def block_deficit(n_sampled: np.ndarray, target_quotas: Sequence[int],
                  n_blocks: int) -> np.ndarray:
    """Per-block samples still owed against a target quota — THE deficit
    formula both store flavors plan with (host ``MomentStore`` and the
    device mirror share it so host- and device-route planning cannot
    desynchronize)."""
    target = np.asarray(target_quotas, dtype=np.int64).reshape(-1)
    if target.shape != (n_blocks,):
        raise ValueError(f"target quotas must be ({n_blocks},), got "
                         f"{target.shape}")
    return np.maximum(target - n_sampled, 0)


@dataclasses.dataclass
class MomentStore:
    """Everything the online mode persists between rounds — O(cells), not
    O(samples)."""

    n_blocks: int
    n_groups: int
    boundaries: Boundaries
    sketch0: float            # shifted-scale Phase 2 anchor (re-anchorable)
    shift: float
    mom_s: np.ndarray         # (n_groups * n_blocks, 4) S-region moments
    mom_l: np.ndarray         # (n_groups * n_blocks, 4) L-region moments
    totals: np.ndarray        # (n_groups * n_blocks, 3) all-sample moments
    n_sampled: np.ndarray     # (n_blocks,) cumulative draws, int64
    rounds: int = 0
    has_regions: bool = True  # False: totals-only store (COUNT-only keys)
    has_totals: bool = True   # False: regions-only (plain AVG/SUM passes
                              # — nothing reads weights/ex2/sample_sigma)
    anchor: Optional[Anchor] = None  # provenance of the frozen frame; its
                              # fingerprint keys warm-store reuse (a key
                              # whose anchor changed cannot merge moments)
    has_sketch: bool = False  # True: an HLL register plane rides every
                              # ingest (COUNT DISTINCT state)
    regs: Optional[np.ndarray] = None  # (n_cells, sketch.M) uint8 HLL
                              # registers; merge = elementwise max, so any
                              # tick partition folds bit-identically

    @staticmethod
    def fresh(n_blocks: int, boundaries: Boundaries, sketch0: float,
              shift: float = 0.0, n_groups: int = 1,
              has_regions: bool = True,
              has_totals: bool = True,
              anchor: Optional[Anchor] = None,
              has_sketch: bool = False) -> "MomentStore":
        if n_blocks < 1 or n_groups < 1:
            raise ValueError(f"need n_blocks, n_groups >= 1; got "
                             f"({n_blocks}, {n_groups})")
        if not (has_regions or has_totals):
            raise ValueError("a store must accumulate regions, totals, or "
                             "both")
        n_cells = n_groups * n_blocks
        return MomentStore(
            n_blocks=n_blocks, n_groups=n_groups, boundaries=boundaries,
            sketch0=float(sketch0), shift=float(shift),
            mom_s=np.zeros((n_cells, 4)), mom_l=np.zeros((n_cells, 4)),
            totals=np.zeros((n_cells, 3)),
            n_sampled=np.zeros(n_blocks, dtype=np.int64),
            has_regions=has_regions, has_totals=has_totals, anchor=anchor,
            has_sketch=has_sketch,
            regs=(np.zeros((n_cells, _sketch.M), dtype=np.uint8)
                  if has_sketch else None))

    @staticmethod
    def from_anchor(n_blocks: int, anchor: Anchor, n_groups: int = 1,
                    has_regions: bool = True,
                    has_totals: bool = True,
                    has_sketch: bool = False) -> "MomentStore":
        """``fresh`` with the frame taken wholesale from an ``Anchor`` —
        the per-key construction path of the incremental executor."""
        return MomentStore.fresh(
            n_blocks, anchor.boundaries, anchor.sketch0,
            shift=anchor.shift, n_groups=n_groups,
            has_regions=has_regions, has_totals=has_totals, anchor=anchor,
            has_sketch=has_sketch)

    @property
    def n_cells(self) -> int:
        return self.n_groups * self.n_blocks

    @property
    def total_sampled(self) -> int:
        return int(self.n_sampled.sum())

    # -- accumulation ------------------------------------------------------

    def ingest(self, values: np.ndarray, block_ids: np.ndarray,
               quotas: np.ndarray, *,
               group_ids: Optional[np.ndarray] = None,
               mask: Optional[np.ndarray] = None,
               chunk_size: Optional[int] = None,
               count_round: bool = True,
               raw_values: Optional[np.ndarray] = None) -> None:
        """Merge one tagged pass into the store.

        ``values`` are on the SHIFTED scale (the caller applies
        ``self.shift``); ``quotas`` is the per-block draw count this pass
        (a (n_blocks,) array — zero for blocks the pass skipped).  The
        merge routes the store's prior rows through the engine's carry, so
        the result is bit-identical per cell to a single accumulation over
        the concatenated stream.

        ``count_round=False`` marks this ingest as a continuation chunk of
        the current logical round (block-chunked draws), so ``rounds``
        counts refinement rounds, not chunks.

        ``raw_values`` (sketch stores) are the UN-shifted measure values —
        the HLL hash-input contract keys registers on raw float64 bits so
        every route and anchor builds the identical plane.  When omitted,
        the store reconstructs them as ``values - shift`` (bit-exact only
        for shift == 0; shifted stores should pass the raw stream).
        """
        quotas = np.asarray(quotas, dtype=np.int64).reshape(-1)
        if quotas.shape != (self.n_blocks,):
            raise ValueError(f"quotas must be ({self.n_blocks},), got "
                             f"{quotas.shape}")
        # Skip the carry only when the store holds nothing at all — NOT
        # merely when rounds == 0, so a store seeded with prior moments
        # (e.g. OnlineBlockState.as_store of a run_block result) merges
        # instead of silently overwriting.  The empty-carry path and a
        # zero-carry prepend are bit-identical; skipping is just cheaper.
        first = (self.rounds == 0 and not self.mom_s.any()
                 and not self.mom_l.any() and not self.totals.any())
        if self.has_regions:
            self.mom_s, self.mom_l = phase1_sampling_batch(
                values, block_ids, self.n_blocks, self.boundaries,
                group_ids=group_ids, n_groups=self.n_groups, mask=mask,
                chunk_size=chunk_size,
                carry=None if first else (self.mom_s, self.mom_l))
        if self.has_totals:
            self.totals = sample_moments_batch(
                values, block_ids, self.n_blocks, group_ids=group_ids,
                n_groups=self.n_groups, mask=mask,
                carry=None if first else self.totals)
        if self.has_sketch:
            raw = (np.asarray(raw_values, dtype=np.float64).reshape(-1)
                   if raw_values is not None
                   else np.asarray(values, dtype=np.float64).reshape(-1)
                   - self.shift)
            seg, _ = flat_segments(
                np.asarray(block_ids).reshape(-1).astype(np.intp),
                self.n_blocks, group_ids, self.n_groups)
            if mask is not None:
                keep = np.asarray(mask, dtype=bool).reshape(-1)
                raw, seg = raw[keep], seg[keep]
            j, rho = _sketch.encode(_sketch.hash_values(raw))
            _sketch.scatter_max(self.regs, seg, j, rho)
        self.n_sampled = self.n_sampled + quotas
        if count_round:
            self.rounds += 1

    # -- sketch plane ------------------------------------------------------

    def group_registers(self) -> np.ndarray:
        """The per-group folded register rows — max over the block axis
        (the mergeable-sketch group aggregate)."""
        if not self.has_sketch:
            raise ValueError("store was built without a sketch plane "
                             "(has_sketch=False)")
        return _sketch.fold_groups(self.regs, self.n_groups)

    def distinct_counts(self) -> np.ndarray:
        """(n_groups,) HLL COUNT DISTINCT estimates of the matching
        measure values seen so far."""
        return _sketch.estimate(self.group_registers())

    # -- solving -----------------------------------------------------------

    def solve(self, params: IslaParams, mode: str = "faithful",
              geometry=None) -> ModulationBatchResult:
        """Re-run the batched Phase 2 over the merged moments (host path;
        the device route feeds ``mom_s``/``mom_l`` to ``distributed.phase2``
        itself)."""
        if not self.has_regions:
            raise ValueError("totals-only store has no region moments to "
                             "solve (built with has_regions=False)")
        return phase2_iteration_batch(self.mom_s, self.mom_l, self.sketch0,
                                      params, mode=mode, geometry=geometry)

    def answer(self, avg: np.ndarray, block_sizes: Sequence[int]) -> float:
        """Summarize per-block partials to the un-shifted grand answer
        (n_groups == 1 stores; grouped stores compose via multiquery)."""
        if self.n_groups != 1:
            raise ValueError("grand answer is the ungrouped summarization; "
                             "grouped stores compose per group")
        return summarize(np.asarray(avg).reshape(-1), list(block_sizes)) \
            - self.shift

    def reanchor(self, avg: np.ndarray) -> float:
        """Re-anchor ``sketch0`` from the merged moments: the cell-count-
        weighted mean of the current partial answers (shifted scale).

        Later rounds then iterate against the refined picture instead of
        the initial rough sketch — the §VII-A continuation bugfix.  Cells
        with no samples carry no weight; an all-empty store keeps its
        anchor.
        """
        w = (self.totals[:, 0] if self.has_totals
             else self.mom_s[:, 0] + self.mom_l[:, 0])
        populated = w > 0
        if self.has_regions and np.any(populated):
            a = np.asarray(avg, dtype=np.float64).reshape(-1)
            self.sketch0 = float(np.sum(a[populated] * w[populated])
                                 / np.sum(w[populated]))
        return self.sketch0

    def continue_rounds(self, block_samplers: Sequence[Sampler],
                        block_sizes: Sequence[int], rate: float,
                        params: IslaParams, rng: np.random.Generator,
                        mode: str = "faithful", geometry=None,
                        max_samples: Optional[int] = None,
                        reanchor: bool = False,
                        chunk_blocks: Optional[int] = None,
                        chunk_size: Optional[int] = None
                        ) -> ModulationBatchResult:
        """One more online round, vectorized: draw a fresh tagged pass at
        ``rate`` (per block, block order — the engine's RNG stream), merge
        it into the store, and re-run the batched Phase 2.

        Parameters
        ----------
        block_samplers : sequence of callables
            ``sampler(n, rng) -> (n,) values`` per block, invoked in block
            order (the engine's RNG-stream contract).
        block_sizes : sequence of int
            Catalog block sizes (drive the per-block quotas).
        rate : float
            Sampling rate for this round (Eq. 1 scale; per-block quota is
            ``ceil(rate * block_size)``).
        params : IslaParams
            Phase 2 tunables.
        rng : numpy.random.Generator
            Host RNG the draw consumes.
        mode : str, optional
            Phase 2 solver ("faithful" maps onto its algebraic closed
            form — the batched path never runs a data-dependent loop).
        geometry : tuple, optional
            ``(kappa, b0)`` pilot geometry, required for
            ``mode="empirical"``.
        max_samples : int, optional
            Per-block quota cap (the §VII-F time-constraint extension).
        reanchor : bool, optional
            Refresh ``sketch0`` from the merged answer after solving, so
            the NEXT round iterates against the refined picture instead of
            the round-0 rough sketch.  The frozen part of the anchor
            (boundaries, shift) never moves.
        chunk_blocks : int, optional
            Draw and fold the round that many blocks at a time — the
            stream is never materialized whole, bit-identical via the
            carry contract.
        chunk_size : int, optional
            Phase 1 prefix-chunking within an ingest (same bit-identity).

        Returns
        -------
        ModulationBatchResult
            Per-block partial answers over the MERGED moments (shifted
            scale; ``answer`` composes the un-shifted grand mean).
        """
        if len(block_samplers) != self.n_blocks:
            raise ValueError(f"store holds {self.n_blocks} blocks, got "
                             f"{len(block_samplers)} samplers")
        if self.n_groups != 1:
            raise ValueError("continue_rounds draws ungrouped streams; "
                             "grouped stores are fed via multiquery")
        quotas = np.asarray(block_quotas(block_sizes, rate, max_samples),
                            dtype=np.int64)
        for chunk in iter_chunked_draws(block_samplers, quotas, rng,
                                        chunk_blocks):
            vals = np.concatenate([np.asarray(r, dtype=np.float64)
                                   for r in chunk.raws]) + self.shift
            ids = np.repeat(np.asarray(chunk.idx, dtype=np.intp),
                            quotas[chunk.idx])
            self.ingest(vals, ids, chunk.chunk_quotas,
                        chunk_size=chunk_size, count_round=chunk.first)
        res = self.solve(params, mode=mode, geometry=geometry)
        if reanchor:
            self.reanchor(res.avg)
        return res

    # -- planning helpers --------------------------------------------------

    def deficit(self, target_quotas: Sequence[int]) -> np.ndarray:
        """Per-block samples still owed against a target quota (what a new
        query's (e, beta) demands minus what the store already drew)."""
        return block_deficit(self.n_sampled, target_quotas, self.n_blocks)

    def matched_total(self) -> float:
        """Total matching samples accumulated (the budget splitter's n)."""
        return float(self.totals[:, 0].sum())

    def sample_sigma(self) -> float:
        """ddof-1 sigma of all matching samples seen so far (NaN until two
        samples exist) — the marginal-error signal ``split_budget`` reads."""
        n = float(self.totals[:, 0].sum())
        if n < 2:
            return float("nan")
        mean = float(self.totals[:, 1].sum()) / n
        var = max(float(self.totals[:, 2].sum()) / n - mean * mean, 0.0)
        return math.sqrt(var * n / (n - 1.0))


# ---------------------------------------------------------------------------
# Device-resident stores: the §VII-A state kept where the compute is.
# ---------------------------------------------------------------------------


def _bucket(m: int, floor: int = 256) -> int:
    """Round a tick's matched-sample count up to a power-of-two bucket so
    the fused launch does not retrace on every tick (padded slots land in
    the drop segment)."""
    b = floor
    while b < m:
        b <<= 1
    return b


def _dense_panes(values: np.ndarray, quotas: np.ndarray):
    """Pack a block-major tagged stream into (n_blocks, quota_bucket)
    panes for the dense fused tick: row-major assignment through the
    ragged-quota mask preserves stream order, the pad mask zeroes the
    tail."""
    quotas = np.asarray(quotas, dtype=np.int64)
    qmax = _bucket(int(quotas.max()), floor=8)
    vmask = np.arange(qmax)[None, :] < quotas[:, None]
    v2d = np.zeros((quotas.shape[0], qmax), dtype=np.float64)
    v2d[vmask] = values
    pad = np.zeros_like(v2d)
    pad[vmask] = 1.0
    return v2d, pad, vmask


class _LazyRows:
    """One tick's stats on their way to the host, shared by every store of
    its stack: the stat rows as float64 with the tick's run counts after
    them in the same copy, and on a sketch stack the folded register rows,
    each copy started by ``distributed.d2h_async``.  A serial tick lands
    them at once; a pipelined one (``tick(defer_stats=True)``) hands each
    store ``_RowsView`` slices and leaves the landing to the first reader.
    Either way the stack lands its ticks' copies in tick order and checks
    each tick's run count before any of its rows is served
    (``DeviceStack._land_copies``)."""

    __slots__ = ("_stack", "_copy", "_regs_copy", "_shape", "_timings",
                 "out")

    def __init__(self, stack: "DeviceStack", rows: torch.Tensor,
                 group_regs, counts, timings) -> None:
        from . import distributed as D

        flat = torch.cat([rows.reshape(-1).to(torch.float64)]
                         + [c.to(rows.device, torch.float64)
                            for c in counts])
        self._stack = stack
        self._copy = D.d2h_async(flat)
        self._regs_copy = (None if group_regs is None
                           else D.d2h_async(group_regs))
        self._shape = tuple(rows.shape)
        self._timings = timings
        self.out = None  # (rows, register rows or None), landed and checked

    def land(self) -> "tuple[np.ndarray, Optional[np.ndarray], int]":
        """Wait for this tick's copies (on their own events): ``(rows,
        register rows or None, run count)``."""
        t0 = time.perf_counter()
        with stage_trace("isla:readback"):
            flat = self._copy.wait().numpy()
            regs = (None if self._regs_copy is None
                    else self._regs_copy.wait().numpy())
        book(self._timings, "readback", time.perf_counter() - t0)
        self._copy = self._regs_copy = None
        n = math.prod(self._shape)
        return flat[:n].reshape(self._shape), regs, int(flat[n:].sum())

    def resolve(self) -> "tuple[np.ndarray, Optional[np.ndarray]]":
        """The landed ``(rows, register rows or None)``; the first call
        lands the stack's copies up to this one (and raises on a run-table
        fault)."""
        if self.out is None:
            self._stack._land_copies(self)
        return self.out


class _RowsView:
    """One store's slice of a ``_LazyRows`` holder: its stat rows, or with
    ``regs`` its folded register rows.  Enough numpy for a direct
    ``tick`` caller (indexing, ``numpy.asarray``, ``shape``); the store
    swaps it for the landed slice at its first read."""

    __slots__ = ("_holder", "_r0", "_r1", "_part")

    def __init__(self, holder: _LazyRows, r0: int, r1: int,
                 regs: bool = False) -> None:
        self._holder, self._r0, self._r1 = holder, int(r0), int(r1)
        self._part = int(regs)

    def materialize(self) -> np.ndarray:
        return self._holder.resolve()[self._part][self._r0:self._r1]

    def __array__(self, dtype=None, copy=None):
        out = self.materialize()
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, idx):
        return self.materialize()[idx]

    @property
    def shape(self):
        return self.materialize().shape


def _landed(src):
    """``src`` itself, or the landed slice of a ``_RowsView``."""
    return src.materialize() if isinstance(src, _RowsView) else src


class DeviceMomentStore:
    """Device-resident mirror of ``MomentStore``: the stacked (group,
    block) moment rows, totals and per-block draw ledger live as torch
    tensors on ``device`` BETWEEN ticks, so a continuation round is one
    fused tick that folds the fresh samples into the resident tensors IN
    PLACE — moments never cross the host boundary in steady state.

    Units: moments are stored on the SHIFTED scale (the host store's
    contract) additionally divided by ``scale`` — the fp32-safety lever
    (ISLA is exactly scale-equivariant).  When the torch default dtype is
    float64 the store defaults to float64 with ``scale=1.0``, where the
    tagged tick's carry-prepend fold is **bit-identical** to the host
    bincount path (``default_dtype``).

    ``has_sketch=True`` adds the COUNT DISTINCT plane: ``regs``, a resident
    (n_cells, 4096) uint8 HLL register plane keyed on the RAW measure bits,
    updated in place by every tick and bit-identical to the host
    ``MomentStore`` plane of the same samples.

    The per-block cumulative draw ledger is kept twice: an int64 host
    copy (``n_sampled`` — planning/deficit math stays host-side) and a
    device copy feeding the cell-weight computation of the tick.
    """

    def __init__(self, n_blocks: int, n_groups: int, boundaries: Boundaries,
                 sketch0: float, shift: float, scale: float,
                 block_sizes: Sequence[int], dtype=torch.float32,
                 anchor: Optional[Anchor] = None,
                 has_sketch: bool = False, device="cuda") -> None:
        from . import distributed as D

        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"device stores run float32 or float64, not "
                             f"{dtype}")
        if len(block_sizes) != n_blocks:
            raise ValueError(f"need {n_blocks} block sizes, got "
                             f"{len(block_sizes)}")
        self.device = D.resolve_device(device)
        self.n_blocks = int(n_blocks)
        self.n_groups = int(n_groups)
        self.boundaries = boundaries
        self.sketch0 = float(sketch0)
        self.shift = float(shift)
        self.scale = float(scale)
        self.anchor = anchor
        self.block_sizes = [int(b) for b in block_sizes]
        self.dtype = dtype
        self.has_sketch = bool(has_sketch)
        n_cells = self.n_groups * self.n_blocks
        # Resident state: owned directly until a DeviceStack adopts the
        # store, after which the stacked tensors are authoritative and
        # these hold None (see the properties below).
        self._owner = None
        zeros = functools.partial(torch.zeros, dtype=dtype,
                                  device=self.device)
        self._mom_s = zeros((n_cells, 4))
        self._mom_l = zeros((n_cells, 4))
        self._totals = zeros((n_cells, 3))
        self._ns_dev = zeros((self.n_blocks,))
        self._regs = (torch.zeros((n_cells, _sketch.M), dtype=torch.uint8,
                                  device=self.device)
                      if self.has_sketch else None)
        self._group_regs = None  # last tick's folded (n_groups, M) rows
        self.n_sampled = np.zeros(self.n_blocks, dtype=np.int64)
        self.rounds = 0
        # Anchor constants, uploaded once at store creation (cold start —
        # the steady-state tick never re-ships them).
        self._bounds = D.h2d(
            np.asarray(boundaries.as_tuple(), dtype=np.float64)
            / self.scale, dtype, self.device)
        self._sizes = D.h2d(np.asarray(self.block_sizes, dtype=np.float64),
                            dtype, self.device)
        self._sketch0_dev = D.h2d(self.sketch0 / self.scale, dtype,
                                  self.device)
        # Per-tick stats cache (invalidated by any state change; keyed by
        # the solve configuration so a different mode re-solves).
        self._partials = None   # (n_cells,) device, scaled shifted units
        self._rows = None       # (n_groups, 9) float64 numpy, or a lazy
                                # _RowsView after a pipelined tick
        self._stats_valid = False
        self._stats_cfg = None  # (params, mode, geometry) of the cache
        self._stack = None      # cached single-store DeviceStack

    # -- resident state (stack-aware) --------------------------------------

    def _detach(self) -> None:
        """Materialize this store's slices out of its owning stack (the
        whole stack releases — a store cannot leave alone)."""
        if self._owner is not None:
            self._owner.release()

    def _state_attr(self, name: str, idx: int):
        if self._owner is not None:
            return self._owner.state_slice(self, idx)
        return getattr(self, name)

    def _set_state(self, name: str, v) -> None:
        self._detach()
        setattr(self, name, torch.as_tensor(v, dtype=self.dtype,
                                            device=self.device))
        self._stats_valid = False

    @property
    def _rows(self):
        """The cached (n_groups, 9) group-stat rows, float64 numpy.  After
        a pipelined tick the cache holds a lazy ``_RowsView`` (the rows
        still on their way back); the first read lands it and keeps the
        numpy slice.  ``_rows_src`` is the cache as it stands."""
        src = self._rows_src = _landed(self._rows_src)
        return src

    @_rows.setter
    def _rows(self, v):
        self._rows_src = v

    @property
    def mom_s(self):
        return self._state_attr("_mom_s", 0)

    @mom_s.setter
    def mom_s(self, v):
        self._set_state("_mom_s", v)

    @property
    def mom_l(self):
        return self._state_attr("_mom_l", 1)

    @mom_l.setter
    def mom_l(self, v):
        self._set_state("_mom_l", v)

    @property
    def totals(self):
        return self._state_attr("_totals", 2)

    @totals.setter
    def totals(self, v):
        self._set_state("_totals", v)

    @property
    def _n_sampled_dev(self):
        return self._state_attr("_ns_dev", 3)

    @_n_sampled_dev.setter
    def _n_sampled_dev(self, v):
        self._set_state("_ns_dev", v)

    @property
    def regs(self):
        """The resident (n_cells, 4096) uint8 register plane (None
        without a sketch plane)."""
        if not self.has_sketch:
            return None
        return self._state_attr("_regs", 4)

    @regs.setter
    def regs(self, v):
        if not self.has_sketch:
            raise ValueError("store was built without a sketch plane "
                             "(has_sketch=False)")
        self._detach()
        self._regs = torch.as_tensor(v, dtype=torch.uint8,
                                     device=self.device)
        self._stats_valid = False

    # -- construction ------------------------------------------------------

    @staticmethod
    def default_dtype():
        """float64 (the exact mode) when the torch default dtype is
        float64, else float32 — the reference's ``jax_enable_x64`` test."""
        return (torch.float64 if torch.get_default_dtype() == torch.float64
                else torch.float32)

    @staticmethod
    def anchor_scale(boundaries: Boundaries, sketch0: float) -> float:
        """fp32-safety normalizer frozen with the anchor: the largest
        magnitude the S/L band can produce (outliers beyond the cuts feed
        only the plain totals, whose squares stay in fp32 range)."""
        return max(abs(boundaries.s_lo), abs(boundaries.l_hi),
                   abs(float(sketch0)), 1e-12)

    @staticmethod
    def fresh_device(n_blocks: int, boundaries: Boundaries, sketch0: float,
                     block_sizes: Sequence[int], shift: float = 0.0,
                     n_groups: int = 1, scale: Optional[float] = None,
                     dtype=None, anchor: Optional[Anchor] = None,
                     has_sketch: bool = False,
                     device="cuda") -> "DeviceMomentStore":
        if dtype is None:
            dtype = DeviceMomentStore.default_dtype()
        if scale is None:
            scale = (1.0 if dtype == torch.float64
                     else DeviceMomentStore.anchor_scale(boundaries,
                                                         sketch0))
        return DeviceMomentStore(n_blocks, n_groups, boundaries,
                                 float(sketch0), float(shift), float(scale),
                                 block_sizes, dtype, anchor=anchor,
                                 has_sketch=has_sketch, device=device)

    @staticmethod
    def from_host(store: MomentStore, block_sizes: Sequence[int],
                  scale: Optional[float] = None, dtype=None,
                  device="cuda") -> "DeviceMomentStore":
        """One-time cold-start upload of a host store's state (warm
        promotion); after this the device copy is authoritative.  A
        float64 store (scale 1.0) is an exact copy, as ``to_host`` is."""
        from . import distributed as D

        dst = DeviceMomentStore.fresh_device(
            store.n_blocks, store.boundaries, store.sketch0, block_sizes,
            shift=store.shift, n_groups=store.n_groups, scale=scale,
            dtype=dtype, anchor=store.anchor,
            has_sketch=store.has_sketch, device=device)
        p4 = dst.scale ** np.arange(4)
        dst.mom_s = D.h2d(store.mom_s / p4, dst.dtype, dst.device)
        dst.mom_l = D.h2d(store.mom_l / p4, dst.dtype, dst.device)
        dst.totals = D.h2d(store.totals / p4[:3], dst.dtype, dst.device)
        dst.n_sampled = store.n_sampled.copy()
        dst._n_sampled_dev = D.h2d(store.n_sampled.astype(np.float64),
                                   dst.dtype, dst.device)
        if store.has_sketch:
            dst.regs = D.h2d(store.regs, torch.uint8, dst.device)
        dst.rounds = store.rounds
        return dst

    def to_host(self) -> MomentStore:
        """Download into a host float64 ``MomentStore`` (diagnostics and
        parity tests — never on the serving tick path)."""
        p4 = self.scale ** np.arange(4)

        def host(t):
            return t.detach().to("cpu", torch.float64).numpy()

        return MomentStore(
            n_blocks=self.n_blocks, n_groups=self.n_groups,
            boundaries=self.boundaries, sketch0=self.sketch0,
            shift=self.shift, mom_s=host(self.mom_s) * p4,
            mom_l=host(self.mom_l) * p4, totals=host(self.totals) * p4[:3],
            n_sampled=self.n_sampled.copy(), rounds=self.rounds,
            anchor=self.anchor, has_sketch=self.has_sketch,
            regs=(self.regs.to("cpu").numpy().copy()
                  if self.has_sketch else None))

    # -- sketch plane ------------------------------------------------------

    def group_registers(self) -> np.ndarray:
        """(n_groups, M) folded register rows.  Steady state serves the
        tick's folded rows (read back with the stat rows — no per-cell
        register bytes cross); the cold/diagnostic path downloads the
        resident plane and folds on the host."""
        if not self.has_sketch:
            raise ValueError("store was built without a sketch plane "
                             "(has_sketch=False)")
        if self._stats_valid and self._group_regs is not None:
            self._group_regs = _landed(self._group_regs)
            return self._group_regs
        return _sketch.fold_groups(self.regs.to("cpu").numpy(),
                                   self.n_groups)

    def distinct_counts(self) -> np.ndarray:
        """(n_groups,) HLL COUNT DISTINCT estimates (host estimator over
        the folded rows — identical math on every route)."""
        return _sketch.estimate(self.group_registers())

    # -- properties / planning mirror --------------------------------------

    @property
    def n_cells(self) -> int:
        return self.n_groups * self.n_blocks

    @property
    def total_sampled(self) -> int:
        return int(self.n_sampled.sum())

    def deficit(self, target_quotas: Sequence[int]) -> np.ndarray:
        return block_deficit(self.n_sampled, target_quotas, self.n_blocks)

    def _grand_totals(self) -> "tuple[float, float, float]":
        """(n, s1, s2) over all cells, un-scaled — from the cached group
        rows when valid (zero device traffic), else three reduced scalars
        off the resident totals."""
        if self._stats_valid and self._rows is not None:
            t = self._rows[:, [0, 4, 5]].sum(axis=0)
        else:
            t = self.totals.sum(dim=0).to("cpu", torch.float64).numpy()
        return float(t[0]), float(t[1]) * self.scale, \
            float(t[2]) * self.scale ** 2

    def matched_total(self) -> float:
        """Total matching samples accumulated (the budget splitter's n)."""
        return self._grand_totals()[0]

    def sample_sigma(self) -> float:
        """ddof-1 sigma of all matching samples — the host ``MomentStore``
        contract served from device state."""
        n, s1, s2 = self._grand_totals()
        if n < 2:
            return float("nan")
        mean = s1 / n
        var = max(s2 / n - mean * mean, 0.0)
        return math.sqrt(var * n / (n - 1.0))

    # -- ticks -------------------------------------------------------------

    def _own_stack(self) -> "DeviceStack":
        if (self._owner is not None and not self._owner._released
                and len(self._owner.stores) == 1):
            return self._owner
        if self._stack is None or self._stack._released \
                or self._stack is not self._owner:
            self._stack = DeviceStack([self])
        return self._stack

    def build_seg(self, block_ids: np.ndarray,
                  group_ids: Optional[np.ndarray] = None,
                  mask: Optional[np.ndarray] = None,
                  offset: int = 0) -> np.ndarray:
        """Flatten (group, block) tags onto this store's cell axis (the
        engine's ``flat_segments`` contract), mask-filtered, offset for
        stacked ticks.  Returns int32 segment ids aligned with the
        POST-mask value stream (callers apply the same mask to values)."""
        block_ids = np.asarray(block_ids).reshape(-1)
        seg, _ = flat_segments(block_ids.astype(np.intp), self.n_blocks,
                               group_ids, self.n_groups)
        if mask is not None:
            seg = seg[np.asarray(mask, dtype=bool).reshape(-1)]
        return (seg + offset).astype(np.int32)

    def ingest_tick(self, values: np.ndarray, block_ids: np.ndarray,
                    quotas: np.ndarray, params: IslaParams, *,
                    mode: str = "calibrated", geometry=None,
                    group_ids: Optional[np.ndarray] = None,
                    mask: Optional[np.ndarray] = None,
                    count_round: bool = True, layout: str = "auto"):
        """Single-store convenience tick: merge one pass (values on the
        shifted scale, the ``MomentStore.ingest`` contract) and re-solve —
        one fused tick.  Returns ``(partials, rows)`` (device partials in
        scaled shifted units; see ``DeviceStack.tick``).

        ``layout="auto"`` picks the dense pane when the stream is
        block-major canonical and the store runs fp32; float64 stores and
        other streams take the tagged tick (the bit-exact merge contract
        in float64).  Force with "dense" (canonical streams only; a
        float64 store folds the pane in float64, within 1e-12 of the host
        fold, not bit for bit) or "tagged".
        """
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        quotas_arr = np.asarray(quotas, dtype=np.int64).reshape(-1)
        block_ids = np.asarray(block_ids).reshape(-1)
        if layout not in ("auto", "dense", "tagged"):
            raise ValueError(f"unknown layout {layout!r}")
        if layout != "tagged":
            canonical = np.array_equal(
                block_ids, np.repeat(np.arange(self.n_blocks), quotas_arr))
            if layout == "dense" and not canonical:
                raise ValueError("the dense layout takes a block-major "
                                 "canonical stream; use layout='tagged'")
            if layout == "auto":
                layout = ("dense" if canonical
                          and self.dtype != torch.float64 else "tagged")
        stack = self._own_stack()
        if layout == "dense":
            # The stack's dense pane takes RAW measure values; this API
            # takes shifted ones (the MomentStore contract), so un-shift
            # first, as the reference does — a float64 round trip that
            # may move a value by an ulp, well inside the dense layout's
            # tolerance at either dtype.
            out = stack.tick(
                params, mode=mode, geometry=geometry,
                values=values - self.shift, quotas=quotas_arr,
                dense=([group_ids], [mask]), count_round=count_round)
            return out[0]
        # key_seg is the stack's cell-placement contract.
        seg = stack.key_seg(0, self, block_ids, group_ids, mask)
        if mask is not None:
            values = values[np.asarray(mask, dtype=bool).reshape(-1)]
        hash_limbs = None
        if self.has_sketch:
            # Hash-input contract: raw UN-shifted float64 bits.
            hash_limbs = _sketch.value_limbs(values - self.shift)
        out = stack.tick(
            params, mode=mode, geometry=geometry,
            values=values / self.scale, seg=seg, quotas=quotas_arr,
            count_round=count_round, hash_limbs=hash_limbs)
        return out[0]

    def solve_device(self, params: IslaParams, mode: str = "calibrated",
                     geometry=None):
        """Zero-draw re-solve of the resident moments (cached between
        state changes; at most one tick, zero uploads)."""
        return self._own_stack().tick(params, mode=mode,
                                      geometry=geometry)[0]

    def partials_host(self) -> np.ndarray:
        """Last solved per-cell partial answers, un-scaled back to the
        shifted float64 axis (these are answers, not moments)."""
        if not self._stats_valid or self._partials is None:
            raise ValueError("no solved partials cached; run a tick or "
                             "solve_device first")
        return (self._partials.to("cpu", torch.float64).numpy()
                * self.scale)


class DeviceStack:
    """A stacked multi-store launch set: the warm stores of one mode-group
    concatenated onto one (total_cells, 4) moments axis so N predicates'
    continuation rounds are ONE fused tick.

    Member stores must share the block axis, dtype and device, but each
    store may carry its OWN anchor (boundaries / shift / scale): the dense
    tick gets one bounds row per distinct anchor with a static slot per
    key and per-key value affines, the tagged tick a per-cell cuts table
    (+ an inert pad row for the drop segment), and both a per-cell
    inverse-scale vector (the Phase 2 stopping threshold rides it), so
    every cell classifies and solves in its own anchor's frame.  A stack
    whose stores all share one anchor keeps one bounds row and the
    identity affine.  ``sketch0`` may differ per store
    (re-anchoring), so Phase 2 takes a per-cell sketch vector.  Stack
    constants are uploaded once at stack build.

    Any sketch member makes the stack a sketch stack: its tick merges the
    fresh samples into one stacked register plane (non-sketch members
    ride with inert all-zero register rows — max against them is a
    no-op, and they are never read) and reads back the folded
    (n_rows, 4096) group rows with the stat rows.
    """

    def __init__(self, stores: Sequence[DeviceMomentStore]) -> None:
        from . import distributed as D

        if not stores:
            raise ValueError("a device stack needs at least one store")
        first = stores[0]
        for st in stores:
            if (st.n_blocks != first.n_blocks or st.dtype != first.dtype
                    or st.device != first.device):
                raise ValueError("stacked stores must share the block "
                                 "axis, dtype and device")
        self.stores = list(stores)
        self.n_blocks = first.n_blocks
        self.dtype = first.dtype
        self.device = first.device
        cells = [st.n_cells for st in self.stores]
        groups = [st.n_groups for st in self.stores]
        self.offsets = np.concatenate([[0], np.cumsum(cells)])
        self.row_offsets = np.concatenate([[0], np.cumsum(groups)])
        self.n_cells = int(self.offsets[-1])
        self.n_rows = int(self.row_offsets[-1])
        self.n_groups_list = tuple(groups)
        self._sizes = (first._sizes if len(self.stores) == 1 else
                       torch.cat([st._sizes for st in self.stores]))
        self._uniform = all(
            st.boundaries == first.boundaries and st.shift == first.shift
            and st.scale == first.scale for st in self.stores)
        if self._uniform:
            self._bound_rows = first._bounds.reshape(1, 4)
            self._bound_slots = (0,) * len(self.stores)
            self._bounds = self._bound_rows  # the tagged tick broadcasts it
        else:
            # Tagged layout: per-cell cuts, +1 inert pad row for the drop
            # segment (+inf matches no sample).
            self._bounds = torch.cat(
                [st._bounds.expand(st.n_cells, 4) for st in self.stores]
                + [torch.full((1, 4), math.inf, dtype=self.dtype,
                              device=self.device)])
            # Dense layout: one row per DISTINCT anchor, a static slot per
            # key.
            seen = {}
            rows, slots = [], []
            for st in self.stores:
                bkey = (st.boundaries, st.scale)
                if bkey not in seen:
                    seen[bkey] = len(rows)
                    rows.append(st._bounds)
                slots.append(seen[bkey])
            self._bound_rows = torch.stack(rows)
            self._bound_slots = tuple(slots)
        # Per-cell inverse anchor scale: pre-scales the Phase 2 stopping
        # threshold (and the ISLA-E b0) into each cell's normalized frame.
        self._inv_scale = D.h2d(np.concatenate(
            [np.full(st.n_cells, 1.0 / st.scale) for st in self.stores]),
            self.dtype, self.device)
        # Dense value affines: the pane holds raw/ref values; key k
        # recovers its own frame as v * ratio_k + off_k inside the fold.
        self._ref_scale = max(st.scale for st in self.stores)
        self._key_affine = tuple(
            (self._ref_scale / st.scale, st.shift / st.scale)
            for st in self.stores)
        self._sk_cells = None  # cached per-cell sketch vector (device)
        # Zone-map pruning: when a pruned plan zeroes whole blocks'
        # quotas, the tick folds a COMPACTED active-block pane and maps
        # its cells onto the resident rows — pruned cells keep their rows
        # untouched, so a predicate change re-activates them warm.
        self.block_compaction = True
        self._active_cache = {}  # active-set bytes -> device index pair
        # Adopt the stores: the stacked tensors become the authoritative
        # resident state (built once — ticks update them in place).  A
        # store reads its slice through ``state_slice``; ``release``
        # hands the slices back when the stack dissolves.
        for st in self.stores:
            st._detach()
        if len(self.stores) == 1:
            st = self.stores[0]
            self._state = (st._mom_s, st._mom_l, st._totals, st._ns_dev)
        else:
            self._state = (
                torch.cat([st._mom_s for st in self.stores]),
                torch.cat([st._mom_l for st in self.stores]),
                torch.cat([st._totals for st in self.stores]),
                torch.cat([st._ns_dev for st in self.stores]))
        self.has_sketch = any(st.has_sketch for st in self.stores)
        if not self.has_sketch:
            self._regs_state = None
        elif len(self.stores) == 1:
            self._regs_state = self.stores[0]._regs
        else:
            self._regs_state = torch.cat([
                st._regs if st.has_sketch else torch.zeros(
                    (st.n_cells, _sketch.M), dtype=torch.uint8,
                    device=self.device)
                for st in self.stores])
        self._released = False
        self._fault = None  # why a run-table fault left the stack unusable
        # Ticks whose stat copies have not landed yet, in tick order.
        self._unlanded = collections.deque()
        for st in self.stores:
            st._mom_s = st._mom_l = st._totals = st._ns_dev = None
            st._regs = None
            st._owner = self

    # -- state plumbing ----------------------------------------------------

    def state_slice(self, store: DeviceMomentStore, idx: int):
        """One adopted store's view of the stacked state (idx: 0 mom_s,
        1 mom_l, 2 totals, 3 device draw ledger, 4 HLL registers) — for
        diagnostics and downloads, never on the tick path."""
        k = next(i for i, st in enumerate(self.stores) if st is store)
        if idx < 3:
            return self._state[idx][int(self.offsets[k]):
                                    int(self.offsets[k + 1])]
        if idx == 4:
            return self._regs_state[int(self.offsets[k]):
                                    int(self.offsets[k + 1])]
        b = self.n_blocks
        return self._state[3][k * b:(k + 1) * b]

    def key_seg(self, k: int, store: DeviceMomentStore,
                block_ids: np.ndarray,
                group_ids: Optional[np.ndarray] = None,
                mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Cell ids for store ``k``'s tagged draw in THIS stack's layout —
        the placement contract callers use instead of assuming the offset
        arithmetic."""
        return store.build_seg(block_ids, group_ids, mask,
                               offset=int(self.offsets[k]))

    def key_runs(self, quotas: np.ndarray,
                 mask: Optional[np.ndarray] = None) -> np.ndarray:
        """A key's (n_blocks,) run lengths in a block-major draw (the
        chunk's ``quotas``, block b's samples after block b - 1's): its
        samples of each block, all of them, or those its WHERE ``mask``
        keeps — the row of ``tick(runs=...)`` that ``key_seg``'s ids of
        the same draw take."""
        quotas = np.asarray(quotas, dtype=np.int64).reshape(-1)
        if mask is None:
            return quotas.copy()
        drawn = np.flatnonzero(quotas)
        out = np.zeros(self.n_blocks, dtype=np.int64)
        if drawn.size:
            at = np.concatenate([[0], np.cumsum(quotas[drawn])[:-1]])
            # The narrowest sum that holds a block's count is the fastest.
            dt = np.uint16 if quotas.max() < 2 ** 16 else np.int64
            out[drawn] = np.add.reduceat(
                np.asarray(mask, dtype=bool).reshape(-1).view(np.uint8), at,
                dtype=dt)
        return out

    def release(self) -> None:
        """Dissolve the stack: hand every store a copy of its slices so
        each owns its state again (e.g. before a store joins a new stack
        when the warm key set changes).  Every tick's stat copy lands
        first, its run count checked."""
        if self._released:
            return
        self._land_copies()
        mom_s, mom_l, totals, ns = self._state
        b = self.n_blocks
        for k, st in enumerate(self.stores):
            o0, o1 = int(self.offsets[k]), int(self.offsets[k + 1])
            st._mom_s = mom_s[o0:o1].clone()
            st._mom_l = mom_l[o0:o1].clone()
            st._totals = totals[o0:o1].clone()
            st._ns_dev = ns[k * b:(k + 1) * b].clone()
            if st.has_sketch:
                st._regs = self._regs_state[o0:o1].clone()
            st._owner = None
        # Drop the stacked tensors: a stale executor cache entry must not
        # pin a dead copy of every store's moments in device memory.
        self._state = None
        self._regs_state = None
        self._sk_cells = None
        self._released = True

    def _install_stats(self, partials, rows, cfg, timings=None,
                       group_regs=None, runs=None, defer=False):
        """Hand each store its slice of the tick's stats: per-cell partials
        stay on the device as views (``_store_partials``), and one copy
        brings the O(groups) rows back with the tick's run counts
        (``_counts``: a tick folded by a run table, ``runs``, deferred,
        reads the fold's count of runs and samples out of place), a second
        on a sketch stack the (n_rows, 4096) folded register rows
        ``group_regs``.  Serial (``defer=False``): the copies land now, and
        a count that is not 0 raises.  Pipelined (``defer=True``): each
        store gets lazy ``_RowsView`` slices and the copies land, counts
        checked, when a reader first needs them (``_land_copies``)."""
        holder = _LazyRows(self, rows, group_regs, self._counts(runs),
                           timings)
        self._unlanded.append(holder)
        if not defer:
            holder.resolve()
        out = []
        for k, st in enumerate(self.stores):
            r0, r1 = int(self.row_offsets[k]), int(self.row_offsets[k + 1])
            st._partials = self._store_partials(partials, k)
            view = _RowsView(holder, r0, r1)
            st._rows = view if defer else _landed(view)
            if group_regs is not None and st.has_sketch:
                view = _RowsView(holder, r0, r1, regs=True)
                st._group_regs = view if defer else _landed(view)
            st._stats_valid = True
            st._stats_cfg = cfg
            out.append((st._partials, st._rows_src))
        return out

    def _counts(self, runs) -> "list[torch.Tensor]":
        """The tick's run counts that ride its stat copy: the (1,) count of
        its run table, none without one."""
        return [] if runs is None else [runs.count]

    def _store_partials(self, partials, k: int):
        """Store ``k``'s per-cell partials: a view of the stacked ones."""
        return partials[int(self.offsets[k]):int(self.offsets[k + 1])]

    def _land_copies(self, upto: Optional[_LazyRows] = None) -> None:
        """Land this stack's stat copies in tick order, up to the holder
        ``upto`` (all of them by default), checking each tick's run count
        before any of its rows is served: a count that is not 0 is a
        run-table fault (``_run_table_fault``) and raises, and so does
        every later reader of this stack's deferred stats."""
        while self._unlanded and (upto is None or upto.out is None):
            holder = self._unlanded.popleft()
            rows, regs, count = holder.land()
            try:
                check_run_count(count)
            except RunTableError as err:
                self._run_table_fault(err)
                raise
            holder.out = (rows, regs)
        if upto is not None and upto.out is None:
            raise ValueError(self._fault)

    def _run_table_fault(self, err: RunTableError) -> None:
        """A run table did not describe its tagged stream.  The card's fold
        skips what is out of place and folds the rest in place, and the
        ledgers may have advanced, so no store's cached stats stand for
        its state: clear them all and release the stack (each store gets
        back its state as folded), so the stack stays unusable and its
        next tick raises, zero-draw ticks included.  Stat copies not landed
        yet are dropped unread: no row of theirs may be served."""
        self._unlanded.clear()
        for st in self.stores:
            st._stats_valid = False
            st._partials = st._rows = st._group_regs = None
        self.release()
        self._fault = (f"stack was left unusable by a fault ({err}); build "
                       f"a fresh stack")

    # fp32 accumulators lose integer exactness at 2^24; warn with margin
    # so an eternal serving loop cannot silently stop accumulating.
    _FP32_COUNT_HEADROOM = 1 << 22

    def _check_fp32_headroom(self, quotas: np.ndarray) -> None:
        if self.dtype == torch.float64 or getattr(self, "_sat_warned",
                                                  False):
            return
        # Per-block cells accumulate per-block draws; the group-stat rows
        # additionally sum matched counts across a whole store, bounded
        # by its TOTAL draws — both must stay inside fp32's exact-integer
        # range (2^24, checked with margin).
        worst_block = max(int(st.n_sampled.max()) for st in self.stores)
        worst_total = max(int(st.n_sampled.sum()) for st in self.stores)
        if (worst_block + int(quotas.max()) > self._FP32_COUNT_HEADROOM
                or worst_total + int(quotas.sum())
                > 4 * self._FP32_COUNT_HEADROOM):
            import warnings
            warnings.warn(
                "device store draw counts are approaching the float32 "
                "accumulator limit (2^24); further merges will degrade "
                "silently — reset_stores() to re-anchor", RuntimeWarning,
                stacklevel=3)
            self._sat_warned = True

    def _compact_plan(self, quotas: np.ndarray):
        """The dense tick's zone-pruned launch plan: ``(compact_quotas,
        active, (cell_idx, ns_idx))`` when compaction pays, else None.

        ``active`` is the ascending list of blocks with a non-zero quota
        — ascending block order IS the draw-stream order, so the compact
        pane fills from the stream unchanged.  The active count is
        rounded up to a power-of-two bucket (pad slots carry quota 0 and
        out-of-range targets, so they drop); a bucket reaching the full
        block axis falls back to the uncompacted tick.  The device index
        pair is cached per active set, so steady ticks under an unchanged
        plan upload only the usual sample panes.
        """
        if not self.block_compaction:
            return None
        active = np.flatnonzero(quotas > 0)
        a_pad = _bucket(max(int(active.size), 1), floor=8)
        if a_pad >= self.n_blocks:
            return None
        from . import distributed as D

        q_c = np.zeros(a_pad, dtype=np.int64)
        q_c[:active.size] = quotas[active]
        ck = active.tobytes()
        pair = self._active_cache.get(ck)
        if pair is None:
            ext = np.full(a_pad, -1, dtype=np.int64)
            ext[:active.size] = active
            B = self.n_blocks
            K = len(self.stores)
            parts = []
            for k, st in enumerate(self.stores):
                idx = (int(self.offsets[k])
                       + np.arange(st.n_groups)[:, None] * B + ext[None, :])
                parts.append(np.where(ext[None, :] < 0, self.n_cells,
                                      idx).reshape(-1))
            cell_idx = np.concatenate(parts)
            ns_idx = np.arange(K)[:, None] * B + ext[None, :]
            ns_idx = np.where(ext[None, :] < 0, K * B, ns_idx).reshape(-1)
            if len(self._active_cache) >= 32:
                self._active_cache.clear()
            pair = (D.h2d(cell_idx.astype(np.int32), torch.int32,
                          self.device),
                    D.h2d(ns_idx.astype(np.int32), torch.int32,
                          self.device))
            self._active_cache[ck] = pair
        return q_c, active, pair

    def _sketch0_cells(self):
        # Broadcast from each store's resident device scalar (cached
        # across ticks), so warm ticks upload no scalars.
        if self._sk_cells is None:
            self._sk_cells = torch.cat([
                st._sketch0_dev.expand(st.n_cells) for st in self.stores])
        return self._sk_cells

    # -- the tick ----------------------------------------------------------

    def tick(self, params: IslaParams, mode: str = "calibrated",
             geometry=None, values: Optional[np.ndarray] = None,
             seg: Optional[np.ndarray] = None,
             quotas: Optional[np.ndarray] = None,
             dense=None, count_round: bool = True, timings=None,
             defer_stats: bool = False, hash_limbs=None, runs=None):
        """One continuation round for every store in the stack.

        Two sample payloads, one fused tick either way:

         * tagged — ``values`` (each store's OWN scaled shifted frame —
           ``(raw + store.shift) / store.scale`` per key slice, float64
           host, matched samples only) aligned with ``seg`` (stacked cell
           ids from ``key_seg``; ``n_cells`` is the drop segment): the
           carry-prepend fold (``distributed.fused_tick``: one
           ``isla_tagged_fold`` launch), bit-identical to the host fold
           when the store runs float64 (scale 1.0).  A sketch stack also
           takes ``hash_limbs=(hi, lo)``, the ``sketch.value_limbs`` of the
           RAW unshifted values aligned with ``values`` (the scaled values
           cannot give back the raw bits); they cross as one int64 lane
           each and merge through ``isla_sketch_tagged``.  A block-major
           stream (each key's slice in key order, block by block) may come
           with ``runs``, its (n_stores, n_blocks) run lengths
           (``key_runs``): the table crosses with the stream and the fold
           takes a block a run with no sort; a table that does not
           describe the stream raises at the tick's readback (or, on the
           host's checks, before the fold), clears every store's stats and
           leaves the stack unusable (released: its next tick raises).
         * dense — ``values`` is the FULL block-major chunk stream of RAW
           (unshifted) measure values and ``dense=(key_gids,
           key_valids)`` carries per-store (m,) GROUP BY codes / predicate
           masks (None where absent).  The stream is packed into one
           (n_blocks, quota_max) pane of the stack's dtype (its masks
           fp32), uploaded once, and each key folds it in its own anchor
           frame through its affine (``distributed.fused_tick_dense``: one
           ``isla_fold`` launch for every key, then Phase 2 and the group
           rows).  A sketch stack also ships the stream's RAW float64 bits
           as an int64 pane laid out like the value pane (one
           ``isla_sketch`` launch).  A float64 stack folds the pane in
           float64 (the fold's float64 form): the delta is summed, then
           added onto each row, so its state sits within 1e-12 of the
           host carry fold, not on it; a zone-pruned (compacted) launch
           and the full-axis launch give every cell the same bits.

        ``quotas`` is the pass's per-block draw count.  With no draw the
        resident moments are re-solved (served from the stats cache when
        nothing changed — no launch, no transfer; a sketch stack re-folds
        its registers).

        Returns ``[(partials, rows), ...]`` per store — device partial
        answers and the numpy group-stat rows, both in EACH STORE'S scaled
        shifted units.  ``timings`` (optional dict) accumulates wall
        seconds under ``"h2d"``/``"launch"``/``"readback"``.

        ``defer_stats=True`` is the pipelined tick: the stat copy is only
        started (``distributed.d2h_async``, a pinned buffer behind a CUDA
        event) and the returned rows are lazy views that land on first
        read, so the host can draw the next chunk meanwhile.  The ledgers
        advance at dispatch, as in the serial tick; the run count rides
        the deferred copy, and a bad one raises at the first read of any
        of the stack's deferred stats, after the stack has been left
        unusable as above.
        """
        if geometry is not None:
            # kappa is dimensionless; b0 lives on the value axis — the
            # tick rescales it per cell via the inv_scale vector.
            geometry = (float(geometry[0]), float(geometry[1]))
        if self._released:
            raise ValueError(self._fault or (
                "stack was released (a store joined another stack); build "
                "a fresh stack"))
        cfg = (params, mode, geometry)
        n_draw = 0 if quotas is None else int(np.sum(quotas))
        if values is None or n_draw == 0:
            if all(st._stats_valid and st._stats_cfg == cfg
                   for st in self.stores):
                # _rows_src keeps a pipelined tick's lazy views lazy.
                return [(st._partials, st._rows_src) for st in self.stores]
            t0 = time.perf_counter()
            with stage_trace("isla:launch"):
                partials, rows, group_regs = self._solve(
                    params=params, mode=mode, geometry=geometry)
            book(timings, "launch", time.perf_counter() - t0)
            return self._install_stats(partials, rows, cfg, timings,
                                       group_regs, defer=defer_stats)
        if seg is None and dense is None:
            raise ValueError("a drawing tick needs seg= (tagged) or "
                             "dense=(key_gids, key_valids)")

        values = np.asarray(values, dtype=np.float64).reshape(-1)
        quotas = np.asarray(quotas, dtype=np.int64).reshape(-1)
        if quotas.shape != (self.n_blocks,):
            raise ValueError(f"quotas must be ({self.n_blocks},), got "
                             f"{quotas.shape}")
        self._check_fp32_headroom(quotas)
        tick_kw = dict(params=params, mode=mode, geometry=geometry,
                       timings=timings)
        if seg is None and runs is not None:
            raise ValueError("runs= describes a tagged stream (seg=)")
        if seg is None:
            partials, rows, group_regs = self._dense_tick(
                values, quotas, dense, **tick_kw)
            self._advance(quotas, count_round)
            return self._install_stats(partials, rows, cfg, timings,
                                       group_regs, defer=defer_stats)
        try:
            partials, rows, group_regs, runs_dev = self._tagged_tick(
                values, seg, quotas, hash_limbs, runs, **tick_kw)
            self._advance(quotas, count_round)
            return self._install_stats(partials, rows, cfg, timings,
                                       group_regs, runs=runs_dev,
                                       defer=defer_stats)
        except RunTableError as err:
            self._run_table_fault(err)
            raise

    def _advance(self, quotas: np.ndarray, count_round: bool) -> None:
        """Every store's host draw ledger (and round count) after a
        drawing tick."""
        for st in self.stores:
            st.n_sampled = st.n_sampled + quotas
            if count_round:
                st.rounds += 1

    def _solve(self, *, params: IslaParams, mode: str, geometry):
        """The zero-draw re-solve of the resident state (see ``tick``):
        ``(partials, rows, group_regs)``, the last None without a sketch
        plane."""
        from . import distributed as D

        mom_s, mom_l, totals, ns = self._state
        kw = dict(params=params, mode=mode, geometry=geometry,
                  n_groups_list=self.n_groups_list)
        if self.has_sketch:
            return D.fused_solve_sketch(
                mom_s, mom_l, totals, ns, self._regs_state,
                self._sketch0_cells(), self._sizes, self._inv_scale, **kw)
        partials, rows = D.fused_solve(mom_s, mom_l, totals, ns,
                                       self._sketch0_cells(), self._sizes,
                                       self._inv_scale, **kw)
        return partials, rows, None

    def _tagged_host(self, values: np.ndarray, seg, hash_limbs):
        """The tagged payload checked on the host: ``(seg, bits)``, the
        int32 ids and, on a sketch stack, the raw 64-bit patterns the
        register merge hashes (one int64 lane a sample), else None."""
        seg = np.asarray(seg, dtype=np.int32).reshape(-1)
        if values.shape != seg.shape:
            raise ValueError("values and seg must align")
        if not self.has_sketch:
            return seg, None
        if hash_limbs is None:
            raise ValueError("a sketch stack's tagged tick needs hash_limbs "
                             "(sketch.value_limbs of the raw values)")
        hi, lo = (np.asarray(h, dtype=np.uint64).reshape(-1)
                  for h in hash_limbs)
        if hi.shape != values.shape or lo.shape != values.shape:
            raise ValueError("hash_limbs must align with values")
        return seg, ((hi << np.uint64(32)) | lo).view(np.int64)

    def _tagged_tick(self, values: np.ndarray, seg, quotas: np.ndarray,
                     hash_limbs, runs, *, params: IslaParams, mode: str,
                     geometry, timings):
        """The tagged payload's uploads and fused tick (see ``tick``);
        returns ``(partials, rows, group_regs, runs)``, the last the
        uploaded ``TaggedRuns`` (None without ``runs``)."""
        from . import distributed as D

        seg, bits = self._tagged_host(values, seg, hash_limbs)
        mom_s, mom_l, totals, ns = self._state
        dev = self.device
        t_h = time.perf_counter()
        with stage_trace("isla:h2d"):
            q_dev = D.h2d(quotas.astype(np.float64), self.dtype, dev)
            v_dev = D.h2d(values, self.dtype, dev)
            s_dev = D.h2d(seg, torch.int32, dev)
            if self.has_sketch:
                bits_dev = D.h2d(bits, torch.int64, dev)
            if runs is not None:
                table = tagged_run_table(runs, self.offsets)
                runs = TaggedRuns(D.h2d(table, torch.int32, dev),
                                  len(self.stores), self.n_blocks,
                                  deferred=True)
        book(timings, "h2d", time.perf_counter() - t_h)
        t_l = time.perf_counter()
        with stage_trace("isla:launch"):
            tick_kw = dict(params=params, mode=mode, geometry=geometry,
                           n_groups_list=self.n_groups_list)
            group_regs = None
            if self.has_sketch:
                out = D.fused_tick_sketch(
                    mom_s, mom_l, totals, ns, self._regs_state, v_dev, s_dev,
                    bits_dev, q_dev, self._bounds, self._sketch0_cells(),
                    self._sizes, self._inv_scale, runs=runs, **tick_kw)
                partials, rows, group_regs = out[5:]
            else:
                partials, rows = D.fused_tick(
                    mom_s, mom_l, totals, ns, v_dev, s_dev, q_dev,
                    self._bounds, self._sketch0_cells(), self._sizes,
                    self._inv_scale, runs=runs, **tick_kw)[4:]
        book(timings, "launch", time.perf_counter() - t_l)
        return partials, rows, group_regs, runs

    def _dense_frame(self, values: np.ndarray):
        """The dense pane's values and the keys' affines: one shared
        anchor prepares the pane in its frame on the host (float64) and
        takes the identity affine; per-key anchors read ``raw / ref`` each
        through its own affine."""
        if self._uniform:
            st0 = self.stores[0]
            return ((values + st0.shift) / st0.scale,
                    ((1.0, 0.0),) * len(self.stores))
        return values / self._ref_scale, self._key_affine

    def _dense_tick(self, values: np.ndarray, quotas: np.ndarray, dense, *,
                    params: IslaParams, mode: str, geometry, timings):
        """The dense payload's panes, uploads and fused tick (see
        ``tick``); returns ``(partials, rows, group_regs)``."""
        from . import distributed as D

        mom_s, mom_l, totals, ns = self._state
        pane_vals, key_affine = self._dense_frame(values)
        # Zone-pruned plans zero whole blocks' quotas; the draw stream
        # already skips those blocks, so the pane compacts to the active
        # rows and the fold maps them back through the cached index pair.
        cp = self._compact_plan(quotas)
        if cp is not None:
            pane_quotas, _, active_cells = cp
        else:
            pane_quotas, active_cells = quotas, None
        t_h = time.perf_counter()
        with stage_trace("isla:h2d"):
            dev = self.device
            q_dev = D.h2d(pane_quotas.astype(np.float64), self.dtype, dev)
            panes = _DensePanes(pane_vals, pane_quotas, dense,
                                values if self.has_sketch else None)
            gid_panes = tuple(D.h2d(g, torch.int32, dev) for g in panes.gids)
            # 0/1 masks cross as fp32 whatever the stack's dtype: the
            # fold and the register merge read them so, exactly.
            valid_panes = tuple(D.h2d(m, torch.float32, dev)
                                for m in panes.valids)
            v_dev = D.h2d(panes.v2d, self.dtype, dev)
            pad_dev = D.h2d(panes.pad, torch.float32, dev)
            if self.has_sketch:
                bits_dev = D.h2d(panes.bits2d, torch.int64, dev)
        book(timings, "h2d", time.perf_counter() - t_h)
        t_l = time.perf_counter()
        with stage_trace("isla:launch"):
            tick_kw = dict(params=params, mode=mode, geometry=geometry,
                           n_groups_list=self.n_groups_list,
                           gid_slots=panes.gid_slots,
                           valid_slots=panes.valid_slots,
                           key_affine=key_affine,
                           bound_slots=self._bound_slots)
            group_regs = None
            if self.has_sketch:
                out = D.fused_tick_dense_sketch(
                    mom_s, mom_l, totals, ns, self._regs_state, v_dev, pad_dev,
                    bits_dev, q_dev, gid_panes, valid_panes, self._bound_rows,
                    self._sketch0_cells(), self._sizes, self._inv_scale,
                    active_cells, **tick_kw)
                partials, rows, group_regs = out[5:]
            else:
                partials, rows = D.fused_tick_dense(
                    mom_s, mom_l, totals, ns, v_dev, pad_dev, q_dev, gid_panes,
                    valid_panes, self._bound_rows, self._sketch0_cells(),
                    self._sizes, self._inv_scale, active_cells, **tick_kw)[4:]
        book(timings, "launch", time.perf_counter() - t_l)
        return partials, rows, group_regs


class _DensePanes:
    """The dense payload's host panes (see ``DeviceStack.tick``): the
    stream packed into the (rows, quota_bucket) value pane ``v2d`` by
    ``pane_quotas`` with its pad mask ``pad``; each key's GROUP BY codes
    and predicate mask packed alike, deduped by host-array identity into
    ``gids`` / ``valids`` (one upload a distinct pane) with a slot a key
    (-1: none); and, given the RAW stream ``raw``, the int64 pane of its
    float64 bits the register merge hashes (``bits2d``; the value pane is
    anchor-scaled, registers key on the raw bits)."""

    def __init__(self, pane_vals: np.ndarray, pane_quotas: np.ndarray,
                 dense, raw: Optional[np.ndarray] = None) -> None:
        self.v2d, self.pad, vmask = _dense_panes(pane_vals, pane_quotas)
        self.gids, self.valids = [], []
        gid_slots, valid_slots = [], []
        seen_g, seen_v = {}, {}
        for gids, valid in zip(*dense):
            if gids is None:
                gid_slots.append(-1)
            elif id(gids) in seen_g:
                gid_slots.append(seen_g[id(gids)])
            else:
                g2d = np.zeros(self.v2d.shape, dtype=np.int32)
                g2d[vmask] = np.asarray(gids).reshape(-1)
                seen_g[id(gids)] = len(self.gids)
                gid_slots.append(len(self.gids))
                self.gids.append(g2d)
            if valid is None:
                valid_slots.append(-1)
            elif id(valid) in seen_v:
                valid_slots.append(seen_v[id(valid)])
            else:
                m2d = np.zeros(self.v2d.shape, dtype=np.float64)
                m2d[vmask] = np.asarray(valid, dtype=np.float64).reshape(-1)
                seen_v[id(valid)] = len(self.valids)
                valid_slots.append(len(self.valids))
                self.valids.append(m2d)
        self.gid_slots, self.valid_slots = tuple(gid_slots), tuple(valid_slots)
        self.bits2d = None
        if raw is not None:
            self.bits2d = np.zeros(self.v2d.shape, dtype=np.int64)
            self.bits2d[vmask] = _sketch.value_bits(raw).view(np.int64)


class _MeshPartialsView:
    """One store's per-cell partials on a mesh stack, left on the shards:
    the tick moves no per-cell bytes between devices, and a reader
    (``to``, ``cpu``, ``numpy.asarray``) gathers them from every shard
    into the store's own (group, block) layout, on the first shard's
    device first."""

    def __init__(self, stack: "MeshDeviceStack", parts, k: int) -> None:
        self._stack, self._parts, self._k = stack, parts, k
        self.device = parts[0].device

    def to(self, *args, **kwargs) -> torch.Tensor:
        return self._stack._gather(self._parts, self._k,
                                   self.device).to(*args, **kwargs)

    def cpu(self) -> torch.Tensor:
        return self.to("cpu")

    def __array__(self, dtype=None, copy=None):
        out = self.to("cpu").numpy()
        return out if dtype is None else out.astype(dtype)


class MeshDeviceStack(DeviceStack):
    """``DeviceStack`` sharded over a cell mesh (``launch.mesh.CellMesh``,
    one device a shard): the stacked (store, group, block) cell axis
    splits by BLOCK RUNS, so every shard owns a contiguous run of blocks
    for each (store, group) and keeps those moment, total, ledger and
    register rows resident on its own device, a tensor a shard.

    Layout: with S shards and B blocks, each shard owns ``B_local =
    ceil(B / S)`` blocks and ``L = sum_k G_k * B_local`` cells; the mesh
    cell id of store k's (g, b) cell is ::

        s * L + off_k + g * B_local + (b - s * B_local),
        s = b // B_local,  off_k = sum_{j<k} G_j * B_local

    — each shard's slice is the single-device stack's store-major /
    group-major / block-minor layout over its OWN blocks, so each shard
    runs the single-device tick verbatim (``distributed.mesh_tick`` and
    its forms) and launches the same kernels on its device.  Trailing pad
    blocks (S not dividing B) carry zero sizes, zero quotas, +inf cuts and
    empty runs, inert in every reduction.  With S = 1 the layout is the
    single-device stack's.

    Placement follows ``sharding.specs.isla_cell_specs``; uploads go
    through ``distributed.mesh_h2d``.  The tagged payload takes MESH cell
    ids (``key_seg``; ``n_cells_mesh`` and ids past it drop).  Each shard
    gets only its own samples, in stream order: with the stream's run
    table its part is one contiguous slice a key (the stream is
    block-major per key), with its own run table; without, a stable
    partition by shard.  So every cell folds in the single-device order
    and float64 state and partials are bit-identical to ``DeviceStack``'s.
    The one cross-device step of a tick is ``distributed.mesh_all_reduce``
    of the O(groups) stat rows (a sketch stack adds the max of its folded
    register rows).  Per-store partials come back as views that gather
    from every shard when read."""

    def __init__(self, stores: Sequence[DeviceMomentStore], mesh) -> None:
        from . import distributed as D
        from ..sharding.specs import isla_cell_specs

        # Adopt and stack on the stores' device first (anchor tables, cell
        # bookkeeping); the state then moves into mesh placement by one
        # host round trip (float64 on the host keeps every bit).
        super().__init__(stores)
        self.mesh = mesh
        self._specs = spec = isla_cell_specs(mesh)
        S = len(mesh.devices)
        B, K = self.n_blocks, len(self.stores)
        self.n_shards = S
        self.blocks_local = bl = -(-B // S)
        self._shard_blocks = [min(max(B - s * bl, 0), bl) for s in range(S)]
        self.local_offsets = np.concatenate(
            [[0], np.cumsum([g * bl for g in self.n_groups_list])]
        ).astype(np.int64)
        self.cells_local = L = int(self.local_offsets[-1])
        self.n_cells_mesh = S * L
        # Store layout -> mesh layout.
        b = np.arange(B)
        s_of_b, lb = b // bl, b % bl
        self._cell_maps = [
            (s_of_b[None, :] * L + self.local_offsets[k]
             + np.arange(g)[:, None] * bl + lb[None, :]).reshape(-1)
            for k, g in enumerate(self.n_groups_list)]
        self._ns_map = (s_of_b[None, :] * (K * bl)
                        + np.arange(K)[:, None] * bl + lb[None, :]
                        ).reshape(-1)
        cmap_all = np.concatenate(self._cell_maps)

        def host(t, dtype=torch.float64):
            return t.detach().to("cpu", dtype).numpy()

        def cells(a, fill=0.0, dtype=np.float64):
            out = np.full((S * L,) + a.shape[1:], fill, dtype=dtype)
            out[cmap_all] = a
            return out

        def ledger(a):
            out = np.zeros(S * K * bl, dtype=np.float64)
            out[self._ns_map] = a
            return out

        rows, vec, rep = spec["cell_rows"], spec["cells"], spec["replicated"]
        mom_s, mom_l, totals, ns = self._state
        parts = [D.mesh_h2d(mesh, cells(host(t)), rows, self.dtype)
                 for t in (mom_s, mom_l, totals)]
        parts.append(D.mesh_h2d(mesh, ledger(host(ns)), vec, self.dtype))
        self._state = list(zip(*parts))
        if self.has_sketch:
            # Pad cells keep all-zero registers: inert under max.
            self._regs_state = D.mesh_h2d(
                mesh, cells(host(self._regs_state, torch.uint8), 0, np.uint8),
                rows, torch.uint8)
        self._sizes = D.mesh_h2d(mesh, ledger(host(self._sizes)), vec,
                                 self.dtype)
        self._sk_cells = D.mesh_h2d(mesh, cells(host(self._sketch0_cells())),
                                    vec, self.dtype)
        self._inv_scale = D.mesh_h2d(mesh, cells(host(self._inv_scale), 1.0),
                                     vec, self.dtype)
        if self._uniform:
            self._bounds = D.mesh_h2d(mesh, host(self._bounds), rep,
                                      self.dtype)
        else:
            # Each shard's cuts, then its local drop segment's +inf row.
            cuts = np.full((S, L + 1, 4), np.inf)
            cuts[:, :L] = cells(host(self._bounds[:-1]), np.inf
                                ).reshape(S, L, 4)
            self._bounds = D.mesh_h2d(mesh, cuts.reshape(-1, 4), rows,
                                      self.dtype)
        self._bound_rows = D.mesh_h2d(mesh, host(self._bound_rows), rep,
                                      self.dtype)

    # -- state plumbing (mesh placement) -----------------------------------

    def _gather(self, parts, k: int, device, ledger: bool = False):
        """Store ``k``'s rows in its own (group, block) layout — its
        cells, or with ``ledger`` its (n_blocks,) draw ledger — from every
        shard's part (``parts``, a tensor a shard), on ``device``."""
        bl = self.blocks_local
        o, g = ((k * bl, 1) if ledger
                else (int(self.local_offsets[k]), self.n_groups_list[k]))
        pieces = []
        for p, nb in zip(parts, self._shard_blocks):
            if nb:
                rows = p[o:o + g * bl]
                pieces.append(rows.reshape(g, bl, *rows.shape[1:])[:, :nb]
                              .to(device))
        out = torch.cat(pieces, dim=1)
        return out.reshape(g * self.n_blocks, *out.shape[2:])

    def state_slice(self, store: DeviceMomentStore, idx: int):
        """One adopted store's state gathered from every shard (idx as
        ``DeviceStack.state_slice``), on the stores' device — diagnostics,
        downloads and ``release``, never the tick path."""
        k = next(i for i, st in enumerate(self.stores) if st is store)
        parts = (self._regs_state if idx == 4
                 else [shard[idx] for shard in self._state])
        return self._gather(parts, k, self.device, ledger=idx == 3)

    def key_seg(self, k: int, store: DeviceMomentStore,
                block_ids: np.ndarray,
                group_ids: Optional[np.ndarray] = None,
                mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Mesh cell ids for store ``k``'s tagged draw."""
        seg = store.build_seg(block_ids, group_ids, mask)
        return self._cell_maps[k][seg].astype(np.int32)

    def release(self) -> None:
        """Dissolve the mesh stack: every store gets its rows back
        gathered from EVERY shard (the shard-aware reset: a per-key drift
        reset releases through here, never reading shard 0 alone), after
        every tick's stat copy has landed."""
        if self._released:
            return
        self._land_copies()
        for st in self.stores:
            st._mom_s, st._mom_l, st._totals, st._ns_dev = (
                self.state_slice(st, i) for i in range(4))
            if st.has_sketch:
                st._regs = self.state_slice(st, 4)
        for st in self.stores:
            st._owner = None
        self._state = None
        self._regs_state = None
        self._sk_cells = None
        self._released = True

    def _counts(self, runs) -> "list[torch.Tensor]":
        """Every shard's run count (``runs``: a ``TaggedRuns`` a shard),
        copied to the first shard's device, where the reduced rows are;
        a count that is not 0 on any shard raises at the readback."""
        return [] if runs is None else [r.count for r in runs]

    def _store_partials(self, partials, k: int):
        """Store ``k``'s partials (``partials``: a tensor a shard) left on
        the shards, gathered when read."""
        return _MeshPartialsView(self, partials, k)

    # -- the tick ----------------------------------------------------------

    def _solve(self, *, params: IslaParams, mode: str, geometry):
        from . import distributed as D

        kw = dict(params=params, mode=mode, geometry=geometry,
                  n_groups_list=self.n_groups_list)
        if self.has_sketch:
            return D.mesh_solve_sketch(self.mesh, self._state,
                                       self._regs_state, self._sk_cells,
                                       self._sizes, self._inv_scale, **kw)
        partials, rows = D.mesh_solve(self.mesh, self._state, self._sk_cells,
                                      self._sizes, self._inv_scale, **kw)
        return partials, rows, None

    def _compact_plan(self, quotas: np.ndarray):
        """The shard-aware zone-pruned launch plan: each shard compacts its
        own run of active blocks and all shards pad to one shared bucketed
        count ``amax``, so the compact pane stays shard-major (ascending
        (shard, local block) order is ascending block order: the stream
        fills it unchanged).  The index pair, a pair a shard, holds each
        shard's LOCAL targets (its cell rows, its ``K * B_local`` ledger
        rows; pads out of range drop).  Returns ``(compact_quotas, active,
        pairs)`` or None."""
        if not self.block_compaction:
            return None
        S, bl, K = self.n_shards, self.blocks_local, len(self.stores)
        active = np.flatnonzero(quotas > 0)
        s_of = active // bl
        counts = np.bincount(s_of, minlength=S)
        # A shard's run is B / S blocks, so the bucket floor drops to 2.
        amax = _bucket(max(int(counts.max()), 1), floor=2)
        if amax >= bl:
            return None
        from . import distributed as D

        ext = np.full((S, amax), -1, dtype=np.int64)
        q_c = np.zeros(S * amax, dtype=np.int64)
        for s in range(S):
            la = active[s_of == s]
            ext[s, :la.size] = la - s * bl
            q_c[s * amax:s * amax + la.size] = quotas[la]
        ck = active.tobytes()
        pairs = self._active_cache.get(ck)
        if pairs is None:
            base = np.concatenate([self.local_offsets[k] + np.arange(g) * bl
                                   for k, g in enumerate(self.n_groups_list)])
            lb = ext[:, None, :]
            cell_idx = np.where(lb < 0, self.cells_local,
                                base[None, :, None] + lb).reshape(-1)
            ns_idx = np.where(lb < 0, K * bl,
                              (np.arange(K) * bl)[None, :, None] + lb
                              ).reshape(-1)
            if len(self._active_cache) >= 32:
                self._active_cache.clear()
            spec = self._specs["active_cells"]
            pairs = list(zip(
                D.mesh_h2d(self.mesh, cell_idx.astype(np.int32), spec,
                           torch.int32),
                D.mesh_h2d(self.mesh, ns_idx.astype(np.int32), spec,
                           torch.int32)))
            self._active_cache[ck] = pairs
        return q_c, active, pairs

    def _dense_tick(self, values: np.ndarray, quotas: np.ndarray, dense, *,
                    params: IslaParams, mode: str, geometry, timings):
        """The dense payload on the mesh: the block-major panes split by
        block run (``cell_rows``), each shard folding its own rows."""
        from . import distributed as D

        S, bl = self.n_shards, self.blocks_local
        pane_vals, key_affine = self._dense_frame(values)
        cp = self._compact_plan(quotas)
        if cp is not None:
            pane_quotas, _, active_cells = cp
        else:
            # The pad blocks trail the block axis: the stream is unchanged.
            pane_quotas = np.zeros(S * bl, dtype=np.int64)
            pane_quotas[:self.n_blocks] = quotas
            active_cells = None
        t_h = time.perf_counter()
        with stage_trace("isla:h2d"):
            mesh, spec = self.mesh, self._specs
            rows = spec["cell_rows"]
            q_dev = D.mesh_h2d(mesh, pane_quotas.astype(np.float64),
                               spec["cells"], self.dtype)
            panes = _DensePanes(pane_vals, pane_quotas, dense,
                                values if self.has_sketch else None)
            gids = [D.mesh_h2d(mesh, g, rows, torch.int32) for g in panes.gids]
            valids = [D.mesh_h2d(mesh, m, rows, torch.float32)
                      for m in panes.valids]
            gid_panes = [tuple(p[s] for p in gids) for s in range(S)]
            valid_panes = [tuple(p[s] for p in valids) for s in range(S)]
            v_dev = D.mesh_h2d(mesh, panes.v2d, rows, self.dtype)
            pad_dev = D.mesh_h2d(mesh, panes.pad, rows, torch.float32)
            if self.has_sketch:
                bits_dev = D.mesh_h2d(mesh, panes.bits2d, rows, torch.int64)
        book(timings, "h2d", time.perf_counter() - t_h)
        t_l = time.perf_counter()
        with stage_trace("isla:launch"):
            tick_kw = dict(params=params, mode=mode, geometry=geometry,
                           n_groups_list=self.n_groups_list,
                           gid_slots=panes.gid_slots,
                           valid_slots=panes.valid_slots,
                           key_affine=key_affine,
                           bound_slots=self._bound_slots)
            group_regs = None
            if self.has_sketch:
                partials, rows_out, group_regs = D.mesh_tick_dense_sketch(
                    mesh, self._state, self._regs_state, v_dev, pad_dev,
                    bits_dev, q_dev, gid_panes, valid_panes, self._bound_rows,
                    self._sk_cells, self._sizes, self._inv_scale, active_cells,
                    **tick_kw)
            else:
                partials, rows_out = D.mesh_tick_dense(
                    mesh, self._state, v_dev, pad_dev, q_dev, gid_panes,
                    valid_panes, self._bound_rows, self._sk_cells, self._sizes,
                    self._inv_scale, active_cells, **tick_kw)
        book(timings, "launch", time.perf_counter() - t_l)
        return partials, rows_out, group_regs

    def _shard_parts(self, seg: np.ndarray, runs):
        """Which samples each shard takes, in stream order: a list of
        slices a shard (one a key, from the run table ``runs``) or, with
        no table, an index array a shard (a stable partition by the
        shard that owns each id; ids outside the mesh drop)."""
        S, L, bl, B = (self.n_shards, self.cells_local, self.blocks_local,
                       self.n_blocks)
        if runs is None:
            inside = (seg >= 0) & (seg < S * L)
            shard = np.where(inside, seg // L, S).astype(
                np.min_scalar_type(S))
            order = np.argsort(shard, kind="stable")
            cuts = np.concatenate([[0], np.cumsum(np.bincount(
                shard, minlength=S + 1))])
            return [order[cuts[s]:cuts[s + 1]] for s in range(S)]
        starts = np.concatenate([[0], np.cumsum(runs.reshape(-1))])
        out = []
        for s, nb in enumerate(self._shard_blocks):
            r0 = np.arange(len(self.stores)) * B + s * bl
            out.append([slice(int(starts[r]), int(starts[r + nb]))
                        for r in r0] if nb else [])
        return out

    def _tagged_tick(self, values: np.ndarray, seg, quotas: np.ndarray,
                     hash_limbs, runs, *, params: IslaParams, mode: str,
                     geometry, timings):
        """The tagged payload on the mesh: each shard gets its own samples
        and ids (local, its row count the drop segment) and, with the
        stream's run table, its own table over its ``B_local`` blocks.  A
        table the host can already see is wrong (a negative run, runs not
        covering the stream, an id in another shard's run) is a run-table
        fault before any fold; the rest the shards' folds count."""
        from . import distributed as D

        seg, bits = self._tagged_host(values, seg, hash_limbs)
        S, L, bl, B = (self.n_shards, self.cells_local, self.blocks_local,
                       self.n_blocks)
        K, m = len(self.stores), values.size
        if runs is not None:
            runs = np.asarray(runs, dtype=np.int64)
            if runs.shape != (K, B):
                raise ValueError(f"runs must be ({K}, {B}), got "
                                 f"{runs.shape}")
            check_run_count(int((runs < 0).sum())
                            + abs(int(runs.clip(0).sum()) - m))
        parts = self._shard_parts(seg, runs)

        def take(a, part):
            if isinstance(part, list):
                return (np.concatenate([a[sl] for sl in part]) if part
                        else a[:0])
            return a[part]

        vals, segs, bit_parts, tables = [], [], [], []
        misplaced = 0
        for s, part in enumerate(parts):
            ids = take(seg, part).astype(np.int64)
            local = ids - s * L
            out = (local < 0) | (local >= L)
            if runs is not None:
                misplaced += int((out & (ids >= 0) & (ids < S * L)).sum())
            local[out] = L
            vals.append(take(values, part))
            segs.append(local.astype(np.int32))
            if bits is not None:
                bit_parts.append(take(bits, part))
            if runs is not None:
                nb = self._shard_blocks[s]
                own = np.zeros((K, bl), dtype=np.int64)
                own[:, :nb] = runs[:, s * bl:s * bl + nb]
                tables.append(tagged_run_table(own, self.local_offsets))
        check_run_count(misplaced)
        mesh, spec = self.mesh, self._specs
        t_h = time.perf_counter()
        with stage_trace("isla:h2d"):
            q_pad = np.zeros(S * bl, dtype=np.float64)
            q_pad[:B] = quotas
            q_dev = D.mesh_h2d(mesh, q_pad, spec["cells"], self.dtype)
            v_dev = D.mesh_h2d(mesh, vals, spec["cells"], self.dtype)
            s_dev = D.mesh_h2d(mesh, segs, spec["cells"], torch.int32)
            if bits is not None:
                bits_dev = D.mesh_h2d(mesh, bit_parts, spec["cells"],
                                      torch.int64)
            if runs is not None:
                runs = [TaggedRuns(t, K, bl, deferred=True) for t in
                        D.mesh_h2d(mesh, tables, spec["cells"], torch.int32)]
        book(timings, "h2d", time.perf_counter() - t_h)
        t_l = time.perf_counter()
        with stage_trace("isla:launch"):
            tick_kw = dict(params=params, mode=mode, geometry=geometry,
                           n_groups_list=self.n_groups_list, runs=runs)
            group_regs = None
            if self.has_sketch:
                partials, rows, group_regs = D.mesh_tick_sketch(
                    mesh, self._state, self._regs_state, v_dev, s_dev,
                    bits_dev, q_dev, self._bounds, self._sk_cells,
                    self._sizes, self._inv_scale, **tick_kw)
            else:
                partials, rows = D.mesh_tick(
                    mesh, self._state, v_dev, s_dev, q_dev, self._bounds,
                    self._sk_cells, self._sizes, self._inv_scale, **tick_kw)
        book(timings, "launch", time.perf_counter() - t_l)
        return partials, rows, group_regs, runs


def proportional_allocate(amounts: np.ndarray, budget: int) -> np.ndarray:
    """Scale non-negative integer demands down to a total budget with
    largest-remainder rounding; never exceeds the budget or any demand."""
    amounts = np.asarray(amounts, dtype=np.int64)
    total = int(amounts.sum())
    if total <= budget:
        return amounts.copy()
    if budget <= 0:
        return np.zeros_like(amounts)
    exact = amounts * (budget / total)
    out = np.floor(exact).astype(np.int64)
    rem = budget - int(out.sum())
    if rem > 0:
        frac = exact - out
        frac[out >= amounts] = -1.0
        for i in np.argsort(-frac)[:rem]:
            if out[i] < amounts[i]:
                out[i] += 1
    return np.minimum(out, amounts)


def split_budget(n_now: Sequence[float], sigmas: Sequence[float],
                 deficits: Sequence[int], budget: int,
                 min_per_store: int = 0,
                 weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Split a tick's sample budget across stores by marginal-error
    reduction (deadline-aware QoS).

    A store holding n matching samples has half-width ~ z * sigma / sqrt(n);
    the marginal reduction per extra sample is ~ sigma / n^(3/2).  Water-
    filling equalizes that marginal across stores — allocate x_i so that
    sigma_i / (n_i + x_i)^(3/2) is level — subject to 0 <= x_i <= deficit_i.
    Solved by bisection on the level; stores with unknown sigma (no samples
    yet) are treated as maximally uncertain and filled first.

    Parameters
    ----------
    n_now : sequence of float
        Matching samples each store has already accumulated.
    sigmas : sequence of float
        Observed sample sigma per store (NaN = no evidence yet, treated as
        maximally uncertain).
    deficits : sequence of int
        Samples each store still owes against its target quota.
    budget : int
        Total new samples this tick may draw.
    min_per_store : int, optional
        Per-store budget FLOOR (admission-loop QoS): before the waterfill
        runs, every store with a positive deficit is guaranteed
        ``min(deficit_i, min_per_store)`` samples, so a flood of new
        cold predicates (unknown sigma — filled first by the waterfill)
        cannot starve a nearly-converged store's small top-up forever.
        When the budget cannot cover even the floors, the floors
        themselves are split proportionally.
    weights : sequence of float, optional
        Per-store priority weights, > 0 (default: all 1.0).  A store
        with weight ``w`` waterfills as if its sigma were ``w * sigma``,
        i.e. its marginal error reduction counts ``w``-fold — so at
        equal deficit and sigma a higher-priority store receives weakly
        more samples.  Floors (``min_per_store``) are weight-independent
        and honored first; cold stores (NaN sigma) stay
        filled-before-known within their weight class.

    Returns
    -------
    numpy.ndarray
        int64 allocation per store; never exceeds a store's deficit and
        sums to at most ``budget``.

    Examples
    --------
    A converged store's 10-sample top-up survives a cold flood:

    >>> cold = [float("nan")] * 3
    >>> split_budget([9000, 1, 1, 1], [0.5] + cold,
    ...              [10, 5000, 5000, 5000], 300).tolist()
    [0, 100, 100, 100]
    >>> split_budget([9000, 1, 1, 1], [0.5] + cold,
    ...              [10, 5000, 5000, 5000], 300,
    ...              min_per_store=10).tolist()
    [10, 97, 97, 96]
    """
    n_now = np.maximum(np.asarray(n_now, dtype=np.float64).reshape(-1), 1.0)
    sigmas = np.asarray(sigmas, dtype=np.float64).reshape(-1)
    deficits = np.maximum(
        np.asarray(deficits, dtype=np.int64).reshape(-1), 0)
    if not (n_now.shape == sigmas.shape == deficits.shape):
        raise ValueError("n_now, sigmas, deficits must align")
    if weights is None:
        w = np.ones_like(n_now)
    else:
        w = np.asarray(weights, dtype=np.float64).reshape(-1)
        if w.shape != n_now.shape:
            raise ValueError("weights must align with n_now")
        if not np.all(np.isfinite(w)) or np.any(w <= 0):
            raise ValueError("weights must be finite and > 0")
    budget = int(budget)
    total = int(deficits.sum())
    if budget >= total or total == 0:
        return deficits.copy()
    if min_per_store > 0:
        base = np.minimum(deficits, int(min_per_store))
        covered = int(base.sum())
        if covered >= budget:
            return proportional_allocate(base, budget)
        rest = split_budget(n_now + base, sigmas, deficits - base,
                            budget - covered, weights=weights)
        return base + rest
    # Unknown sigma (cold store, NaN) -> dominate every known marginal.
    # A KNOWN zero sigma stays zero: its error cannot shrink, so it is
    # served last, not first.
    known = sigmas[np.isfinite(sigmas) & (sigmas > 0)]
    fill = (float(known.max()) * 1e3) if known.size else 1.0
    # Priority weight scales the EFFECTIVE sigma: a weight-w store's
    # marginal w*sigma/n^1.5 levels against everyone else's, so it
    # drains first at equal observed error.  A known zero sigma stays
    # zero under any weight.
    sig = np.where(np.isfinite(sigmas), np.maximum(sigmas, 0.0), fill) * w
    if not np.any(sig > 0):
        # No marginal signal at all: plain proportional split.
        return proportional_allocate(deficits, budget)

    def allocated(level: float) -> np.ndarray:
        want = np.power(sig / level, 2.0 / 3.0) - n_now
        return np.clip(want, 0.0, deficits.astype(np.float64))

    # Marginal at zero extra samples bounds the level from above.
    hi = float(np.max(sig / np.power(n_now, 1.5))) * 2.0
    lo = hi * 1e-12
    for _ in range(80):
        mid = math.sqrt(hi * lo)
        if allocated(mid).sum() > budget:
            lo = mid  # level too low -> giving out too much
        else:
            hi = mid
    x = np.floor(allocated(hi)).astype(np.int64)
    # Hand out the rounding remainder greedily by current marginal gain.
    rem = budget - int(x.sum())
    if rem > 0:
        gain = sig / np.power(n_now + x, 1.5)
        gain[x >= deficits] = -np.inf
        for i in np.argsort(-gain)[:rem]:
            if gain[i] > -np.inf and x[i] < deficits[i]:
                x[i] += 1
    # Whatever the waterfill could not place (e.g. the deficit bulk sits
    # on zero-marginal stores) still belongs to this tick's budget: fill
    # remaining capacity proportionally instead of dropping it.
    rem = budget - int(x.sum())
    if rem > 0:
        x = x + proportional_allocate(deficits - x, rem)
    return x
