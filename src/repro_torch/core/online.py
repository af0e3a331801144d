"""Online-aggregation extension (paper §VII-A).

A block keeps only (param_S, param_L) between rounds.  A continuation round
draws more samples, merges moments, and re-runs Phase 2 — precision improves
monotonically in expectation while storage stays O(1).

The scalar ``OnlineBlockState`` / ``continue_block`` API is kept as the
single-block view; its internals now ride ``MomentStore`` (the persistent
(group, block) store the serving tier refines round after round), so the
merge is the same carry-prepend continuation that keeps k short rounds
bit-identical to one longer stream.  ``reanchor=True`` fixes the stale-
sketch continuation: later rounds iterate against the previous merged
answer instead of the initial rough sketch0 forever.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .engine import Sampler
from .modulation import ModulationResult
from .moment_store import MomentStore
from .types import Boundaries, IslaParams, RegionMoments


@dataclasses.dataclass
class OnlineBlockState:
    """Everything a block must persist between rounds — 9 numbers + bounds."""

    block_id: int
    boundaries: Boundaries
    sketch0: float
    shift: float
    param_s: RegionMoments
    param_l: RegionMoments
    rounds: int = 0
    n_sampled: int = 0

    @staticmethod
    def fresh(block_id: int, boundaries: Boundaries, sketch0: float,
              shift: float = 0.0) -> "OnlineBlockState":
        return OnlineBlockState(
            block_id=block_id, boundaries=boundaries, sketch0=sketch0,
            shift=shift, param_s=RegionMoments.zeros_np(),
            param_l=RegionMoments.zeros_np())

    def as_store(self) -> MomentStore:
        """The 1-cell ``MomentStore`` view of this block's state.

        The scalar state keeps no plain-totals ledger, so the store is
        built regions-only (``has_totals=False``) — seeding totals at
        zeros would leave them cumulative-inconsistent with the seeded
        region moments and ``n_sampled``.
        """
        store = MomentStore.fresh(1, self.boundaries, self.sketch0,
                                  shift=self.shift, has_totals=False)
        store.mom_s[0] = (self.param_s.count, self.param_s.s1,
                          self.param_s.s2, self.param_s.s3)
        store.mom_l[0] = (self.param_l.count, self.param_l.s1,
                          self.param_l.s2, self.param_l.s3)
        store.rounds = self.rounds
        store.n_sampled[0] = self.n_sampled
        return store


def continue_block(state: OnlineBlockState, sampler: Sampler, n_new: int,
                   params: IslaParams, rng: np.random.Generator,
                   mode: str = "faithful", reanchor: bool = False
                   ) -> Tuple[OnlineBlockState, ModulationResult]:
    """One more round: draw n_new samples, merge moments, re-run Phase 2.

    ``reanchor=True`` re-anchors the sketch from the merged moments after
    solving, so the next round's Phase 2 iterates against the refined
    answer instead of the initial sketch0 forever (a continuation that
    never re-anchors keeps pulling every round toward the round-0 rough
    picture).  mode="faithful" maps onto its algebraic closed form here
    (the batched Phase 2 never runs a data-dependent loop; they agree to
    1e-12 — see ``engine.phase2_iteration_batch``).
    """
    store = state.as_store()
    raw = np.asarray(sampler(max(1, n_new), rng), dtype=np.float64)
    store.ingest(raw + state.shift,
                 np.zeros(raw.size, dtype=np.intp),
                 np.array([raw.size], dtype=np.int64))
    res = store.solve(params, mode=mode)
    if reanchor:
        store.reanchor(res.avg)
    new_state = dataclasses.replace(
        state,
        sketch0=store.sketch0,
        param_s=RegionMoments(*(float(x) for x in store.mom_s[0])),
        param_l=RegionMoments(*(float(x) for x in store.mom_l[0])),
        rounds=store.rounds,
        n_sampled=int(store.n_sampled[0]),
    )
    # report the un-shifted partial
    mod = ModulationResult(
        avg=float(res.avg[0]) - state.shift, alpha=float(res.alpha[0]),
        sketch=float(res.sketch[0]), d=float(res.d[0]),
        n_iter=int(res.n_iter[0]), case=int(res.case[0]))
    return new_state, mod
