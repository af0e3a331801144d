"""ISLA serving entry point, PyTorch port: an admission loop around
``MultiQueryExecutor``.

Queries (AVG/SUM/COUNT/VAR/count_distinct with WHERE + GROUP BY) arrive
asynchronously, are admitted per tick, planned into shared sampling
passes per resolved Phase 2 mode, and answered with provenance (rate,
pass id, resolved mode, bound):

  PYTHONPATH=src python -m repro_torch.launch.serve --workload isla \
      --ticks 4
  PYTHONPATH=src python -m repro_torch.launch.serve --workload isla \
      --smoke --device cpu

With ``--incremental`` the loop keeps persistent per-(where, group_by,
mode) moment stores across ticks: repeat predicates are served from warm
moments and each tick draws only the sample deficit its batch still owes;
``--deadline-samples N`` caps a tick at N new samples, split across stores
by marginal-error reduction (answers refine over later ticks).

The route is ``device`` unless ``--route host`` asks for the float64
numpy route on the CPU.  With ``--incremental`` the device route runs the
DEVICE-RESIDENT tick: per-(where, group_by, mode) moments live as torch
tensors on ``--device`` (``cuda`` by default; ``--device cpu`` runs the
kernels' plain versions) between ticks, and each tick is one fused tick
per mode-group — the hand-written CUDA fold onto the resident rows (and,
for COUNT DISTINCT keys, the hand-written CUDA HLL register merge onto
the resident register plane), Phase 2 and the group stats — with only
scalar answers and O(groups) rows crossing back:

  PYTHONPATH=src python -m repro_torch.launch.serve --workload isla \
      --smoke --incremental --drift-check 6.0

The admission pipeline (plan cache, subsumption, same-tick dedupe,
priority order) is on by default with ``--incremental``;
``--no-admission`` restores the plain FIFO loop.  ``--route mesh`` runs the
resident tick with its cell axis split by block runs over a cell mesh:
one shard a visible card, or with ``--device cpu`` one shard on the CPU
(``launch/mesh.py``).

``--pipeline`` pipelines each tick: while one mode-group's chunk ticks run
on the launch worker, the host draws the next chunk and the next group's
rows, and the previous group composes from stat rows read back through
pinned buffers and CUDA events (answers are the serial tick's bit for
bit: only WHEN stages run moves); between ticks the loop prefetches the
queued batch's plan.  The per-tick log gains a stages[ms] segment (plan
draw h2d launch readback compose):

  PYTHONPATH=src python -m repro_torch.launch.serve --workload isla \
      --smoke --incremental --pipeline --device cpu

``--workload lm``, the default as in the reference, serves an LM through
the slot scheduler (``serve/``):
``--arch`` (olmo-1b by default) with random params from ``--seed``,
``--requests`` prompts of 4-11 seeded tokens, ``--max-new`` tokens each,
over ``--slots`` slots of ``--max-seq`` cache rows; every prefill runs the
hand-written flash-attention kernel on ``--device`` (cuda by default):

  PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \
      --reduced --device cpu
"""
from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import time
from typing import Optional

import numpy as np

from ..core import IslaParams, IslaQuery, Predicate, ZoneMap
from ..core.multiquery import MultiQueryExecutor, table_sampler
from ..core.types import AnswerKey, demand_dominates


# ---------------------------------------------------------------------------
# ISLA serving tier: admission loop around MultiQueryExecutor.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IslaTicket:
    """An admitted query waiting for (or holding) its answer.

    ``progress`` is the OLA progressive stream: one
    ``(tick, value, half_width, error_bound)`` snapshot per tick the
    query was served an estimate, shrinking until the bound is earned."""

    tid: int
    query: "object"            # IslaQuery
    tick_submitted: int
    tick_answered: Optional[int] = None
    answer: Optional["object"] = None  # QueryAnswer
    progress: list = dataclasses.field(default_factory=list)
    holds: int = 0             # times deferred behind a dominating batch-mate


class IslaAdmissionLoop:
    """Batches arriving ISLA queries per tick and answers them from shared
    passes.

    Each ``tick()`` drains up to ``max_batch`` pending queries, hands the
    batch to ``MultiQueryExecutor.run`` — which plans one shared sampling
    pass per resolved Phase 2 mode-group — and returns the finished
    tickets.  Every answer carries provenance: the shared rate its pass
    sampled at, the pass id it shared with its batch-mates, and the
    resolved mode.

    Parameters
    ----------
    executor : MultiQueryExecutor
        The executor whose (possibly persistent) stores serve the ticks.
    rng : numpy.random.Generator
        RNG every tick's draws consume.
    mode : str, optional
        Default Phase 2 mode handed to ``run`` (queries may override).
    route : str, optional
        ``"device"`` (the default), ``"host"`` (float64 numpy on the
        CPU) or ``"mesh"``; with ``incremental=True`` the device route
        keeps every store's moments resident between ticks and runs each
        tick as one fused tick per mode-group on the executor's device,
        and the mesh route shards that state and tick over the
        executor's cell mesh.
    max_batch : int, optional
        Most queries admitted per tick; overflow waits for the next tick.
    incremental : bool, optional
        Turn ticks into continuation rounds: every pass merges into the
        executor's persistent per-(where, group_by, mode) moment stores,
        so a repeat predicate in a later tick is served from the warm
        store and draws only its sample deficit (zero when the store is
        already ahead).
    deadline_samples : int, optional
        Deadline-aware tick budget: at most that many NEW samples per
        tick, split across the tick's passes by marginal-error reduction
        (``moment_store.split_budget``) — starved stores absorb the
        budget first, and answers that could not earn their (e, beta)
        this tick report a best-effort bound and refine on later ticks.
    drift_check : float, optional
        Staleness guard: probe the frozen anchors each tick; global drift
        resets all warm stores (cold re-pilot), drift confined to one
        refined predicate's sub-population resets only that key.
    budget_floor : int, optional
        Per-pass sample floor within the ``deadline_samples`` split
        (admission-loop QoS): a flood of new predicates cannot starve a
        nearly-converged store's small top-up.
    admission : bool, optional
        The multi-tenant admission pipeline (default: on iff
        ``incremental``).  Per tick: drain ALL pending tickets in
        priority order (stable — equal priorities keep FIFO), serve
        queries the executor's subsumption answer cache dominates with
        ZERO new samples, dedupe exact same-tick duplicates onto one
        executed representative (``dedupe_fanout`` counts the fan-out),
        hold a query whose batch-mate dominates it on the same
        ``AnswerKey`` and serve it from that fresh answer after the run,
        and execute only the surviving representatives (``max_batch``
        caps those alone — cache serves are free).  ``False`` is the
        plain FIFO loop.
    progressive : bool, optional
        OLA-style streaming (requires ``incremental``): a ticket whose
        computed answer has not yet EARNED its ``(e, beta)`` bound stays
        in flight — each tick it re-enters the batch, tops up its
        deficit, and appends an ``(tick, value, half_width, bound)``
        snapshot to ``ticket.progress`` — and completes only when the
        bound is met.  Off (default), every ticket completes the tick it
        runs, degraded bounds reported honestly.
    pipeline : bool, optional
        Pipelined ticks: each ``run`` overlaps a mode-group's chunk ticks
        with the next group's host draw and the previous group's compose
        (``MultiQueryExecutor.run(pipeline=True)`` — answers stay the
        serial tick's bit for bit), and between ticks the loop PREFETCHES
        the plan-cache entry of the queued next batch.  Per-stage wall
        times accumulate in ``stage_seconds`` either way.

    Examples
    --------
    >>> loop = IslaAdmissionLoop(executor, rng, incremental=True,
    ...                          deadline_samples=20000, budget_floor=64)
    ... # doctest: +SKIP
    """

    def __init__(self, executor, rng: np.random.Generator,
                 mode: str = "calibrated", route: str = "device",
                 max_batch: int = 64, incremental: bool = False,
                 deadline_samples: Optional[int] = None,
                 drift_check: Optional[float] = None,
                 budget_floor: Optional[int] = None,
                 admission: Optional[bool] = None,
                 progressive: bool = False,
                 pipeline: bool = False):
        self.executor = executor
        self.rng = rng
        self.mode = mode
        self.route = route
        self.max_batch = int(max_batch)
        self.incremental = bool(incremental)
        if deadline_samples is not None and not self.incremental:
            raise ValueError(
                "deadline_samples is the incremental tick budget (split "
                "across warm stores by marginal error); without "
                "incremental=True there is no deficit ledger to budget "
                "against — pass incremental=True or drop the deadline")
        if drift_check is not None and not self.incremental:
            raise ValueError(
                "drift_check probes the frozen incremental anchor; it "
                "requires incremental=True")
        if budget_floor is not None and deadline_samples is None:
            raise ValueError(
                "budget_floor floors the deadline_samples split; it "
                "requires deadline_samples=")
        if progressive and not self.incremental:
            raise ValueError(
                "progressive streams refinement across ticks via the "
                "persistent store ledger; it requires incremental=True")
        self.deadline_samples = deadline_samples
        self.drift_check = drift_check
        self.budget_floor = budget_floor
        self.admission = (self.incremental if admission is None
                          else bool(admission))
        self.progressive = bool(progressive)
        self.pipeline = bool(pipeline)
        self._pending = collections.deque()
        self._inflight: "list[IslaTicket]" = []
        self._next_tid = 0
        self._tick = 0
        self.answered = []
        self.samples_drawn = 0  # cumulative NEW samples across ticks
        self.deduped = 0        # tickets fanned out from an exact duplicate
        self.subsumed = 0       # tickets served from the answer cache
        # Per-stage wall seconds (plan, draw, h2d, launch, readback,
        # compose), accumulated over every executed tick's run().
        self.stage_seconds: "dict[str, float]" = {}

    def submit(self, query) -> int:
        """Admit one query; returns its ticket id."""
        tid = self._next_tid
        self._next_tid += 1
        self._pending.append(IslaTicket(tid=tid, query=query,
                                        tick_submitted=self._tick))
        return tid

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def in_flight(self) -> int:
        """Progressive tickets still refining toward their bound."""
        return len(self._inflight)

    @property
    def stats(self) -> dict:
        """Cumulative admission counters (plan cache, subsumption,
        dedupe, samples) — the serve CLI's per-tick log reads deltas."""
        ex = self.executor
        return {
            "ticks": self._tick,
            "answered": len(self.answered),
            "samples_drawn": self.samples_drawn,
            "deduped": self.deduped,
            "subsumed": self.subsumed,
            "in_flight": len(self._inflight),
            "plan_cache_hits": getattr(ex, "plan_cache_hits", 0),
            "plan_cache_misses": getattr(ex, "plan_cache_misses", 0),
            "plan_cache_evictions": getattr(ex, "plan_cache_evictions", 0),
            "answers_cached": getattr(ex, "answers_cached", 0),
            "plans_prefetched": getattr(ex, "plans_prefetched", 0),
            "stage_seconds": dict(self.stage_seconds),
        }

    @staticmethod
    def _dedupe_key(q):
        """Exact same-tick duplicate identity: everything but priority
        (the fan-out's effective priority is the max over members, which
        priority-descending admission makes the representative's)."""
        return (q.agg, q.where, q.group_by, q.mode, q.e, q.beta)

    def _answer_key(self, q):
        return AnswerKey.from_query(q, default_mode=self.mode)

    def _dominating_mate(self, t: IslaTicket,
                         execute: "list[IslaTicket]") -> bool:
        """True when an already-admitted batch-mate's demand dominates
        this ticket's on the same AnswerKey — its fresh answer can serve
        this ticket after the run, so the ticket holds instead of
        executing."""
        ak = self._answer_key(t.query)
        for r in execute:
            if self._answer_key(r.query) == ak and demand_dominates(
                    r.query.e, r.query.beta, t.query.e, t.query.beta):
                return True
        return False

    def _finish(self, t: IslaTicket, answer) -> None:
        t.answer = answer
        t.tick_answered = self._tick
        t.progress.append((self._tick, answer.value, answer.half_width,
                           answer.error_bound))
        self.answered.append(t)

    def tick(self) -> "list[IslaTicket]":
        """Serve one admission round; returns the tickets COMPLETED now
        (progressive tickets may stay in flight across ticks)."""
        self._tick += 1
        tickets = list(self._inflight)
        self._inflight = []
        incoming = []
        while self._pending:
            incoming.append(self._pending.popleft())
        if self.admission:
            # Priority-ordered admission; the sort is stable, so equal
            # priorities keep strict FIFO.
            incoming.sort(key=lambda t: -t.query.priority)
        tickets.extend(incoming)
        if not tickets:
            return []

        done: "list[IslaTicket]" = []
        execute: "list[IslaTicket]" = []
        dups: "dict[tuple, list[IslaTicket]]" = {}
        held: "list[IslaTicket]" = []
        overflow: "list[IslaTicket]" = []
        if self.admission:
            reps: "dict[tuple, IslaTicket]" = {}
            for t in tickets:
                served = (self.executor.lookup_answer(t.query,
                                                      mode=self.mode)
                          if self.incremental else None)
                if served is not None:
                    # A dominating earned answer already exists: zero new
                    # samples, bound no looser than asked.
                    self._finish(t, served)
                    done.append(t)
                    self.subsumed += 1
                    continue
                dk = self._dedupe_key(t.query)
                if dk in reps:
                    dups.setdefault(dk, []).append(t)
                    continue
                if len(execute) >= self.max_batch:
                    overflow.append(t)
                    continue
                if t.holds == 0 and self._dominating_mate(t, execute):
                    # A stronger batch-mate answers the same AnswerKey
                    # this tick; ride its answer instead of executing.
                    # One hold max — a missed retry executes next tick.
                    t.holds += 1
                    held.append(t)
                    continue
                reps[dk] = t
                execute.append(t)
        else:
            execute = tickets[:self.max_batch]
            overflow = tickets[self.max_batch:]

        if execute:
            answers = self.executor.run(
                [t.query for t in execute], self.rng, mode=self.mode,
                route=self.route, incremental=self.incremental,
                budget=self.deadline_samples if self.incremental else None,
                drift_check=self.drift_check,
                budget_floor=self.budget_floor,
                pipeline=self.pipeline)
            for k, v in getattr(self.executor, "last_stage_times",
                                {}).items():
                self.stage_seconds[k] = self.stage_seconds.get(k, 0.0) + v
            seen_passes = set()
            for t, a in zip(execute, answers):
                if a.new_samples is not None \
                        and a.pass_id not in seen_passes:
                    self.samples_drawn += a.new_samples
                    seen_passes.add(a.pass_id)
                mates = dups.get(self._dedupe_key(t.query), [])
                if mates:
                    a = dataclasses.replace(a, dedupe_fanout=1 + len(mates))
                if self.progressive and a.error_bound is None:
                    # Not earned yet: stream a snapshot, keep refining.
                    t.progress.append((self._tick, a.value, a.half_width,
                                       a.error_bound))
                    t.answer = a
                    self._inflight.append(t)
                else:
                    self._finish(t, a)
                    done.append(t)
                for d in mates:
                    da = copy.copy(a)  # cheaper than dataclasses.replace
                    da.query = d.query
                    da.served = "dedupe"
                    da.dedupe_fanout = 1 + len(mates)
                    da.new_samples = 0  # drawn once, by the representative
                    if self.progressive and da.error_bound is None:
                        d.progress.append((self._tick, da.value,
                                           da.half_width, da.error_bound))
                        d.answer = da
                        self._inflight.append(d)
                    else:
                        self._finish(d, da)
                        done.append(d)
                        self.deduped += 1

        for t in held:
            # The dominator just ran: its earned answer is now cached.
            served = self.executor.lookup_answer(t.query, mode=self.mode)
            if served is not None:
                self._finish(t, served)
                done.append(t)
                self.subsumed += 1
            else:
                # Dominator didn't earn/cover this tick — the ticket
                # executes unconditionally next tick (holds == 1).
                overflow.append(t)

        # Overflow returns to the FRONT of the queue, in order, ahead of
        # anything submitted after this tick started.
        self._pending.extendleft(reversed(overflow))
        done.sort(key=lambda t: t.tid)
        self._prefetch_pending()
        return done

    def _prefetch_pending(self) -> None:
        """Cross-tick plan prefetch (pipelined loops only): with the next
        tick's queries already queued, touch or compile their PlanCache
        entry now — planning is host-only Python that would otherwise
        serialize with the next tick's draws.  Best effort: the predicted
        batch mimics admission order and dedupe (subsumption serves are
        not predicted); a mispredicted batch is a plan-cache miss, exactly
        as if no prefetch ran, and warm planning consumes no RNG, so the
        draw stream is unchanged either way."""
        if not (self.pipeline and self.incremental and self._pending):
            return
        cand = list(self._pending)
        if self.admission:
            cand.sort(key=lambda t: -t.query.priority)
            seen, batch = set(), []
            for t in cand:
                dk = self._dedupe_key(t.query)
                if dk in seen:
                    continue
                seen.add(dk)
                batch.append(t.query)
                if len(batch) >= self.max_batch:
                    break
        else:
            batch = [t.query for t in cand[:self.max_batch]]
        self.executor.prefetch_plan(batch, mode=self.mode,
                                    route=self.route)

    def run_until_drained(self, max_ticks: int = 1000
                          ) -> "list[IslaTicket]":
        done = []
        while (self._pending or self._inflight) and max_ticks > 0:
            done.extend(self.tick())
            max_ticks -= 1
        return done


def _synthetic_grouped_blocks(n_blocks: int, n_groups: int, rows: int,
                              seed: int, with_tables: bool = False):
    """In-memory relational blocks: a measure, an integer GROUP BY key with
    group-dependent means, a binary row-level predicate column, and a
    block-clustered ``day`` column (each ingest day spans two blocks) —
    the shape zone maps prune.  ``with_tables=True`` additionally returns
    the raw column tables so the caller can build a ``ZoneMap``."""
    rng = np.random.default_rng(seed)
    n_days = max(n_blocks // 2, 1)
    samplers, tables = [], []
    for b in range(n_blocks):
        g = rng.integers(0, n_groups, size=rows)
        t = {
            "value": rng.normal(80.0 + 5.0 * g, 10.0),
            "region": g.astype(np.float64),
            "flag": rng.integers(0, 2, size=rows).astype(np.float64),
            "day": np.full(rows, float(b % n_days)),
        }
        tables.append(t)
        samplers.append(table_sampler(t))
    if with_tables:
        return samplers, tables
    return samplers


def _random_query(rng: np.random.Generator, e: float,
                  n_days: Optional[int] = None,
                  priority: float = 1.0):
    agg = ("AVG", "SUM", "COUNT", "VAR",
           "count_distinct")[int(rng.integers(0, 5))]
    where = None
    if rng.random() < 0.5:
        # Half the predicated queries are day-selective: the WHERE the
        # zone map proves empty on every other-day block.
        if n_days and rng.random() < 0.5:
            where = Predicate(column="day",
                              eq=float(rng.integers(0, n_days)))
        else:
            where = Predicate(column="flag", eq=1.0)
    group_by = "region" if rng.random() < 0.5 else None
    mode = ("calibrated", "faithful_cf", None)[int(rng.integers(0, 3))]
    return IslaQuery(e=e, beta=0.95, agg=agg, where=where,
                     group_by=group_by, mode=mode, priority=priority)


def _describe_answer(t: IslaTicket) -> str:
    a = t.answer
    q = t.query
    sel = q.where.describe() if q.where is not None else "TRUE"
    gb = q.group_by or "-"
    bound = ("exact" if a.error_bound == 0.0 else
             f"±{a.error_bound:.3g}" if a.error_bound is not None
             else "best-effort")
    fresh = (f" new={a.new_samples}" if a.new_samples is not None else "")
    via = f" via={a.served}" if a.served else ""
    fan = f" fanout={a.dedupe_fanout}" if a.dedupe_fanout > 1 else ""
    pri = f" pri={q.priority:g}" if q.priority != 1.0 else ""
    line = (f"  #{t.tid:<3d} {q.agg:>5}  where[{sel}] group_by[{gb}] "
            f"-> {a.value:.5g} [{bound}] mode={a.mode} pass={a.pass_id} "
            f"rate={a.sampling_rate:.2e}{fresh}{via}{fan}{pri} "
            f"tick={t.tick_answered}")
    if a.groups:
        cells = ", ".join(f"g{g.group}={g.value:.4g}(n={g.n_samples})"
                          for g in a.groups)
        line += f"\n        groups: {cells}"
    return line


def serve_isla(args) -> None:
    n_blocks = 8 if args.smoke else args.blocks
    n_groups = 3 if args.smoke else args.groups
    rows = 2000 if args.smoke else 20000
    ticks = 2 if args.smoke else args.ticks
    qpt = 3 if args.smoke else args.queries_per_tick
    e = 1.0 if args.smoke else args.precision

    samplers, tables = _synthetic_grouped_blocks(n_blocks, n_groups, rows,
                                                 args.seed,
                                                 with_tables=True)
    sizes = [10 ** 7] * n_blocks
    zone_map = None
    if not args.no_zone_map:
        zone_map = ZoneMap.from_tables(tables, measure="value")
    ex = MultiQueryExecutor(samplers, sizes, params=IslaParams(e=e),
                            group_domains={"region": n_groups},
                            zone_map=zone_map, device=args.device)
    weights = [float(w) for w in args.priority.split(",")] \
        if args.priority else [1.0]
    if any(w <= 0 for w in weights):
        raise SystemExit("--priority weights must be > 0")
    tenants = max(int(args.tenants), 1)
    loop = IslaAdmissionLoop(ex, np.random.default_rng(args.seed + 1),
                             mode="auto", route=args.route,
                             incremental=args.incremental,
                             deadline_samples=args.deadline_samples,
                             drift_check=args.drift_check,
                             budget_floor=args.budget_floor,
                             admission=(False if args.no_admission
                                        else None),
                             progressive=args.progressive,
                             pipeline=args.pipeline)
    n_days = max(n_blocks // 2, 1)
    qrng = np.random.default_rng(args.seed + 2)
    t0 = time.perf_counter()
    total = 0
    for _ in range(ticks):
        for j in range(qpt):
            # Round-robin tenants; each tenant's weight rides the query.
            pri = weights[(j % tenants) % len(weights)]
            loop.submit(_random_query(qrng, e,
                                      n_days=None if args.no_zone_map
                                      else n_days,
                                      priority=pri))
        before = loop.stats
        done = loop.tick()
        total += len(done)
        s = loop.stats
        extra = ""
        if args.incremental:
            extra = (f", {s['samples_drawn'] - before['samples_drawn']} "
                     f"new samples, plan-cache "
                     f"{s['plan_cache_hits'] - before['plan_cache_hits']}h/"
                     f"{s['plan_cache_misses'] - before['plan_cache_misses']}"
                     f"m, {s['subsumed'] - before['subsumed']} subsumed, "
                     f"{s['deduped'] - before['deduped']} deduped")
        if args.pipeline:
            b_st = before["stage_seconds"]
            extra += ", stages[ms] " + " ".join(
                f"{k}={1e3 * (v - b_st.get(k, 0.0)):.1f}"
                for k, v in s["stage_seconds"].items())
        flight = (f", {loop.in_flight} in flight" if loop.in_flight else "")
        print(f"tick {loop._tick}: answered {len(done)} queries, "
              f"{loop.pending} pending{flight}{extra}")
        for t in done:
            print(_describe_answer(t))
    dt = time.perf_counter() - t0
    s = loop.stats
    warm = ""
    if args.incremental:
        warm = (f", {s['samples_drawn']} samples total, plan-cache "
                f"{s['plan_cache_hits']}h/{s['plan_cache_misses']}m/"
                f"{s['plan_cache_evictions']}e, {s['subsumed']} subsumed, "
                f"{s['deduped']} deduped")
    print(f"served {total} queries over {ticks} ticks in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} q/s), "
          f"{n_blocks} blocks x {n_groups} groups{warm}")


# ---------------------------------------------------------------------------
# LM serving workload (the slot scheduler demo).
# ---------------------------------------------------------------------------


def serve_lm(args) -> None:
    import torch

    from ..configs import get_config
    from ..core.distributed import resolve_device
    from ..models import model as model_lib
    from ..serve import BatchScheduler, Request

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_lib.init_params(cfg, gen)
    sched = BatchScheduler(cfg, params, batch_slots=args.slots,
                           max_seq=args.max_seq, eos_id=-1)
    rng = np.random.default_rng(args.seed + 1)
    for rid in range(args.requests):
        plen = int(rng.integers(4, 12))
        prompt = [int(t) for t in rng.integers(0, cfg.vocab, plen)]
        sched.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))
    t0 = time.perf_counter()
    done = sched.run_until_drained()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s) on {device}")
    for r in done:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.generated}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=["isla", "lm"], default="lm",
                    help="lm (default, as in the reference): the LM slot "
                         "scheduler; isla: the approximate-aggregation "
                         "serving tier")
    ap.add_argument("--seed", type=int, default=0)
    # lm workload
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="lm: the arch's smoke-test scale")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    # isla workload
    ap.add_argument("--blocks", type=int, default=100)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--queries-per-tick", type=int, default=6)
    ap.add_argument("--precision", type=float, default=0.5)
    ap.add_argument("--route", choices=["host", "device", "mesh"],
                    default="device",
                    help="device (default): the pilot, Phase 2 and, with "
                         "--incremental, the resident tick run on "
                         "--device; mesh: that tick sharded over every "
                         "visible card (one CPU shard with --device cpu); "
                         "host: float64 numpy on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="where the device route keeps its stores and "
                         "runs its tick, and where the lm workload runs: "
                         "cuda (default; fails without a card) or cpu")
    ap.add_argument("--incremental", action="store_true",
                    help="persistent moment stores: warm-serve repeat "
                         "predicates, top up only sample deficits")
    ap.add_argument("--deadline-samples", type=int, default=None,
                    help="deadline-aware tick budget: max NEW samples per "
                         "tick, split across stores by marginal error")
    ap.add_argument("--drift-check", type=float, default=None,
                    help="staleness guard (incremental): pilot re-draw per "
                         "tick; reset warm stores when the anchor drifts "
                         "beyond this many standard errors (a drift "
                         "confined to one refined predicate resets only "
                         "that key)")
    ap.add_argument("--budget-floor", type=int, default=None,
                    help="QoS floor within the --deadline-samples split: "
                         "every pass with a deficit gets at least this "
                         "many samples per tick")
    ap.add_argument("--tenants", type=int, default=1,
                    help="multi-tenant traffic: queries round-robin over "
                         "this many tenants, each carrying its "
                         "--priority weight")
    ap.add_argument("--priority", type=str, default=None,
                    help="comma list of per-tenant priority weights "
                         "(> 0), e.g. '4,1': tenant 0's passes waterfill "
                         "at 4x weight in the tick budget split")
    ap.add_argument("--progressive", action="store_true",
                    help="OLA streaming (incremental): unearned answers "
                         "stay in flight, refine each tick, and complete "
                         "when their (e, beta) bound is met")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined ticks: overlap each mode-group's "
                         "chunk ticks with the next group's host draw "
                         "and the previous group's compose (answers are "
                         "bit-identical), prefetch next tick's plan "
                         "between ticks, and log per-stage wall times")
    ap.add_argument("--no-admission", action="store_true",
                    help="disable the admission pipeline (plan cache "
                         "serving, dedupe, subsumption, priority order): "
                         "the plain FIFO loop")
    ap.add_argument("--no-zone-map", action="store_true",
                    help="disable zone-map block pruning: plan every "
                         "WHERE over all blocks instead of rating "
                         "provably-empty blocks at zero (the default "
                         "builds a ZoneMap over the synthetic tables, "
                         "so day-selective predicates skip most blocks)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI smoke runs")
    args = ap.parse_args()
    if args.workload == "lm":
        serve_lm(args)
        return
    if args.deadline_samples is not None and not args.incremental:
        ap.error("--deadline-samples budgets the incremental deficit "
                 "ledger; it requires --incremental")
    if args.drift_check is not None and not args.incremental:
        ap.error("--drift-check probes the frozen incremental anchor; it "
                 "requires --incremental")
    if args.budget_floor is not None and args.deadline_samples is None:
        ap.error("--budget-floor floors the --deadline-samples split; it "
                 "requires --deadline-samples")
    if args.progressive and not args.incremental:
        ap.error("--progressive streams refinement across ticks via the "
                 "persistent stores; it requires --incremental")
    serve_isla(args)


if __name__ == "__main__":
    main()
