"""The port's slice as a whole against the reference: the multi-query
executor on ``route="host"`` (bit-identical) and ``route="device"`` (the
torch tick on the CPU against the reference's fp32 device route), the
drift guard, zone pruning, and the admission loop.

Queries and tables are built per package from the same seeds; answers
cross as plain numbers.  Device tolerances are the reference's own
(``test_device_store.py``): values rel 2e-3, groups rel 5e-3, draw
ledgers identical.
"""
import dataclasses
import inspect
import sys

import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as TC
from repro.launch import serve as RS
from repro_torch.core import distributed as TD
from repro_torch.launch import serve as TS

MU, SIGMA = 100.0, 20.0
N_BLOCKS, N_GROUPS = 4, 3


def _tables(seed=0, rows=3000, n_blocks=N_BLOCKS):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        g = rng.integers(0, N_GROUPS, size=rows)
        out.append({
            "value": rng.normal(MU - 8.0 + 2.0 * g, SIGMA),
            "region": g.astype(np.float64),
            "flag": rng.integers(0, 2, size=rows).astype(np.float64),
            "day": np.full(rows, float(b % (n_blocks // 2))),
        })
    return out


def _queries(C, e=1.0):
    """The five queries of the reference's device-route parity test."""
    flag = C.Predicate(column="flag", eq=1.0)
    return [
        C.IslaQuery(e=e, agg="AVG"),
        C.IslaQuery(e=e, agg="AVG", group_by="region"),
        C.IslaQuery(e=e, agg="SUM", where=flag),
        C.IslaQuery(e=e, agg="COUNT", group_by="region", where=flag),
        C.IslaQuery(e=e, agg="VAR"),
    ]


def _executor(C, tables, zone=False, **kw):
    sizes = [10 ** 7] * len(tables)
    zm = C.ZoneMap.from_tables(tables, measure="value") if zone else None
    return C.MultiQueryExecutor(
        [C.table_sampler(t) for t in tables], sizes,
        params=C.IslaParams(e=1.0), group_domains={"region": N_GROUPS},
        zone_map=zm, **kw)


def _assert_device_close(d, r):
    assert d.value == pytest.approx(r.value, rel=2e-3)
    assert d.new_samples == r.new_samples
    assert d.sample_size == r.sample_size
    assert (d.groups is None) == (r.groups is None)
    if r.groups is not None:
        for gd, gr in zip(d.groups, r.groups):
            assert gd.n_samples == gr.n_samples
            assert gd.value == pytest.approx(gr.value, rel=5e-3)


def _answer_tuple(a):
    groups = None if a.groups is None else [
        (g.group, g.value, g.mean, g.error_bound, g.n_samples, g.est_size)
        for g in a.groups]
    return (a.value, a.mean, a.error_bound, a.sampling_rate, a.sample_size,
            a.mode, a.pass_id, a.n_matched, a.est_population, a.new_samples,
            a.half_width, a.served, groups)


@pytest.mark.parametrize("incremental", [False, True])
def test_host_route_bit_identical(incremental):
    """route="host" is the reference's host code: every answer field is
    bit-identical (==), one-shot and across warm incremental ticks, for
    every aggregate including host-route COUNT DISTINCT."""
    tables = _tables()
    batches = []
    for C in (RC, TC):
        qs = _queries(C) + [
            C.IslaQuery(e=0.5, agg="AVG", mode="faithful_cf",
                        where=C.Predicate(column="value", lo=95.0)),
            C.IslaQuery(e=1.0, agg="count_distinct", group_by="region"),
        ]
        ex = _executor(C, tables, zone=True, **(
            {"device": "cpu"} if C is TC else {}))
        runs = []
        for tick in range(3 if incremental else 1):
            runs.append(ex.run(qs, np.random.default_rng(11 + tick),
                               mode="auto", route="host",
                               incremental=incremental))
        batches.append(runs)
    for r_run, t_run in zip(*batches):
        for r, t in zip(r_run, t_run):
            assert _answer_tuple(t) == _answer_tuple(r)


@pytest.mark.parametrize("engine,mode", [("sequential", "faithful"),
                                         ("batched", "calibrated"),
                                         ("batched", "empirical")])
def test_aggregate_bit_identical(engine, mode):
    """The copied host layers: ``aggregate`` over the same samplers and
    seed is bit-identical to the reference, per block and in total."""
    out = {}
    for C in (RC, TC):
        samplers = [(lambda n, r, m=MU + 3 * b: r.normal(m, SIGMA, size=n))
                    for b in range(6)]
        out[C] = C.aggregate(samplers, [10 ** 6] * 6, C.IslaParams(e=0.5),
                             np.random.default_rng(8), mode=mode,
                             engine=engine)
    r, t = out[RC], out[TC]
    assert (t.answer, t.sketch0, t.sigma, t.sample_size) == (
        r.answer, r.sketch0, r.sigma, r.sample_size)
    if engine == "batched":
        assert np.array_equal(t.blocks.avg, r.blocks.avg)
        assert np.array_equal(t.blocks.mom_s, r.blocks.mom_s)
    else:  # per-block BlockResult records
        assert [dataclasses.astuple(b.param_s) + (b.avg, b.n_iter)
                for b in t.blocks] == [
            dataclasses.astuple(b.param_s) + (b.avg, b.n_iter)
            for b in r.blocks]


def test_device_route_matches_reference_device_route():
    """route="device", incremental, over several ticks: the port's torch
    tick against the reference's jnp tick on the same queries and seeds;
    a warm repeat draws 0 and a tighter demand tops up the same deficit."""
    tables = _tables()
    r_ex = _executor(RC, tables)
    t_ex = _executor(TC, tables, device="cpu")
    for seed in (5, 6):
        ar = r_ex.run(_queries(RC), np.random.default_rng(seed),
                      incremental=True, route="device")
        at = t_ex.run(_queries(TC), np.random.default_rng(seed),
                      incremental=True, route="device")
        for d, r in zip(at, ar):
            _assert_device_close(d, r)
    assert all(a.new_samples == 0 for a in at)  # the warm repeat
    tight_r = [RC.IslaQuery(e=0.5, agg="AVG", group_by="region")]
    tight_t = [TC.IslaQuery(e=0.5, agg="AVG", group_by="region")]
    (r3,) = r_ex.run(tight_r, np.random.default_rng(9), incremental=True,
                     route="device")
    (d3,) = t_ex.run(tight_t, np.random.default_rng(9), incremental=True,
                     route="device")
    assert d3.new_samples == r3.new_samples > 0
    _assert_device_close(d3, r3)


def test_device_one_shot_and_budget_match_reference():
    """The one-shot device route (torch Phase 2 over host moments) and a
    budget-capped incremental tick with a QoS floor."""
    tables = _tables()
    r_ex, t_ex = _executor(RC, tables), _executor(TC, tables, device="cpu")
    ar = r_ex.run(_queries(RC), np.random.default_rng(3), route="device")
    at = t_ex.run(_queries(TC), np.random.default_rng(3), route="device")
    for d, r in zip(at, ar):
        _assert_device_close(d, r)
    kw = dict(incremental=True, route="device", budget=6000,
              budget_floor=100)
    ar = r_ex.run(_queries(RC, e=0.5), np.random.default_rng(4), **kw)
    at = t_ex.run(_queries(TC, e=0.5), np.random.default_rng(4), **kw)
    for d, r in zip(at, ar):
        _assert_device_close(d, r)
        assert d.error_bound == r.error_bound


def test_drift_reset_matches_reference():
    """The drift guard on the device route: a stable table keeps the warm
    stores, a shifted one resets and re-converges — as the reference."""
    out = {}
    for C, kw in ((RC, {}), (TC, {"device": "cpu"})):
        rng = np.random.default_rng(2)
        tables = [{"value": rng.normal(MU, SIGMA, 3000)} for _ in range(4)]
        ex = C.MultiQueryExecutor([C.table_sampler(t) for t in tables],
                                  [10 ** 6] * 4,
                                  params=C.IslaParams(e=1.0), **kw)
        q = [C.IslaQuery(e=1.0, agg="AVG")]
        run = dict(incremental=True, route="device", drift_check=6.0)
        ex.run(q, np.random.default_rng(1), incremental=True,
               route="device")
        (a,) = ex.run(q, np.random.default_rng(2), **run)
        ex.block_samplers = [C.table_sampler(
            {"value": rng.normal(MU + 150.0, SIGMA, 3000)})
            for _ in range(4)]
        (b,) = ex.run(q, np.random.default_rng(3), **run)
        out[C] = (a, b)
    (ra, rb), (ta, tb) = out[RC], out[TC]
    assert ta.new_samples == ra.new_samples == 0
    assert tb.new_samples == rb.new_samples > 0
    assert tb.value == pytest.approx(rb.value, rel=2e-3)
    assert abs(tb.value - (MU + 150.0)) < 5.0


def test_zone_pruned_predicate_matches_reference():
    """A day-selective WHERE the zone map proves empty on most blocks: the
    compacted device tick against the reference's, same pruned budget."""
    tables = _tables(n_blocks=24, rows=2000)
    answers = {}
    for C, kw in ((RC, {}), (TC, {"device": "cpu"})):
        ex = _executor(C, tables, zone=True, **kw)
        day = C.Predicate(column="day", eq=3.0)
        qs = [C.IslaQuery(e=1.0, agg="AVG", where=day),
              C.IslaQuery(e=1.0, agg="SUM", where=day, group_by="region")]
        answers[C] = [ex.run(qs, np.random.default_rng(7 + k),
                             incremental=True, route="device")
                      for k in range(2)]
        if C is TC:
            stacks = list(ex._device_stacks.values())
            assert stacks and stacks[0]._active_cache  # compacted fold ran
    for r_run, t_run in zip(answers[RC], answers[TC]):
        for d, r in zip(t_run, r_run):
            _assert_device_close(d, r)
    full = {b for b, t in enumerate(tables) if t["day"][0] == 3.0}
    assert answers[TC][0][0].sample_size > 0 and len(full) == 2


def test_admission_loop_matches_reference():
    """IslaAdmissionLoop fed explicit queries over three ticks: dedupe,
    subsumption and warm serves line up with the reference's loop."""
    done = {}
    for C, S, kw in ((RC, RS, {}), (TC, TS, {"device": "cpu"})):
        samplers = S._synthetic_grouped_blocks(6, N_GROUPS, 3000, seed=0)
        ex = C.MultiQueryExecutor(samplers, [10 ** 6] * 6,
                                  params=C.IslaParams(e=0.5),
                                  group_domains={"region": N_GROUPS}, **kw)
        loop = S.IslaAdmissionLoop(ex, np.random.default_rng(1),
                                   route="device", incremental=True,
                                   deadline_samples=20000, budget_floor=64)
        flag = C.Predicate(column="flag", eq=1.0)
        ticks = [
            [C.IslaQuery(e=0.5, agg="AVG"),
             C.IslaQuery(e=0.5, agg="AVG"),
             C.IslaQuery(e=0.5, agg="SUM", group_by="region", where=flag)],
            [C.IslaQuery(e=1.0, agg="AVG"),
             C.IslaQuery(e=0.5, agg="VAR", priority=4.0)],
            [C.IslaQuery(e=0.5, agg="COUNT", where=flag)],
        ]
        out = []
        for batch in ticks:
            for q in batch:
                loop.submit(q)
            out.extend(loop.tick())
        done[C] = (out, loop.stats)
    (r_out, r_stats), (t_out, t_stats) = done[RC], done[TC]
    assert [t.tid for t in t_out] == [t.tid for t in r_out]
    for t, r in zip(t_out, r_out):
        assert t.answer.served == r.answer.served
        assert t.tick_answered == r.tick_answered
        _assert_device_close(t.answer, r.answer)
    for k in ("samples_drawn", "deduped", "subsumed", "plan_cache_hits",
              "plan_cache_misses"):
        assert t_stats[k] == r_stats[k]


def test_device_pilot_matches_host_reduction():
    """The device pilot (one pilot kernel launch on the card) reproduces
    the host pilot's (sketch0, sigma, min) within fp32 tolerance."""
    v = np.random.default_rng(4).normal(1234.5, 17.0, size=4097)
    mean, sigma, lo = TD.pilot_stats_device(v, device="cpu")
    assert mean == pytest.approx(v.mean(), rel=1e-6)
    assert sigma == pytest.approx(v.std(ddof=1), rel=1e-4)
    assert lo == pytest.approx(v.min(), rel=1e-6)


def test_unported_routes_raise():
    """The pipelined tick still raises; the mesh route runs, one-shot and
    incremental, moments and COUNT DISTINCT, on a one-shard CPU mesh."""
    tables = _tables()
    ex = _executor(TC, tables, device="cpu")
    with pytest.raises(NotImplementedError, match="pipelined"):
        ex.run(_queries(TC), np.random.default_rng(0), incremental=True,
               route="device", pipeline=True)
    for queries, incremental in (
            (_queries(TC), False),
            ([TC.IslaQuery(e=1.0, agg="count_distinct")], True)):
        answers = ex.run(queries, np.random.default_rng(0), route="mesh",
                         incremental=incremental)
        assert all(np.isfinite(a.value) for a in answers)
    assert ex.mesh.devices == (torch.device("cpu"),)


def test_entry_points_default_to_the_device_route(monkeypatch, capsys):
    """The port's entry points take the device route on ``cuda`` unless
    asked otherwise.  Without a card a default run raises, while the host
    route asked for explicitly never resolves the device."""
    for fn in (TC.MultiQueryExecutor.run, TC.MultiQueryExecutor.plan,
               TC.MultiQueryExecutor.prefetch_plan, TS.IslaAdmissionLoop):
        assert inspect.signature(fn).parameters["route"].default == "device"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = _executor(TC, _tables())
    (a,) = ex.run(_queries(TC)[:1], np.random.default_rng(0), route="host")
    assert np.isfinite(a.value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.run(_queries(TC)[:1], np.random.default_rng(0))
    loop = TS.IslaAdmissionLoop(_executor(TC, _tables()),
                                np.random.default_rng(0))
    loop.submit(_queries(TC)[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.tick()
    for argv, ok in ((["serve", "--workload", "isla", "--smoke",
                       "--incremental"], False),
                     (["serve", "--workload", "isla", "--smoke",
                       "--incremental", "--route", "host"], True)):
        monkeypatch.setattr(sys, "argv", argv)
        if ok:
            TS.main()
            assert "served 6 queries over 2 ticks" in capsys.readouterr().out
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                TS.main()


def test_serve_cli_smoke(capsys):
    """The port's serve entry point end to end on the CPU."""
    argv = sys.argv
    sys.argv = ["serve", "--workload", "isla", "--smoke", "--device", "cpu",
                "--incremental", "--route", "device", "--drift-check", "6.0"]
    try:
        TS.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "served 6 queries over 2 ticks" in out
