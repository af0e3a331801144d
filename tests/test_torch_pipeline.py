"""The pipelined tick (``MultiQueryExecutor.run(pipeline=True)``) of the
port on the CPU, against the port's serial schedule and the reference's
pipelined tick.

The contract, as in ``tests/test_pipeline.py``: the schedule moves (group
*k*'s chunk ticks run on the launch worker while the main thread draws,
and group *k* composes one group later from deferred stat rows), but the
RNG draw order and the per-cell merge order are the serial route's, so
answers, error bounds, group values, ``new_samples``, draw ledgers and
float64 state are the serial route's bit for bit, fp32 and float64, on
the host, device and mesh routes.  A drift reset between a group's
launch and its compose serves fresh stats (the ``_group_stale``
relaunch); the pipelined ticks upload what the serial ticks upload (the
port's counterpart of the reference's ``transfer_guard`` test); a
run-table fault under deferred stats raises to the caller and leaves the
stack unusable.  Against the reference: the float64 host route bit for
bit, the device route within the tolerances of
``tests/test_torch_executor.py`` (values rel 2e-3, groups rel 5e-3).

Setup as the reference's: 12 blocks x 500 rows, 4 regions, two mode
groups, ``chunk_blocks=4``, tables and seeds from numpy.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import repro.core as RC
import repro_torch.core as TC
from repro.launch import serve as RS
from repro_torch.core import distributed as TD
from repro_torch.core.moment_store import DeviceStack as TStack
from repro_torch.core.moment_store import MeshDeviceStack as TMesh
from repro_torch.core.multiquery import _STAGES
from repro_torch.kernels.isla_moments import RunTableError
from repro_torch.launch import serve as TS
from repro_torch.launch.mesh import make_cell_mesh
from repro_torch import trace

N_BLOCKS, ROWS, REGIONS = 12, 500, 4
F64, F32 = torch.float64, torch.float32
ROUTES = [("host", 0), ("device", 0)] + [("mesh", s) for s in (1, 2, 3, 4)]


def _tables(seed=0):
    t_rng = np.random.default_rng(seed)
    tables = []
    for _ in range(N_BLOCKS):
        g = t_rng.integers(0, REGIONS, size=ROWS)
        tables.append({
            "value": t_rng.normal(100.0 + 3.0 * g, 12.0, ROWS),
            "region": g.astype(np.float64),
            "flag": t_rng.integers(0, 2, size=ROWS).astype(np.float64),
        })
    return tables


def _executor(C=TC, shards=0):
    kw = {}
    if C is TC:
        kw = dict(device="cpu",
                  mesh=["cpu"] * shards if shards else None)
    return C.MultiQueryExecutor(
        [C.table_sampler(t) for t in _tables()], [10 ** 5] * N_BLOCKS,
        params=C.IslaParams(), group_domains={"region": REGIONS}, **kw)


def _queries(C=TC, modes=("calibrated", "faithful_cf"), distinct=False):
    """Two mode-groups (two resolved modes), so the pipelined loop has a
    staged group in flight while the next one launches; ``distinct`` adds
    COUNT DISTINCT asks (the register plane) to each."""
    flag1 = C.Predicate(column="flag", eq=1.0)
    out = []
    for m in modes:
        out += [
            C.IslaQuery(e=0.05, beta=0.95, agg="AVG", mode=m),
            C.IslaQuery(e=0.05, beta=0.95, agg="AVG", where=flag1, mode=m),
            C.IslaQuery(e=0.05, beta=0.95, agg="AVG", group_by="region",
                        mode=m),
        ]
        if distinct:
            out += [C.IslaQuery(e=0.05, agg="count_distinct", mode=m),
                    C.IslaQuery(e=0.05, agg="count_distinct",
                                group_by="region", where=flag1, mode=m)]
    return out


def _ticks(ex, route, pipeline, C=TC, ticks=3, distinct=False, seed=7):
    """``ticks`` incremental deficit-topping runs of one executor."""
    rng = np.random.default_rng(seed)
    return [ex.run(_queries(C, distinct=distinct), rng, route=route,
                   incremental=True, deadline_samples=30 * (i + 1),
                   chunk_blocks=4, pipeline=pipeline)
            for i in range(ticks)]


def _answer_key(a):
    """Every answer field, as exact text (repr round-trips a float, NaN
    included)."""
    groups = None if a.groups is None else [
        (g.group, g.value, g.mean, g.error_bound, g.n_samples, g.est_size)
        for g in a.groups]
    return repr((a.value, a.mean, a.error_bound, a.sampling_rate,
                 a.sample_size, a.mode, a.pass_id, a.n_matched,
                 a.est_population, a.new_samples, a.half_width, groups))


def _state(ex, route):
    """Every key's state after the ticks, as host arrays."""
    stores = (ex._stores if route == "host"
              else {k: d.to_host() for k, d in ex._device_stores.items()})
    out = {}
    for skey, st in stores.items():
        for f in ("mom_s", "mom_l", "totals", "n_sampled", "regs"):
            v = getattr(st, f, None)
            if v is not None:
                out[(skey, f)] = np.asarray(v)
    return out


@pytest.fixture
def default_dtype(request):
    was = torch.get_default_dtype()
    torch.set_default_dtype(request.param)
    yield request.param
    torch.set_default_dtype(was)


@pytest.fixture
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["moments", "distinct"])
@pytest.mark.parametrize("default_dtype", [F64, F32], ids=["f64", "f32"],
                         indirect=True)
@pytest.mark.parametrize("route,shards", ROUTES,
                         ids=[f"{r}{s or ''}" for r, s in ROUTES])
def test_pipeline_matches_serial(route, shards, default_dtype, distinct):
    """Pipelined ticks against serial ticks over identical RNG streams:
    every answer field, the draw ledgers and every key's state (moment
    rows, totals, ledger, register plane) bit for bit, on the host route,
    the device route and the mesh at S = 1-4 CPU shards, fp32 and
    float64, moments and COUNT DISTINCT."""
    serial_ex, pipe_ex = _executor(shards=shards), _executor(shards=shards)
    serial = _ticks(serial_ex, route, False, distinct=distinct)
    piped = _ticks(pipe_ex, route, True, distinct=distinct)
    assert all(a.new_samples > 0 for a in serial[-1])
    for s_run, p_run in zip(serial, piped):
        assert [_answer_key(a) for a in p_run] == \
            [_answer_key(a) for a in s_run]
    want, got = _state(serial_ex, route), _state(pipe_ex, route)
    assert want and set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    if route != "host":
        for skey, dst in pipe_ex._device_stores.items():
            assert dst.dtype == default_dtype
            assert np.array_equal(
                dst.partials_host(),
                serial_ex._device_stores[skey].partials_host()), skey
    if route == "mesh":
        assert all(isinstance(st, TMesh) and st.n_shards == shards
                   for st in pipe_ex._device_stacks.values())


def test_pipeline_stage_telemetry():
    """Every pipelined run books all six stage clocks, and a drawing tick
    spends measurable time in draw and launch."""
    ex = _executor()
    ex.run(_queries(), np.random.default_rng(3), route="device",
           incremental=True, deadline_samples=30, chunk_blocks=4,
           pipeline=True)
    times = ex.last_stage_times
    assert set(times) == set(_STAGES)
    assert all(v >= 0.0 for v in times.values())
    assert times["draw"] > 0.0 and times["launch"] > 0.0


def _count_h2d(monkeypatch, calls):
    real = TD.h2d

    def counted(x, dtype=None, device="cuda"):
        calls.append(np.asarray(x).nbytes)
        return real(x, dtype, device)

    monkeypatch.setattr(TD, "h2d", counted)


@pytest.mark.parametrize("route", ["device", "mesh"])
def test_pipeline_uploads_match_serial(route, monkeypatch):
    """The counterpart of the reference's ``transfer_guard`` test: every
    upload goes through ``distributed.h2d``, and steady pipelined ticks
    make the serial ticks' uploads, call for call and byte for byte — a
    drawing deficit top-up its sample panes, a converged zero-draw repeat
    none."""
    per_mode = []
    for pipeline in (False, True):
        ex = _executor(shards=2 if route == "mesh" else 0)
        rng = np.random.default_rng(5)
        qs = _queries()
        for _ in range(2):
            ex.run(qs, rng, route=route, incremental=True,
                   deadline_samples=30, chunk_blocks=4, pipeline=pipeline)
        warm_calls, drawn_calls = [], []
        _count_h2d(monkeypatch, warm_calls)
        warm = ex.run(qs, rng, route=route, incremental=True,
                      deadline_samples=30, chunk_blocks=4,
                      pipeline=pipeline)
        monkeypatch.undo()
        assert all(a.new_samples == 0 for a in warm) and warm_calls == []
        _count_h2d(monkeypatch, drawn_calls)
        drawn = ex.run(qs, rng, route=route, incremental=True,
                       deadline_samples=60, chunk_blocks=4,
                       pipeline=pipeline)
        monkeypatch.undo()
        assert all(a.new_samples > 0 for a in drawn) and drawn_calls
        per_mode.append(drawn_calls)
    assert per_mode[1] == per_mode[0]


def _staged_launch(ex, rng, defer):
    """White-box: plan a warm batch and stage ONE mode-group's launch
    (the first half of the pipelined loop), without composing."""
    qs = _queries(modes=("calibrated",))
    plan = ex._plan_cached(qs, rng, "calibrated", "device", None, None)
    mg = plan.mode_groups[0]
    prebuilt = ex._group_stores(plan, mg, ex._stores)
    times = dict.fromkeys(_STAGES, 0.0)
    sg = ex._launch_group(plan, mg, 0, rng, "device", 60,
                          prebuilt=prebuilt, persistent=True,
                          chunk_blocks=4, defer_stats=defer,
                          timings=times)
    for f in sg.pending:  # reset lands after the launch, before compose
        f.result()
    sg.pending = []
    return sg


@pytest.mark.parametrize("default_dtype", [F64], ids=["f64"],
                         indirect=True)
def test_drift_reset_mid_pipeline_serves_fresh_stats(default_dtype):
    """A per-key drift reset landing between a staged group's launch and
    its compose must NOT serve the pre-reset stats: the compose sees the
    stale store (``_group_stale``) and launches again against the live
    stores.  The serial executor makes the same launch / reset / launch
    sequence, so the answers match bit for bit (float64)."""
    skey = TC.StoreKey(where=TC.Predicate(column="flag", eq=1.0),
                       group_by=None, mode="calibrated")
    outs = []
    for defer in (True, False):
        ex = _executor()
        rng = np.random.default_rng(11)
        ex.run(_queries(modes=("calibrated",)), rng, route="device",
               incremental=True, deadline_samples=30, chunk_blocks=4)
        sg = _staged_launch(ex, rng, defer)
        staged_store = sg.dstores[(skey.where, None)]
        ex._reset_key(skey)
        assert ex._group_stale(sg)
        out = ex._compose_group(sg)
        live = ex._device_stores.get(skey)
        assert live is not None and live is not staged_store
        assert live.total_sampled > 0
        outs.append(out)
    for (i_p, a_p), (i_s, a_s) in zip(*outs):
        assert i_p == i_s
        assert _answer_key(a_p) == _answer_key(a_s)
        assert a_p.new_samples > 0


def test_compose_without_reset_uses_staged_stores():
    """Control for the staleness path: with no reset, compose serves the
    staged launch directly — no relaunch, no extra RNG draws."""
    ex = _executor()
    rng = np.random.default_rng(13)
    ex.run(_queries(modes=("calibrated",)), rng, route="device",
           incremental=True, deadline_samples=30, chunk_blocks=4)
    state = rng.bit_generator.state
    sg = _staged_launch(ex, rng, defer=True)
    state_after_launch = rng.bit_generator.state
    assert not ex._group_stale(sg)
    ex._compose_group(sg)
    assert rng.bit_generator.state == state_after_launch
    assert state != state_after_launch  # the launch itself did draw


def test_pipelined_tick_records_the_isla_stage_spans(monkeypatch):
    """``trace.stage_trace`` keeps the reference's ``isla:*`` names as
    spans, the launches on the worker thread, and opens no profiler range
    while no profiler runs."""
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    with trace.recording() as spans:
        _ticks(_executor(), "device", True, ticks=1)
    names = {s.name for s in spans}
    assert {"isla:draw", "isla:h2d", "isla:launch",
            "isla:readback"} <= names
    assert all(n.startswith("isla:") for n in names)
    assert {s.thread for s in spans if s.name == "isla:launch"} == \
        {TD.launch_pool().submit(
            lambda: threading.current_thread().name).result()}


@pytest.mark.parametrize("route", ["device", "mesh"])
def test_serve_loop_pipeline_stage_seconds(route):
    """The admission loop's ``pipeline`` mode accrues the six stage clocks
    into ``stats["stage_seconds"]``, still answers, and prefetches the
    queued batch's plan between ticks."""
    ex = _executor(shards=2 if route == "mesh" else 0)
    loop = TS.IslaAdmissionLoop(ex, np.random.default_rng(9), route=route,
                                incremental=True, pipeline=True)
    for q in _queries():
        loop.submit(q)
    done = loop.run_until_drained()
    assert len(done) == len(_queries())
    stages = loop.stats["stage_seconds"]
    assert set(stages) == set(_STAGES)
    assert sum(stages.values()) > 0.0
    for q in _queries():
        loop.submit(q)
    loop._prefetch_pending()
    assert loop.stats["plans_prefetched"] == 1


def test_pipeline_with_short_switch_interval():
    """The worker and the main thread interleaving at every few bytecodes
    (a shortened switch interval) still give the serial bits: a lost
    update of shared state would break them."""
    serial = _ticks(_executor(), "device", False, distinct=True)
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        piped = _ticks(_executor(), "device", True, distinct=True)
    finally:
        sys.setswitchinterval(was)
    for s_run, p_run in zip(serial, piped):
        assert [_answer_key(a) for a in p_run] == \
            [_answer_key(a) for a in s_run]


# ---------------------------------------------------------------------------
# Against the reference's pipelined tick.
# ---------------------------------------------------------------------------


def test_pipeline_host_route_matches_reference_x64(x64):
    """The float64 host route, pipelined, is the reference's pipelined
    host route bit for bit: every answer field, every tick."""
    ref = _ticks(_executor(RC), "host", True, C=RC)
    got = _ticks(_executor(), "host", True)
    for r_run, t_run in zip(ref, got):
        assert [_answer_key(a) for a in t_run] == \
            [_answer_key(a) for a in r_run]


@pytest.mark.parametrize("default_dtype", [F32], ids=["f32"], indirect=True)
def test_pipeline_device_route_matches_reference(default_dtype):
    """The fp32 device route, pipelined, against the reference's pipelined
    fp32 device route: identical draw ledgers, values within rel 2e-3 and
    group values within rel 5e-3."""
    ref = _ticks(_executor(RC), "device", True, C=RC)
    got = _ticks(_executor(), "device", True)
    for r_run, t_run in zip(ref, got):
        for r, t in zip(r_run, t_run):
            assert t.new_samples == r.new_samples > 0
            assert t.sample_size == r.sample_size
            assert t.value == pytest.approx(r.value, rel=2e-3)
            assert (t.groups is None) == (r.groups is None)
            for gt, gr in zip(t.groups or [], r.groups or []):
                assert gt.n_samples == gr.n_samples
                assert gt.value == pytest.approx(gr.value, rel=5e-3)


def test_serve_loop_pipeline_matches_reference_loop():
    """The admission loop with ``pipeline=True`` on the host route gives
    the reference loop's answers and counters, tick for tick."""
    out = []
    for C, S in ((RC, RS), (TC, TS)):
        kw = {} if S is RS else dict(route="host")
        loop = S.IslaAdmissionLoop(_executor(C), np.random.default_rng(9),
                                   incremental=True, pipeline=True, **kw)
        for q in _queries(C):
            loop.submit(q)
        done = loop.run_until_drained()
        out.append(([_answer_key(t.answer) for t in done],
                    loop.stats["samples_drawn"],
                    loop.stats["plans_prefetched"]))
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# The run-table fault under deferred stats.
# ---------------------------------------------------------------------------


def _card_like_fold(monkeypatch):
    """The plain tagged fold made to behave as the card's does on a wrong
    table: it folds what it is given, then counts a run out of place in
    the table's count slot (the plain version would raise first)."""
    real = TD.isla_tagged_fold

    def card_like(values, seg, bounds, out_s, out_l, out_t, runs=None):
        real(values, seg, bounds, out_s, out_l, out_t)
        if runs is not None:
            runs.table[-1] = 1

    monkeypatch.setattr(TD, "isla_tagged_fold", card_like)


def _tagged_payload(stack, stores, rng):
    """One block-major tagged draw over every key of ``stores``, its run
    table with it (the executor's float64 payload)."""
    quotas = rng.integers(3, 9, size=N_BLOCKS).astype(np.int64)
    bids = np.repeat(np.arange(N_BLOCKS), quotas)
    vals = rng.normal(100.0, 12.0, bids.size)
    segs, lens = [], []
    for k, st in enumerate(stores):
        segs.append(stack.key_seg(k, st, bids))
        lens.append(stack.key_runs(quotas))
    return dict(values=np.concatenate([(vals + st.shift) / st.scale
                                       for st in stores]),
                seg=np.concatenate(segs), quotas=quotas,
                runs=np.stack(lens))


def _fault_stack(kind):
    b = TC.make_boundaries(100.0, 12.0, TC.IslaParams())
    stores = [TC.DeviceMomentStore.fresh_device(
        N_BLOCKS, b, 100.0, [10 ** 5] * N_BLOCKS, dtype=F64, device="cpu")
        for _ in range(2)]
    stack = (TStack(stores) if kind == "device"
             else TMesh(stores, make_cell_mesh(devices=["cpu"] * 2)))
    return stack, stores


@pytest.mark.parametrize("kind", ["device", "mesh2"])
def test_run_table_fault_under_deferred_stats(kind, monkeypatch):
    """A bad run count rides the deferred stat copy: the deferred tick
    returns lazy rows, and the first read of any of the stack's deferred
    stats raises — after every store's stats were cleared and the stack
    released — and so does every later read; every next tick raises,
    zero-draw ticks included.  A serial tick after deferred ones lands
    and checks their counts first."""
    rng = np.random.default_rng(31)
    params = TC.IslaParams()
    for read in ("rows", "serial_tick", "release"):
        stack, stores = _fault_stack(kind)
        stack.tick(params, defer_stats=True,
                   **_tagged_payload(stack, stores, rng))
        good = [st._rows_src for st in stores]
        with monkeypatch.context() as m:
            _card_like_fold(m)
            out = stack.tick(params, defer_stats=True,
                             **_tagged_payload(stack, stores, rng))
        assert all(st._stats_valid for st in stores)  # nothing landed yet
        with pytest.raises(RunTableError, match="run table"):
            if read == "rows":
                stores[1]._rows
            elif read == "serial_tick":
                stack.tick(params, **_tagged_payload(stack, stores, rng))
            else:
                stack.release()
        assert all(not st._stats_valid and st._rows is None
                   for st in stores)
        assert stack._released
        # The earlier tick's rows landed, counts checked, before the
        # fault; the faulted tick's never serve.
        assert np.asarray(good[0]).shape == (1, 9)
        for _, rows in out:
            with pytest.raises(ValueError, match="unusable"):
                np.asarray(rows)
        for again in (dict(), dict(mode="faithful"),
                      _tagged_payload(stack, stores, rng)):
            with pytest.raises(ValueError, match="unusable"):
                stack.tick(params, defer_stats=True, **again)


@pytest.mark.parametrize("default_dtype", [F64], ids=["f64"],
                         indirect=True)
@pytest.mark.parametrize("route", ["device", "mesh"])
def test_run_table_fault_reaches_the_pipelined_run(route, default_dtype,
                                                   monkeypatch):
    """Through the executor: a card-like bad count raises out of
    ``run(pipeline=True)`` at compose, with every store of the faulted
    stack invalid and the stack released; the pool then runs the next
    run, which rebuilds the stack and answers."""
    ex = _executor(shards=2 if route == "mesh" else 0)
    qs = _queries(modes=("calibrated",))
    rng = np.random.default_rng(17)
    ex.run(qs, rng, route=route, incremental=True, deadline_samples=30,
           chunk_blocks=4, pipeline=True)
    (stack,) = ex._device_stacks.values()
    with monkeypatch.context() as m:
        _card_like_fold(m)
        with pytest.raises(RunTableError, match="run table"):
            ex.run(qs, rng, route=route, incremental=True,
                   deadline_samples=60, chunk_blocks=4, pipeline=True)
    assert stack._released
    assert not any(st._stats_valid for st in stack.stores)
    answers = ex.run(qs, rng, route=route, incremental=True,
                     deadline_samples=90, chunk_blocks=4, pipeline=True)
    assert all(np.isfinite(a.value) and a.new_samples > 0 for a in answers)


@pytest.mark.parametrize("default_dtype", [F64], ids=["f64"],
                         indirect=True)
def test_first_worker_error_is_raised(default_dtype, monkeypatch):
    """A wrong run table on the second chunk: the plain fold raises on
    the worker, and the chunks after it meet a released stack.  The run
    raises the first chunk's error, not theirs; no tick is left on the
    worker, and the pool runs the next run."""
    ex = _executor()
    qs = _queries(modes=("calibrated",))
    rng = np.random.default_rng(19)
    ex.run(qs, rng, route="device", incremental=True, deadline_samples=30,
           chunk_blocks=4, pipeline=True)
    real = TStack.key_runs
    seen = []

    def spoiled(self, quotas, mask=None):
        out = real(self, quotas, mask)
        seen.append(1)
        if len(seen) == 2:  # the second chunk's first key
            nz = np.flatnonzero(out)
            out[nz[0]] += 1
            out[nz[1]] -= 1
        return out

    monkeypatch.setattr(TStack, "key_runs", spoiled)
    with pytest.raises(RunTableError, match="run table"):
        ex.run(qs, rng, route="device", incremental=True,
               deadline_samples=120, chunk_blocks=4, pipeline=True)
    monkeypatch.undo()
    assert TD.launch_pool().submit(lambda: 7).result(timeout=30) == 7
    answers = ex.run(qs, rng, route="device", incremental=True,
                     deadline_samples=150, chunk_blocks=4, pipeline=True)
    assert all(np.isfinite(a.value) for a in answers)


def test_d2h_async_on_the_cpu_holds_the_tensor():
    """On a CPU tensor the handle holds the tensor itself (nothing to
    overlap); any other device is refused, not copied some other way."""
    x = torch.arange(6.0)
    assert TD.d2h_async(x).wait() is x
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TD.d2h_async(torch.empty(2, device="meta"))


@pytest.mark.parametrize("route", ["device", "mesh"])
def test_serve_cli_pipeline(route, monkeypatch, capsys):
    """``serve --workload isla --smoke --incremental --pipeline --device
    cpu`` on the device and mesh routes: answers, and the per-tick log
    carries the stage clocks."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--workload", "isla", "--smoke", "--incremental",
        "--pipeline", "--device", "cpu", "--route", route])
    TS.main()
    out = capsys.readouterr().out
    assert "served 6 queries over 2 ticks" in out
    assert out.count("stages[ms] plan=") == 2


def test_serve_cli_pipeline_needs_a_card_without_device_cpu(monkeypatch):
    """``serve --pipeline`` without ``--device cpu`` runs on ``cuda``: with
    no card it raises, never dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--workload", "isla", "--smoke", "--incremental",
        "--pipeline"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.main()
