"""CPU tests of ``chip_smoke.py``'s reading of profiled ticks: a trace that
lost kernels the launch counts name is taken again, never read as proof
that a kernel did not run."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as S  # noqa: E402


def events(**kw):
    out = {k: 0 for k in S.ISLA_KERNELS}
    out["sort"] = 0
    out.update(kw)
    return out


def tick(ev, tagged=1, tagged_sketch=1, pilot=0, fold=0, sketch=0):
    return dict(kernel_events=ev, tagged_launches=tagged,
                tagged_sketch_launches=tagged_sketch, pilot_launches=pilot,
                fold_launches=fold, sketch_launches=sketch)


WHOLE = events(isla_tagged_runs_kernel=1, isla_sketch_kernel=1)
LOST = events()  # the refused run's tick 2: device events, no ISLA kernel


@pytest.mark.parametrize("rec, whole", [
    (tick(WHOLE), True),
    (tick(LOST), False),
    (tick(None), False),
    (tick(events(isla_tagged_runs_kernel=1)), False),
    (tick(events(isla_tagged_fold_kernel=1, isla_sketch_kernel=1)), True),
    (tick(events(pilot_moments_kernel=1, isla_tagged_runs_kernel=1,
                 isla_sketch_kernel=1), pilot=1), True),
    (tick(events(isla_tagged_runs_kernel=1, isla_sketch_kernel=1),
          pilot=1), False),
    (tick(events(isla_fold_kernel=4, isla_sketch_kernel=1), tagged=0,
          tagged_sketch=0, fold=4, sketch=1), True),
    (tick(events(isla_fold_kernel=3, isla_sketch_kernel=1), tagged=0,
          tagged_sketch=0, fold=4, sketch=1), False),
    (tick(None, tagged=0, tagged_sketch=0), True),
], ids=["whole", "lost", "no-trace", "lost-merge", "sorted-path-whole",
        "pilot-whole", "pilot-lost", "fp32-whole", "fp32-lost-fold",
        "nothing-launched"])
def test_trace_whole(rec, whole):
    assert S.trace_whole(rec) is whole


def fake_serve(monkeypatch, traces):
    """``run_serve`` giving tick 2 the next of ``traces`` a call."""
    calls = []

    def run_serve(*args, **kw):
        calls.append(kw["profile_at"])
        return None, None, [tick(WHOLE), tick(traces[len(calls) - 1])]

    monkeypatch.setattr(S, "run_serve", run_serve)
    return calls


@pytest.mark.parametrize("traces, runs", [
    ([WHOLE], 1),
    ([LOST, WHOLE], 2),
    ([None, LOST, WHOLE], 3),
])
def test_profiled_serve_takes_a_lost_trace_again(monkeypatch, traces, runs):
    calls = fake_serve(monkeypatch, traces)
    recs, n = S.profiled_serve("f64", 10, 2, 100, (0.5, 0.25), True,
                               (0, 1), forbidden=("sort",))
    assert n == runs == len(calls)
    assert recs[1]["kernel_events"] == WHOLE


def test_profiled_serve_fails_when_every_trace_is_lost(monkeypatch):
    calls = fake_serve(monkeypatch, [LOST] * S.PROFILE_TRIES)
    with pytest.raises(S.SmokeFailure, match="lost kernels"):
        S.profiled_serve("f64", 10, 2, 100, (0.5, 0.25), True, (0, 1))
    assert len(calls) == S.PROFILE_TRIES


@pytest.mark.parametrize("bad", [
    events(sort=2),
    events(isla_tagged_fold_kernel=1, isla_sketch_kernel=1, sort=15),
])
def test_profiled_serve_fails_at_once_on_a_forbidden_kernel(monkeypatch,
                                                            bad):
    # A forbidden kernel is proof even in a trace that lost others.
    calls = fake_serve(monkeypatch, [bad, WHOLE])
    with pytest.raises(S.SmokeFailure, match="profiled tick 2"):
        S.profiled_serve("f64", 10, 2, 100, (0.5, 0.25), True, (0, 1),
                         forbidden=("isla_tagged_fold_kernel", "sort"))
    assert len(calls) == 1


# The mesh phase's checks.

N_ROWS = 34  # the loop's stack: 1 + 1 + 16 + 16 rows


def mesh_tick(distinct, f64, drawing, first, collectives=None, **over):
    r = S.mesh_tick_launches(distinct, f64, S.MESH_SHARDS, drawing, first)
    reduce = [("sum", 9 * N_ROWS)] + ([("max", S.N_REGS * N_ROWS)]
                                      if distinct else [])
    r.update(new_samples=1000 if drawing else 0,
             collectives=reduce if collectives is None else collectives)
    r.update(over)
    return r


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("f64", [False, True])
def test_check_mesh_ticks_takes_a_launch_a_shard(distinct, f64):
    recs = [mesh_tick(distinct, f64, True, True),
            mesh_tick(distinct, f64, True, False),
            mesh_tick(distinct, f64, False, False, collectives=[])]
    S.check_mesh_ticks("mesh", recs, S.MESH_SHARDS, distinct, f64, N_ROWS)
    want = S.MESH_SHARDS if f64 else 0
    assert recs[0]["tagged_launches"] == want
    assert recs[0]["fold_launches"] == S.MESH_SHARDS - want
    assert recs[0]["pilot_launches"] == 1 and recs[1]["pilot_launches"] == 0


@pytest.mark.parametrize("bad", [
    dict(fold_launches=1),                      # one launch, not one a shard
    dict(fold_calls=4, fold_launches=5),        # a launch outside the calls
    dict(pilot_launches=2),                     # a second pilot
    dict(collectives=[("sum", 9 * N_ROWS)] * 2),   # two reduces a tick
    dict(collectives=[("sum", 4 * 34_000)]),    # O(cells) crosses
    dict(collectives=[("max", 9 * N_ROWS)]),    # not the stat rows' sum
    dict(collectives=[]),                       # a drawing tick unreduced
], ids=["one-launch", "extra-launch", "two-pilots", "two-reduces",
        "cells-cross", "max-only", "no-reduce"])
def test_check_mesh_ticks_fails(bad):
    recs = [mesh_tick(False, False, True, True, **bad)]
    with pytest.raises(S.SmokeFailure, match="tick 1"):
        S.check_mesh_ticks("mesh", recs, S.MESH_SHARDS, False, False, N_ROWS)


@pytest.fixture
def float64_default():
    import torch

    was = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(was)


def test_check_mesh_state_on_the_cpu(float64_default):
    """The float64 loop on a four-shard CPU mesh and on the device route,
    at a small size: ``check_mesh_state`` holds them bit for bit, and
    each drawing tick records one sum and one max of O(groups) rows; a
    changed cell fails it."""
    args = (12, 3, 400, (0.5, 0.25, 0.25), True)
    _, mesh_ex, recs = S.run_serve("cpu", "mesh", *args,
                                   mesh=["cpu"] * S.MESH_SHARDS)
    _, dev_ex, _ = S.run_serve("cpu", "device", *args)
    st = S.check_mesh_state(mesh_ex, dev_ex)
    assert st["keys"] == 4 and st["cells"] == (1 + 1 + 3 + 3) * 12
    rows = 1 + 1 + 3 + 3  # the four keys' stat rows
    assert [r["collectives"] for r in recs[:2]] == [
        [("sum", 9 * rows), ("max", S.N_REGS * rows)]] * 2
    dst = next(iter(dev_ex._device_stores.values()))
    dst.mom_s = dst.mom_s + 1.0
    with pytest.raises(S.SmokeFailure, match="mom_s"):
        S.check_mesh_state(mesh_ex, dev_ex)
