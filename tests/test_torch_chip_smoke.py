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
