"""The program's spans beside the harness (``lib/spans.py``, the metrics
that read them, ``spans_run.py``): idle gaps named by the innermost span,
each reader on a synthetic record and on one without spans, the
existing readers unmoved by the new keys, and a reduced cell recorded
on the CPU."""
import copy

import pytest

from perfbench import spans_run
from perfbench.lib import registry, spans, trace
from perfbench.tests import reduced

SPEC = registry.spec()
NEW = tuple(spans_run.SPAN_METRICS)


def _span(name, a_us, b_us, parent=None, device_ms=None, **attrs):
    return {"name": name, "start_ns": int(a_us * 1e3),
            "end_ns": int(b_us * 1e3), "parent": parent,
            "thread": "MainThread", "attrs": attrs, "device_ms": device_ms}


# a tick (5-55 us) holding its decode (15-45, the channel 30-45) and its
# readback (45-55), on a window of 0-100 us with three device records
TICK = [_span("tick", 5, 55), _span("decode", 15, 45, 0),
        _span("channel", 30, 45, 1, layer=0, kind="moe"),
        _span("readback", 45, 55, 0)]
DEV = [("k1", 10.0, 20.0), ("k2", 40.0, 50.0), ("k3", 70.0, 80.0)]
HOST = [("tick", 0.0, 60.0), ("submit", 60.0, 100.0)]


def _named():
    card = spans.on_card(TICK, 0.0, 0.0, 100.0)
    return spans.name_idle(DEV, HOST, card, 0.0, 100.0)


def test_paths_follow_the_parents():
    assert spans.paths(TICK) == ["tick", "tick/decode",
                                 "tick/decode/channel", "tick/readback"]


def test_gaps_named_by_the_innermost_span():
    """Where a program span was open at a gap's middle the gap carries its
    path (the harness's ``tick`` not repeated); elsewhere the harness's
    name, as ``summarize`` gives it."""
    got = _named()
    names = {}
    for n, s in got["idle_gaps"]:
        names[n] = names.get(n, 0.0) + s
    assert names == pytest.approx({"tick": 10e-6,
                                   "tick/decode/channel": 20e-6,
                                   "submit": 40e-6})
    old = trace.summarize(DEV, HOST, 0.0, 100.0)["breakdown"]["idle_gaps"]
    assert sorted(s for _, s in old) == sorted(s for _, s in
                                               got["idle_gaps"])
    assert sorted(n for n, _ in old) == ["submit", "submit", "tick",
                                         "tick"]


def test_idle_split_where_the_innermost_span_changes():
    assert _named()["idle_by_span"] == pytest.approx({
        "tick": 5e-6, "tick/decode": 10e-6, "tick/decode/channel": 10e-6,
        "tick/readback": 5e-6})


def test_a_child_opened_with_its_parent_names_the_gap():
    """A span that opened in the same nanosecond as its parent is still
    the innermost one, in the gap names as in ``idle_by_span``."""
    same = [_span("tick", 5, 55), _span("decode", 5, 45, 0)]
    got = spans.name_idle(DEV, HOST, spans.on_card(same, 0.0, 0.0, 100.0),
                          0.0, 100.0)
    assert sorted(n for n, _ in got["idle_gaps"]) == [
        "submit", "submit", "tick/decode", "tick/decode"]
    assert got["idle_by_span"] == pytest.approx({"tick/decode": 25e-6,
                                                 "tick": 5e-6})


def test_spans_outside_the_window_are_left_out():
    card = spans.on_card(TICK, 1000.0, 0.0, 100.0)
    assert card == []
    assert spans.name_idle(DEV, HOST, card, 0.0, 100.0)["idle_by_span"] \
        == {}


def _serve_record():
    """Two ticks of the measured window (0-1 s), one more after it; the
    first admits a request; the kernels loaded before the window."""
    s = [_span("kernels.load", -3e6, -1e6, source="isla_kernels.cu",
               built=True)]

    def tick(at_us, admit):
        base = len(s)
        s.append(_span("tick", at_us, at_us + 30e3))
        if admit:
            s.append(_span("admit", at_us, at_us + 6e3, base, rid=1,
                           prompt_len=8))
        s.append(_span("decode", at_us + 6e3, at_us + 16e3, base))
        s.append(_span("readback", at_us + 16e3, at_us + 29e3, base))

    tick(0.1e6, True)
    tick(0.5e6, False)
    tick(1.5e6, True)
    t = {"window_s": 0.1, "busy_s": 0.08, "by_name": {}, "calls": {},
         "ticks": [{}, {}],
         "idle_by_span": {"tick/decode": 0.004,
                          "tick/decode/attention": 0.002,
                          "tick/readback": 0.01, "tick": 0.001},
         "breakdown": {"device_ops": [], "idle_gaps": []}}
    return {"kind": "serve", "t0": 0.0, "t1": 1.0, "spans": s, "trace": t}


def _train_record():
    s = [_span("kernels.load", -2e6, -1.5e6, source="isla_kernels.cu",
               built=False)]
    for k, at in enumerate((0.1e6, 0.7e6, 1.3e6)):
        base = len(s)
        s.append(_span("train_step", at, at + 560e3))
        s.append(_span("forward_backward", at, at + 480e3, base,
                       device_ms=470.0, microbatch=0))
        s.append(_span("adamw", at + 480e3, at + 540e3, base,
                       device_ms=50.0 + k))
        s.append(_span("telemetry", at + 540e3, at + 541e3, base,
                       device_ms=0.2, mode="isla"))
    return {"kind": "train", "t0": 0.0, "t1": 1.0, "spans": s}


@pytest.mark.parametrize("name, make, want", [
    ("admit_share.decode", _serve_record, 100 * 6 / 60),
    ("enqueue_ms.decode", _serve_record, 10.0),
    ("enqueue_idle_share.decode", _serve_record, 100 * 0.006 / 0.1),
    ("adamw_ms.train", _train_record, 50.5),
    ("telemetry_ms.train", _train_record, 0.2),
    ("kernel_load_s.setup", _serve_record, 2.0),
    ("kernel_load_s.setup", _train_record, 0.5),
])
def test_span_metric_reads_a_record(name, make, want):
    assert registry.layer_metric(name).read(make()) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("make", [_serve_record, _train_record])
def test_span_metric_is_none_without_spans(name, make):
    rec = make()
    rec.pop("spans")
    if "trace" in rec:
        rec["trace"].pop("idle_by_span")
    assert registry.layer_metric(name).read(rec) is None


def test_card_times_missing_read_none():
    rec = _train_record()
    for s in rec["spans"]:
        s["device_ms"] = None
    assert registry.layer_metric("adamw_ms.train").read(rec) is None


def _plain_records():
    """A serving and a training record as the drivers make them, with a
    traced window."""
    s = trace.summarize(DEV, HOST, 0.0, 100.0)
    tick = {"start": 0.0, "end": 0.5, "active": 2, "queued": 1,
            "tokens": 2, "ctx_rows": 10, "prefill": [16]}
    model = registry.config("grok-1-314b-stage4")["model"]
    serve = {"kind": "serve", "loop": "serve_closed", "t0": 0.0, "t1": 1.8,
             "setup_s": 3.0, "n_active_params": 6e9, "model": model,
             "ticks": [dict(tick, start=i * 0.5, end=(i + 1) * 0.5)
                       for i in range(4)],
             "requests": [{"due": 0.1, "gains": [0.5, 1.0, 1.5]}],
             "trace": dict(copy.deepcopy(s), ticks=[{}, {}])}
    train = {"kind": "train", "t0": 0.0, "t1": 2.0, "setup_s": 7.0,
             "steps": [(0.1, 0.7, 8192, True), (0.7, 1.3, 8192, True)],
             "flops_a_step": 6.1e13, "telemetry_samples": 164,
             "trace": dict(copy.deepcopy(s),
                           by_name={"isla_fold_kernel": 5e-6},
                           calls={"isla_fold_kernel": 1})}
    return serve, train


def test_existing_readers_unmoved_by_the_span_keys():
    """Every metric ``BENCHMARK.json`` has reads the same value from a
    record with the span keys as from one without."""
    for plain in _plain_records():
        spanned = copy.deepcopy(plain)
        spanned["spans"] = TICK
        spanned["kernel_builds"] = 2
        spanned["trace"]["idle_by_span"] = {"tick/decode": 1e-6}
        spanned["trace"]["annotation_records"] = 0
        spanned["trace"]["breakdown"]["idle_gaps"] = [["tick/decode", 1.0]]
        for m in SPEC["per_layer"]:
            mod = registry.layer_metric(m["name"])
            assert mod.read(spanned) == mod.read(plain), m["name"]
        for m in SPEC["end_to_end"]:
            mod = registry.e2e_metric(m["name"])
            assert mod.read(spanned) == mod.read(plain), m["name"]


def test_window_watch_restores_the_harness():
    before = (trace.host_range, trace.summarize)
    seen = {}
    with spans_run._window_seen(seen):
        assert trace.summarize is not before[1]
        assert trace.summarize(DEV, HOST, 0.0, 100.0) == \
            before[1](DEV, HOST, 0.0, 100.0)
        with trace.host_range("tick"):
            pass
    assert (trace.host_range, trace.summarize) == before
    assert seen["t1"] == 100.0 and "raw" not in seen


def test_alternating_blocks_install_the_recorder():
    """``--cost``'s watch: every other block of ticks runs with the
    recorder installed, the first without; other ranges pass through; the
    harness's ``host_range`` and the collector's callbacks are restored."""
    import gc

    from repro_torch import trace as program

    before, callbacks = trace.host_range, list(gc.callbacks)
    seen = {}
    with spans_run._alternating("tick", 2, seen):
        for _ in range(7):
            with trace.host_range("submit"):
                pass
            with trace.host_range("tick"):
                with program.span("tick"):
                    pass
        assert program._recorder is not None
    assert program._recorder is None
    assert (trace.host_range, gc.callbacks) == (before, callbacks)
    assert [(r[0], r[1]) for r in seen["rows"]] == [
        (0, False), (0, False), (1, True), (1, True), (2, False),
        (2, False), (3, True)]
    assert seen["spans_on"] == 3
    assert all(r[3] >= 0 for r in seen["rows"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cost_line_on_a_reduced_cell(cell):
    """``--cost`` on a reduced cell: both modes measured, the spans of a
    call counted, the run still correct."""
    ctx = reduced.context(cell, seconds=3.0)
    out = spans_run.cost_line(ctx, 2)
    assert out["correct"]
    for key in ("range_us", "period_us"):
        c = out[key]
        assert c["n_off"] >= 1 and c["n_on"] >= 1
        assert c["off"] > 0 and c["on"] > 0
    assert out["spans_a_call"] >= 1
    assert out["range_us"]["paired"]["n"] >= 1
    assert len(out["calls"]) == out["range_us"]["n_off"] \
        + out["range_us"]["n_on"] + 2


def test_paired_blocks_cancel_a_drift():
    """A call time that grows by 10 us a block, with 3 us added in the
    blocks with the recorder: the pairs read 3 us, the plain means not."""
    rows = [(b, b % 2 == 1, 0, 100.0 + 10 * b + 3 * (b % 2))
            for b in range(9) for _ in range(2)]
    got = spans_run._paired(rows)
    assert got["n"] == 3 and got["added"] == pytest.approx(3.0)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_reduced_cell_recorded_on_the_cpu(cell):
    """A reduced cell run inside the recorder: still correct, its spans
    split the measured window's ticks or steps, and the readers that need
    only host spans find them."""
    from perfbench import run as bench

    ctx = reduced.context(cell, seconds=2.0)
    rec = spans_run.record(ctx)
    out = bench.result_line(ctx, rec)
    assert out["correct"], out["checks"]
    cut = spans_run.split(rec)
    top, phases = spans_run.PHASES[rec["kind"]]
    assert cut["n"] >= 2 and cut["rest"] >= -1e-6
    assert sum(cut[p] for p in phases) <= cut[top] + 1e-6
    if rec["kind"] == "serve":
        assert 0 < registry.layer_metric("admit_share.decode").read(rec) \
            < 100
        assert registry.layer_metric("enqueue_ms.decode").read(rec) > 0
    else:
        assert cut["forward_backward"] > cut["telemetry"] > 0
    assert registry.layer_metric("kernel_load_s.setup").read(rec) == 0.0
