"""``repro_torch.trace``: spans off cost nothing, on they nest as the
serving tick and the training step run, threads keep their own parents,
and a span timed on the card reads the card's time.  Card tests are
marked ``cuda`` and skip here."""
import sys
import threading
import time

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_config
from repro_torch.kernels import isla_moments as K
from repro_torch.models import model as TM
from repro_torch.serve import BatchScheduler, Request
from repro_torch.train import data as TD
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS


def _scheduler():
    cfg = get_config("grok-1-314b", reduced=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    sched = BatchScheduler(cfg, params, batch_slots=2, max_seq=32,
                           eos_id=-1)
    sched.submit(Request(rid=0, prompt=[3, 4, 5], max_new=4))
    sched.tick()
    sched.submit(Request(rid=41, prompt=[5, 6, 7, 8], max_new=4))
    return cfg, sched


def _step():
    cfg = get_config("olmo-1b", reduced=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    batch = TD.SyntheticStream(cfg, batch=4, seq=32,
                               device="cpu").batch_at(0)
    return lambda: TS.train_step(cfg, TS.TrainConfig(), params,
                                 TO.init_opt_state(params), batch)


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def _check_nesting(spans):
    """Every child lies inside its parent, on its thread, and no span's
    children cover more than it (self time not negative)."""
    for i, s in enumerate(spans):
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        kids = _children(spans, i)
        for k in kids:
            assert s.start_ns <= k.start_ns <= k.end_ns <= s.end_ns
            assert k.thread == s.thread
        assert sum(k.end_ns - k.start_ns for k in kids) <= \
            s.end_ns - s.start_ns


def test_span_off_is_the_shared_null_context():
    a = trace.span("tick")
    assert a is trace.span("admit", rid=3) is trace.span("adamw",
                                                          device="cpu")
    with a as got:
        assert got is None


def test_off_records_nothing_and_opens_no_profiler_range(monkeypatch):
    """With no recorder, a tick and a step open no span, no CUDA event and
    no ``record_function`` range."""
    def refuse(*a, **k):
        raise AssertionError("touched with no recorder installed")

    _, sched = _scheduler()
    step = _step()
    monkeypatch.setattr(trace._Recorder, "open", refuse)
    monkeypatch.setattr(trace, "_Open", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert sched.tick() == 2
    step()


def test_tick_spans_nest():
    """``tick`` > ``admit`` (its rid and prompt length), ``decode``,
    ``readback``; a mixer and a channel span a layer under each prefill
    and under the decode step, the channel's kind ``moe``."""
    cfg, sched = _scheduler()
    with trace.recording() as spans:
        sched.tick()
    _check_nesting(spans)
    assert spans[0].name == "tick" and spans[0].parent is None
    top = [s.name for s in _children(spans, 0)]
    assert top == ["admit", "decode", "readback"]
    admit = spans.index(next(s for s in spans if s.name == "admit"))
    assert spans[admit].attrs == {"rid": 41, "prompt_len": 4}
    decode = spans.index(next(s for s in spans if s.name == "decode"))
    for parent in (admit, decode):
        kids = _children(spans, parent)
        assert [(k.name, k.attrs["layer"]) for k in kids] == [
            (n, layer) for layer in range(cfg.n_layers)
            for n in ("attention", "channel")]
        assert {k.attrs["kind"] for k in kids if k.name == "channel"} == \
            {"moe"}
    assert all(s.device_ms is None for s in spans)      # CPU tensors


def test_train_step_spans_nest():
    with trace.recording() as spans:
        _step()()
    _check_nesting(spans)
    assert spans[0].name == "train_step" and spans[0].parent is None
    assert [s.name for s in _children(spans, 0)] == [
        "forward_backward", "adamw", "telemetry"]
    assert spans[3].attrs == {"mode": "isla"}
    assert all(s.device_ms is None for s in spans)


def test_recording_does_not_nest_and_uninstalls():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already installed"):
            with trace.recording():
                pass
    assert trace._recorder is None
    with pytest.raises(ValueError):
        with trace.recording():
            raise ValueError
    assert trace._recorder is None


def test_threads_keep_their_own_parents():
    """More threads than cores opening nested spans at a shortened switch
    interval: every span's parent is its own thread's enclosing span, and
    no index is lost."""
    n_threads, rounds = 16, 200

    def work():
        for _ in range(rounds):
            with trace.span("outer"):
                with trace.span("inner"):
                    pass

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording() as spans:
            ts = [threading.Thread(target=work, name=f"w{i}")
                  for i in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(was)
    assert len(spans) == 2 * n_threads * rounds
    for s in spans:
        if s.name == "outer":
            assert s.parent is None
        else:
            p = spans[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_kernel_load_span_and_build_count(monkeypatch, tmp_path):
    """``library`` records ``kernels.load`` with ``built``: true where
    ``nvcc`` ran, so the spans count the builds."""
    lib_path = tmp_path / "libisla_kernels-x.so"

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(K, "_library_path", lambda source: lib_path)
    monkeypatch.setattr(K, "build", lambda srcs: lib_path.touch())
    monkeypatch.setattr(K.ctypes, "CDLL", lambda path: Lib())
    with trace.recording() as spans:
        K.library.__wrapped__("isla_kernels.cu")      # builds
        K.library.__wrapped__("isla_kernels.cu")      # loads the build
    assert [(s.name, s.attrs) for s in spans] == [
        ("kernels.load", {"source": "isla_kernels.cu", "built": True}),
        ("kernels.load", {"source": "isla_kernels.cu", "built": False})]
    assert sum(s.attrs["built"] for s in spans) == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: a span's card time runs only on a "
                    "card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_time_of_a_matmul(cuda):
    """A span's card time lies inside its host span closed by a
    synchronise (the span opens its clock before its first event and
    records its second before its clock), and holds the products: the
    body waits for them, so they are most of the host span."""
    a = torch.randn(4096, 4096, device=cuda)
    (a @ a).sum().item()
    torch.cuda.synchronize()
    with trace.recording() as spans:
        with trace.span("matmul", device=a):
            for _ in range(8):
                a = a @ a / 64.0
            torch.cuda.synchronize()
        torch.cuda.synchronize()
        synced = time.perf_counter_ns()
        with trace.span("host only"):
            pass
    mm, host = spans
    assert mm.device_ms is not None and mm.device_ms > 0
    assert mm.device_ms <= (synced - mm.start_ns) / 1e6
    assert mm.device_ms >= 0.5 * (mm.end_ns - mm.start_ns) / 1e6
    assert host.device_ms is None
