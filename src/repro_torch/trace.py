"""Spans inside the program: where a serving tick, a training step and a
kernel load spend their time, on the host's clock.

``span(name, **attrs)`` marks one piece of work.  Nothing is recorded
unless a recorder is installed (``recording()``): off, ``span`` hands
back one shared null context after one check of a module global, and
reads no clock.  On, each span is kept in memory as a ``Span`` with its
start and end on ``time.perf_counter_ns`` (the clock a profiled window
ties to the card's), the span open on the same thread when it started
(its parent), the thread's name and its attributes; the recording hands
the finished spans back when its block ends.  ``span(name, device=d)``
on a CUDA device ``d`` (a device or a tensor on it) also records a pair
of CUDA events on the current stream, resolved once after a synchronise
at the recording's end into the span's ``device_ms``.

The program's spans (names as the benchmark's layers read them):

- ``tick`` > ``admit`` (a request, ``rid``, ``prompt_len``; its prefill),
  ``decode`` (enqueueing one decode step of every slot), ``readback``
  (the tick's one ``tolist()``): ``serve/engine.BatchScheduler``;
- ``attention`` or ``mamba`` (the mixer) and ``channel`` (``kind``
  ``moe``, ``mlp`` or ``none``), each with its ``layer``, under ``admit``
  or ``decode``: ``models/transformer._forward``;
- ``train_step`` > ``forward_backward`` (a microbatch), ``adamw`` (clip
  included), ``telemetry``, each timed on the card too:
  ``train/train_step.train_step``;
- ``kernels.load`` (``source``, ``built``: whether ``nvcc`` ran):
  ``kernels/isla_moments.library``;
- ``isla:h2d``, ``isla:launch``, ``isla:readback``, ``isla:draw``: the
  ISLA tick's stages (``stage_trace``), which also open a
  ``torch.profiler`` range while a profiler runs.  Their wall clocks are
  added into the caller's ``timings`` dict (``book``) whether or not
  anything records.

No span but ``stage_trace``'s opens a ``record_function`` range: a
profiler that records the card alone would keep a user range as a
device record.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    """One finished span.  ``parent`` is the index in the recording's list
    of the span that was open on the same thread when this one started
    (None at the top); ``end_ns`` is None for a span still open when the
    recording ended; ``device_ms`` is the card's time between the span's
    two CUDA events, None without them."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    thread: str
    attrs: Dict[str, Any]
    device_ms: Optional[float]


class _Recorder:
    """The spans of one recording, in the order they opened: a row
    ``[name, start, end, parent, thread, attrs, events]`` each.  Every
    thread keeps its own stack of open spans; the list is shared, so an
    open takes a lock to claim its index."""

    def __init__(self):
        self.rows: List[list] = []
        self.lock = threading.Lock()
        self.local = threading.local()

    def open(self, name: str, attrs: Dict[str, Any], device) -> int:
        local = self.local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.name = threading.current_thread().name
        events = None
        if device is not None:
            dev = device.device if isinstance(device, torch.Tensor) \
                else torch.device(device)
            if dev.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
        row = [name, time.perf_counter_ns(), None,
               stack[-1] if stack else None, local.name, attrs, events]
        with self.lock:
            index = len(self.rows)
            self.rows.append(row)
        stack.append(index)
        if events is not None:
            events[0].record()
        return index

    def close(self, index: int) -> None:
        row = self.rows[index]
        if row[6] is not None:
            row[6][1].record()
        row[2] = time.perf_counter_ns()
        self.local.stack.pop()

    def finish(self) -> List[Span]:
        """The spans; a span timed on the card reads its events after one
        synchronise (its host span encloses both records)."""
        if any(r[6] is not None for r in self.rows):
            torch.cuda.synchronize()
        return [Span(n, a, b, p, th, at,
                     None if ev is None or b is None
                     else ev[0].elapsed_time(ev[1]))
                for n, a, b, p, th, at, ev in self.rows]


class _Open:
    __slots__ = ("rec", "name", "attrs", "device", "index")

    def __init__(self, rec: _Recorder, name: str, attrs, device):
        self.rec, self.name, self.attrs, self.device = rec, name, attrs, device

    def __enter__(self):
        self.index = self.rec.open(self.name, self.attrs, self.device)

    def __exit__(self, *exc):
        self.rec.close(self.index)
        return False


_NULL = contextlib.nullcontext()
_recorder: Optional[_Recorder] = None
_install_lock = threading.Lock()


def span(name: str, device=None, **attrs):
    """A span named ``name`` around a block, recorded while a recording is
    installed; ``device`` (a device or a tensor) times it on the card too
    where that is a CUDA device."""
    rec = _recorder
    if rec is None:
        return _NULL
    return _Open(rec, name, attrs, device)


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Record every span of the process inside the block.  Yields a list
    that holds the finished spans, in the order they opened, once the
    block has ended (after one synchronise where a span was timed on the
    card).  One recording at a time."""
    global _recorder
    rec = _Recorder()
    with _install_lock:
        if _recorder is not None:
            raise RuntimeError("a recording is already installed")
        _recorder = rec
    out: List[Span] = []
    try:
        yield out
    finally:
        with _install_lock:
            _recorder = None
        out.extend(rec.finish())


@contextlib.contextmanager
def _stage_profiled(name: str):
    with span(name), torch.profiler.record_function(name):
        yield


def stage_trace(name: str):
    """The span of one ISLA tick stage, by the reference's names
    (``isla:h2d``, ``isla:launch``, ``isla:readback``; the pipelined
    draw's ``isla:draw``), on the thread that runs it; while a
    ``torch.profiler`` runs, also its profiler range."""
    if torch.autograd.profiler._is_profiler_enabled:
        return _stage_profiled(name)
    return span(name)


_clock_lock = threading.Lock()


def book(timings, stage: str, seconds: float) -> None:
    """Add ``seconds`` to ``timings[stage]`` (no-op without a dict).  The
    pipelined tick's worker and the main thread book into one dict, so
    each add holds a lock."""
    if timings is not None:
        with _clock_lock:
            timings[stage] = timings.get(stage, 0.0) + seconds
