#!/usr/bin/env python
"""Open many short ``torch.profiler`` windows in one process on the card
and count the device events each one keeps: the probe behind the
profiled windows of ``chip_smoke.py`` that came back empty.

    python3 tools/profiler_windows.py [--windows N]

Every window is ``chip_smoke.window_events``' own (a host pause, then
under the profiler a short device spin, ``reps`` calls, a synchronise)
around the pilot kernel at 1,000 samples, each call after a 64 MB read
that flushes L2 (the pilot's cold timing, one of the windows that lost
every event).  The variants, one after another, ``--windows`` windows
each:

- ``smoke``: CUDA activity only, as ``window_events``;
- ``cpu+cuda``: CPU activity too, so each kernel's launch (its
  ``cudaLaunchKernel`` and the correlation id they share) is in the
  trace: the gap from launch to kernel start on the trace's clock (a
  few microseconds on an idle card; negative or drifting values would
  say the device clock parts from the host's), and kernels whose launch
  lies in another window (records delivered late);
- ``no sync``: the window stops before the card is synchronised;
- ``busy``: 0.3 s of bf16 matrix products between windows, as between
  the smoke's phases;
- ``all threads``: after one window with ``profile_all_threads`` (the
  pipelined phase's experimental config), the ``smoke`` windows again;
- ``padded``: ``smoke`` with a 20 ms device spin before the calls and a
  20 ms host pause after the synchronise, both inside the window;
- ``fold``: ``chip_smoke.window_events`` itself (padded) over
  ``ops.isla_moments`` on a 5,243-sample telemetry pane, every device
  event kept: the events of each name a window holds (``names``, over
  all windows), and how many windows held each count of fold kernels;
  with ``--after-pipe`` again after ``chip_smoke.profiled_pipe`` (a
  pipelined tick profiled with every thread traced, whose launch worker
  thread lives on).

For each variant it prints one JSON line: windows, how many kept every
event, none, or some; the events a window held at the least; with CPU
activity the launch-to-kernel gaps (min, median, max, in microseconds,
over the first and the last tenth of the windows) and the late kernels.
The first line names the card, its power limit and the torch and CUDA
versions.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as S  # noqa: E402

REPS = 20
PAD_S = 0.02


def window(fn, setup, cpu=False, synced=True, pad=False, all_threads=False):
    """One window: (the pilot kernel's device events, the trace's events
    when ``cpu``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    torch.cuda.synchronize()
    time.sleep(S.PROFILE_GAP_S)
    with profile(activities=acts, **kw) as prof:
        lead = PAD_S if pad else S.PROFILE_LEAD_S
        torch.cuda._sleep(int(lead * S.SLEEP_CYCLES_PER_S))
        for _ in range(REPS):
            setup()
            fn()
        if synced:
            torch.cuda.synchronize()
        if pad:
            time.sleep(PAD_S)
    torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA")
            and S.PILOT_KERNEL in e.name)
    trace = None
    if cpu:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)["traceEvents"]
    return n, trace


def launch_gaps(trace) -> "tuple[list, int, int]":
    """(launch-to-kernel gaps in us of the pilot kernels, kernels whose
    launch is not in this trace, launches with no kernel)."""
    launches, kernels = {}, []
    for e in trace:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None or e.get("ph") != "X":
            continue
        if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", ""):
            launches[corr] = e["ts"]
        elif e.get("cat") == "kernel" and S.PILOT_KERNEL in e.get("name", ""):
            kernels.append((corr, e["ts"]))
    gaps = [ts - launches[c] for c, ts in kernels if c in launches]
    late = sum(1 for c, _ in kernels if c not in launches)
    return gaps, late, len(launches) - len(gaps)


def summary(name, counts, gaps_by_window, late, orphans) -> dict:
    out = dict(variant=name, windows=len(counts),
               whole=sum(1 for n in counts if n == REPS),
               empty=sum(1 for n in counts if n == 0),
               partial=sum(1 for n in counts if 0 < n < REPS),
               fewest=min(counts), most=max(counts))
    if gaps_by_window:
        tenth = max(1, len(gaps_by_window) // 10)
        for part, rows in (("first", gaps_by_window[:tenth]),
                           ("last", gaps_by_window[-tenth:])):
            g = sorted(x for r in rows for x in r)
            if g:
                out[f"gap_us_{part}"] = [g[0], g[len(g) // 2], g[-1]]
        out["late_kernels"] = late
        out["launches_without_kernel"] = orphans
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=100)
    ap.add_argument("--after-pipe", action="store_true",
                    help="then one profiled pipelined tick "
                         "(chip_smoke.profiled_pipe: every thread traced) "
                         "and the fold windows again")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import isla_moments as K

    K.build()
    K.library(K.SOURCES[0])
    print(json.dumps(dict(card=S.card_line(), torch=torch.__version__,
                          cuda=torch.version.cuda)), flush=True)
    v = torch.as_tensor(np.random.default_rng(2).normal(0.8, 0.1, 1000),
                        dtype=torch.float32, device="cuda")
    flush = torch.zeros(S.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    a = torch.randn(8192, 8192, dtype=torch.bfloat16, device="cuda")
    fn = lambda: K.pilot_moments(v)  # noqa: E731
    setup = lambda: flush.max()      # noqa: E731
    for _ in range(3):
        setup()
        fn()

    def busy():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.3:
            (a @ a).sum().item()

    variants = (("smoke", {}, None), ("cpu+cuda", dict(cpu=True), None),
                ("no sync", dict(synced=False), None),
                ("busy", {}, busy),
                ("all threads", {}, "all"),
                ("padded", dict(pad=True), None))
    t_start = time.perf_counter()
    from repro_torch.kernels import ops
    pane = torch.as_tensor(np.random.default_rng(3).gamma(2.0, 2.0, 5243),
                           dtype=torch.float32, device="cuda")
    cuts = torch.tensor([0.0, 2.0, 6.0, 100.0], device="cuda")

    def fold_windows(name):
        names, folds = {}, {}
        for _ in range(args.windows):
            events = S.window_events(lambda: ops.isla_moments(pane, cuts),
                                     ("",))
            for n, _ in events:
                names[n[:60]] = names.get(n[:60], 0) + 1
            k = sum(1 for n, _ in events if "isla_fold" in n)
            folds[k] = folds.get(k, 0) + 1
        print(json.dumps(dict(
            variant=name, windows=args.windows, fold_kernels_a_window=folds,
            names=names,
            window_tries=[w["tries"] for w in S.WINDOW_LOG[-args.windows:]],
            seconds_since_start=time.perf_counter() - t_start)), flush=True)

    fold_windows("fold")
    if args.after_pipe:
        S.profiled_pipe()
        fold_windows("fold after the pipelined profile")
    for name, kw, between in variants:
        if between == "all":
            window(fn, setup, all_threads=True)
        counts, gaps, late, orphans = [], [], 0, 0
        for _ in range(args.windows):
            if callable(between):
                between()
            n, trace = window(fn, setup, **kw)
            counts.append(n)
            if trace is not None:
                g, lt, orph = launch_gaps(trace)
                gaps.append(g)
                late += lt
                orphans += orph
        row = summary(name, counts, gaps, late, orphans)
        row["seconds_since_start"] = time.perf_counter() - t_start
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
