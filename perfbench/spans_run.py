"""Run one cell with the program's spans recorded, and print what they show.

  python3 perfbench/spans_run.py --workload <cell> --seed <n> \
      --seconds <s> [--cost <block>]

The cell runs as ``run.py --trace 1`` runs it, on the card, but inside
``repro_torch.trace.recording()`` from the driver's first line.  Its
record gains ``spans`` (the program's, one dict each) and
``kernel_builds`` (the ``kernels.load`` spans that ran ``nvcc``); its
traced window names each idle gap by the innermost program span open on
the host and sums the idle seconds by span path (``lib/spans.py``).  The
line printed is ``run.py``'s traced result with the metrics that read
the spans (``SPAN_METRICS``) added, and ``spans``: the measured window's
tick or step split by span, the share of the traced idle that fell under
a program span, and how many device records carry a program span's name
(0: no span reached the profiler).

``--cost <block>`` measures the recorder instead: the cell runs as
``run.py --trace 0`` runs it, with the recorder installed around every
other block of ``<block>`` ticks or steps, and prints the host time of a
tick or step (the harness's range around the call, and the period from
one call to the next) with the recorder and without, and the garbage
collector's pauses in each.

Until ``run.py`` installs the recorder itself, this reads the harness's
window from outside (``_window_seen``), and fails where that finds it
changed.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Dict

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

from perfbench import run as bench  # noqa: E402
from perfbench.lib import registry, spans, trace  # noqa: E402

SPAN_METRICS = {"admit_share.decode": "%", "enqueue_ms.decode": "ms",
                "enqueue_idle_share.decode": "%", "adamw_ms.train": "ms",
                "telemetry_ms.train": "ms", "kernel_load_s.setup": "s"}
PHASES = {"serve": ("tick", ("admit", "decode", "readback")),
          "train": ("train_step", ("forward_backward", "adamw",
                                   "telemetry"))}


@contextlib.contextmanager
def _window_seen(seen: Dict):
    """``lib/trace.py`` in this process, watched: the host ranges of the
    window being traced, as recorded (``seen["raw"]``), and what its
    ``summarize`` was given (device records, the ranges on the card's
    clock, the window's bounds)."""
    real_range, real_summarize = trace.host_range, trace.summarize

    @contextlib.contextmanager
    def host_range(name):
        if trace._RANGES is not None:
            seen["raw"] = trace._RANGES
        with real_range(name):
            yield

    def summarize(dev, host, t0, t1):
        seen.update(dev=dev, host=host, t0=t0, t1=t1)
        return real_summarize(dev, host, t0, t1)

    trace.host_range, trace.summarize = host_range, summarize
    try:
        yield
    finally:
        trace.host_range, trace.summarize = real_range, real_summarize


def record(ctx) -> Dict:
    """The cell's run record with the program's spans, and where it was
    traced, its idle named by them."""
    from repro_torch import trace as program

    seen: Dict = {}
    with _window_seen(seen), program.recording() as recorded:
        rec = registry.driver(ctx.cell["driver"]).run(ctx)
    rec["spans"] = spans.as_records(recorded)
    rec["kernel_builds"] = sum(1 for s in rec["spans"]
                               if s["name"] == "kernels.load"
                               and s["attrs"].get("built"))
    t = rec.get("trace")
    if t:
        if "dev" not in seen or len(seen.get("raw") or ()) != \
                len(seen["host"]):
            raise RuntimeError("the traced window was not seen as "
                               "lib/trace.py profile_window makes it")
        offset_us = seen["host"][0][1] - seen["raw"][0][1] / 1e3
        card = spans.on_card(rec["spans"], offset_us, seen["t0"],
                             seen["t1"])
        named = spans.name_idle(seen["dev"], seen["host"], card,
                                seen["t0"], seen["t1"])
        t["breakdown"]["idle_gaps"] = named["idle_gaps"]
        t["idle_by_span"] = named["idle_by_span"]
        names = {s["name"] for s in rec["spans"]}
        t["annotation_records"] = sum(1 for n, _, _ in seen["dev"]
                                      if n in names)
    return rec


def split(rec: Dict) -> Dict:
    """The measured window's mean tick or step by span: host ms of each
    phase and of the rest, and the card ms of each phase timed there."""
    top, phases = PHASES[rec["kind"]]
    roots = spans.top_level(rec, top)
    if not roots:
        return {}
    n = len(roots)
    whole = 1e3 * spans.seconds([rec["spans"][i] for i in roots]) / n
    out = {"n": n, top: whole}
    rest = whole
    for ph in phases:
        kids = spans.children(rec, roots, ph)
        out[ph] = 1e3 * spans.seconds(kids) / n
        rest -= out[ph]
        dev = [s["device_ms"] for s in kids]
        if dev and None not in dev:
            out[f"{ph}.device"] = sum(dev) / n
    out["rest"] = rest
    return out


@contextlib.contextmanager
def _alternating(top: str, block: int, seen: Dict):
    """``lib/trace.py``'s ``host_range`` watched: the host microseconds of
    each ``top`` range (a tick or a training step) and its start, with the
    program's recorder installed around every other block of ``block`` of
    them (the first block without); the garbage collector's pauses (start,
    us, whether the recorder was installed)."""
    import gc
    from repro_torch import trace as program

    real = trace.host_range
    state: Dict = {"n": 0, "stack": None, "spans": None}
    seen.update(rows=[], spans_on=0, gc=[])
    gc_at: Dict = {}

    def watch_gc(phase, info):
        if phase == "start":
            gc_at["t"] = time.perf_counter_ns()
        elif "t" in gc_at:
            a = gc_at.pop("t")
            seen["gc"].append((a, (time.perf_counter_ns() - a) / 1e3,
                               state["stack"] is not None))

    def close():
        if state["stack"] is not None:
            state["stack"].close()
            seen["spans_on"] += len(state["spans"])
            state["stack"] = None

    @contextlib.contextmanager
    def host_range(name):
        if name != top:
            with real(name):
                yield
            return
        on = (state["n"] // block) % 2 == 1
        if on and state["stack"] is None:
            state["stack"] = contextlib.ExitStack()
            state["spans"] = state["stack"].enter_context(
                program.recording())
        elif not on:
            close()
        a = time.perf_counter_ns()
        with real(name):
            yield
        seen["rows"].append((state["n"] // block, on, a,
                             (time.perf_counter_ns() - a) / 1e3))
        state["n"] += 1

    trace.host_range = host_range
    gc.callbacks.append(watch_gc)
    try:
        yield
    finally:
        close()
        gc.callbacks.remove(watch_gc)
        trace.host_range = real


def _mean_se(xs):
    """The mean and its standard error (NaN where too few)."""
    nan = float("nan")
    if not xs:
        return nan, nan
    return (statistics.fmean(xs), statistics.stdev(xs) / len(xs) ** 0.5
            if len(xs) > 1 else nan)


def _paired(rows) -> Dict:
    """The recorder's added host us a call, block by block: each block
    with the recorder against the mean of the blocks without it on
    both sides (the first block left out), so a steady drift over the
    window cancels; the mean of those differences and its standard error."""
    means: Dict[int, list] = {}
    for b, on, _, us in rows:
        if b > 0:
            means.setdefault(b, [on, []])[1].append(us)
    diffs = []
    for b, (on, xs) in means.items():
        around = [statistics.fmean(means[k][1]) for k in (b - 1, b + 1)
                  if k in means and not means[k][0]]
        if on and len(around) == 2:
            diffs.append(statistics.fmean(xs) - statistics.fmean(around))
    added, se = _mean_se(diffs)
    return {"added": added, "added_se": se, "n": len(diffs)}


def cost_line(ctx, block: int) -> Dict:
    """The recorder's cost at the cell's load: the mean host us of a tick
    or step (``range_us``: the harness's range around the call;
    ``period_us``: from its start to the next one's, in one block) with
    the recorder (``on``) and without (``off``), each with its standard
    error, their differences (``paired``: block against neighbouring
    blocks), every call (``calls``: block, recorder on, range us), the
    spans a call recorded, and the garbage
    collector's pauses from the second block's first call to the last
    call's end (``gc_us``, ``gc_runs``).  The first block (the set-up's
    calls among them) is left out."""
    top = PHASES["train" if ctx.cell["driver"] == "train" else "serve"][0]
    seen: Dict = {}
    with _alternating(top, block, seen):
        rec = registry.driver(ctx.cell["driver"]).run(ctx)
    rows = seen["rows"]
    period = {True: [], False: []}
    for r, nxt in zip(rows, rows[1:]):
        if r[0] == nxt[0] and r[0] > 0:
            period[r[1]].append((nxt[2] - r[2]) / 1e3)
    out: Dict = {"block": block, "top": top}
    for key, xs in (("range_us", {m: [r[3] for r in rows
                                      if r[1] == m and r[0] > 0]
                                  for m in (False, True)}),
                    ("period_us", period)):
        off, on = _mean_se(xs[False]), _mean_se(xs[True])
        out[key] = {"off": off[0], "on": on[0], "off_se": off[1],
                    "on_se": on[1], "n_off": len(xs[False]),
                    "n_on": len(xs[True]), "added": on[0] - off[0],
                    "added_se": math.hypot(off[1], on[1]),
                    "added_share": (on[0] - off[0]) / off[0]}
    out["range_us"]["paired"] = _paired(rows)
    out["calls"] = [[r[0], int(r[1]), round(r[3], 1)] for r in rows]
    n_on = sum(1 for r in rows if r[1])
    out["spans_a_call"] = seen["spans_on"] / n_on if n_on else None
    kept = [r for r in rows if r[0] > 0]
    lo, hi = kept[0][2], rows[-1][2] + rows[-1][3] * 1e3
    out["gc_us"], out["gc_runs"] = {"off": 0.0, "on": 0.0}, {"off": 0,
                                                           "on": 0}
    for a, us, on in seen["gc"]:
        if lo <= a <= hi:
            out["gc_us"]["on" if on else "off"] += us
            out["gc_runs"]["on" if on else "off"] += 1
    out["correct"] = bench.result_line(ctx, rec)["correct"]
    for m in registry.cell_metrics(ctx.name)["end_to_end"]:
        v = registry.e2e_metric(m["name"]).read(rec)
        if v is not None:
            out.setdefault("end_to_end_mixed", {})[m["name"]] = v
    return out


def traced_line(ctx, info: Dict) -> Dict:
    rec = record(ctx)
    out = bench.result_line(ctx, rec, device_info=info)
    for name, unit in SPAN_METRICS.items():
        v = registry.layer_metric(name).read(rec)
        if v is not None:
            out["metrics"][name] = {"value": v, "unit": unit}
    extra = {"split_ms": split(rec), "kernel_builds": rec["kernel_builds"]}
    t = rec.get("trace") or {}
    if "idle_by_span" in t:
        idle = t["window_s"] - t["busy_s"]
        extra["idle_by_span"] = t["idle_by_span"]
        extra["idle_under_span_share"] = (
            sum(t["idle_by_span"].values()) / idle if idle > 0 else None)
        extra["annotation_records"] = t["annotation_records"]
    for m in registry.cell_metrics(ctx.name)["end_to_end"]:
        v = registry.e2e_metric(m["name"]).read(rec)
        if v is not None:
            extra.setdefault("end_to_end_recorded", {})[m["name"]] = v
    out["spans"] = extra
    out["checks"] = out.pop("checks")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost", type=int, default=0, metavar="BLOCK",
                    help="measure the recorder in alternating blocks of "
                    "BLOCK ticks or steps")
    args = ap.parse_args(argv)
    bench._environment()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    ctx = bench.make_context(args.workload, args.seed, args.seconds,
                             not args.cost, torch.device("cuda", 0))
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": ctx.cell["chips"]}
    if args.cost:
        out = cost_line(ctx, args.cost)
        out["device"] = info
    else:
        out = traced_line(ctx, info)
    print(f"correct: {out['correct']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
