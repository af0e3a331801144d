"""The program's own spans (``repro_torch.trace``) beside a traced window.

A run recorded inside ``repro_torch.trace.recording()`` carries the
program's spans in its record (``spans``: one dict a span, on
``time.perf_counter_ns``, the clock of the harness's host ranges).  The
spans inside the traced window are moved to the card's clock with the
offset the window's marker spin gives the host ranges, and each idle gap
on the card is then named ``<harness range>/<innermost program span
path>``, or as ``trace.summarize`` names it where no program span was
open (``trace.summarize`` itself names them, given the spans as ranges);
a path whose top-level span is the harness range's namesake is not
repeated after it (``tick/decode/channel``, not
``tick/tick/decode/channel``).  ``idle_by_span`` sums the idle seconds
under each innermost span path, piece by piece.

The window readers here serve the metrics that read the spans
(``metrics/*.py``): the spans of the harness's measured window are the
top-level ones (``tick``, ``train_step``) that started inside it, and
their children.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from perfbench.lib import trace

NO_SPAN = "host outside the harness's calls"   # ``summarize``'s name


def as_records(spans) -> List[Dict]:
    """``repro_torch.trace.Span`` tuples as the record's dicts."""
    return [s._asdict() for s in spans]


def paths(spans: Sequence[Dict]) -> List[str]:
    """Each span's path from its top-level span, names joined by ``/``
    (a parent opens before its children, so comes first)."""
    out: List[str] = []
    for s in spans:
        p = s["parent"]
        out.append(s["name"] if p is None else f"{out[p]}/{s['name']}")
    return out


def on_card(spans: Sequence[Dict], offset_us: float, t0: float, t1: float
            ) -> List[Tuple[str, float, float]]:
    """(path, start us, end us) on the card's clock of every finished span
    that overlaps the window ``[t0, t1]``."""
    out = []
    for path, s in zip(paths(spans), spans):
        if s["end_ns"] is None:
            continue
        a = s["start_ns"] / 1e3 + offset_us
        b = s["end_ns"] / 1e3 + offset_us
        if b > t0 and a < t1:
            out.append((path, a, b))
    return out


def _segments(card: Sequence[Tuple[str, float, float]]
              ) -> List[Tuple[float, float, str]]:
    """The spans' time cut at every span boundary: (start, end, path of
    the innermost open span, the one that started last) for each piece
    that some span covers, in order."""
    events = sorted([(a, 1, i) for i, (_, a, _) in enumerate(card)]
                    + [(b, 0, i) for i, (_, _, b) in enumerate(card)])
    active: Dict[int, Tuple[float, int]] = {}
    segs: List[Tuple[float, float, str]] = []
    prev: Optional[float] = None
    for t, opens, i in events:
        if prev is not None and t > prev and active:
            inner = max(active, key=active.get)
            segs.append((prev, t, card[inner][0]))
        if opens:
            active[i] = (card[i][1], i)
        else:
            active.pop(i, None)
        prev = t
    return segs


def idle_by_span(dev, card, t0: float, t1: float) -> Dict[str, float]:
    """Idle seconds of the window ``[t0, t1]`` by the innermost program
    span open on the host: each piece of ``_segments`` inside the window,
    less the card's busy time there (the union of ``dev``, as
    ``trace.summarize`` takes it)."""
    busy = trace._union([(a, b) for _, a, b in dev])
    out: Dict[str, float] = {}
    j = 0
    for a, b, path in _segments(card):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        if b - a > covered:
            out[path] = out.get(path, 0.0) + (b - a - covered) * 1e-6
    return out


def named(host, card) -> List[Tuple[str, float, float]]:
    """The program's spans as ranges for ``trace.summarize``, each named
    ``<harness range>/<path>`` by the harness range open at its start
    (the path alone where its top-level span is that range's namesake,
    ``NO_SPAN/<path>`` outside every range).  Opened inside the harness's
    range, a span starts after it, so ``summarize`` names a gap by the
    innermost one."""
    out = []
    for path, a, b in card:
        where = [(ra, n) for n, ra, rb in host if ra <= a <= rb]
        name = max(where)[1] if where else NO_SPAN
        top = path.split("/", 1)[0]
        out.append((path if top == name else f"{name}/{path}", a, b))
    return out


def name_idle(dev, host, card, t0: float, t1: float) -> Dict:
    """``idle_gaps``, the ten longest, as ``trace.summarize`` names them
    with the program's spans among the harness's ranges, and
    ``idle_by_span``."""
    gaps = trace.summarize(dev, list(host) + named(host, card), t0, t1)
    return {"idle_gaps": gaps["breakdown"]["idle_gaps"],
            "idle_by_span": idle_by_span(dev, card, t0, t1)}


def top_level(rec: Dict, name: str) -> List[int]:
    """Indices of the top-level spans ``name`` that started inside the
    record's measured window ``[t0, t1]`` (host seconds)."""
    lo, hi = rec["t0"] * 1e9, rec["t1"] * 1e9
    return [i for i, s in enumerate(rec["spans"])
            if s["name"] == name and s["parent"] is None
            and lo <= s["start_ns"] <= hi and s["end_ns"] is not None]


def children(rec: Dict, parents: Sequence[int], name: str) -> List[Dict]:
    """The spans ``name`` whose parent is one of ``parents``."""
    want = set(parents)
    return [s for s in rec["spans"]
            if s["name"] == name and s["parent"] in want]


def seconds(spans: Sequence[Dict]) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s in spans
               if s["end_ns"] is not None) * 1e-9


def device_ms_a_step(rec: Dict, name: str) -> Optional[float]:
    """The mean card time of the spans ``name`` under the measured
    window's training steps, a step; None where they carry none."""
    steps = top_level(rec, "train_step")
    ms = [s["device_ms"] for s in children(rec, steps, name)]
    if not steps or not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(steps)
