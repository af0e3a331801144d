#!/usr/bin/env python
"""Time the dense serving tick's fold and register merge on the card: one
``distributed.fold_panes`` and one ``distributed.sketch_panes`` call each,
at the serving loop's panes; or, with ``--mode pilot``, the device pilot;
or, with ``--mode tagged``, the float64 tick's tagged fold; or, with
``--mode dense64``, the fold's float64 form.

    python3 tools/isla_stack_bench.py [--src PATH] [--label NAME]
                                      [--mode stack|pilot|tagged|dense64]

``--src`` is the ``src`` directory of the port to time (default: this
checkout's), so two trees of the port can be timed on one card in one
run, in turns.  Only the two calls' signatures, which every tree of the
port shares, are used.

The panes are made from a numpy seed as the loop makes them (see
``chip_smoke.py``): 1000 blocks, quota 512 at the cold tick's fill (62%
of the lanes real) and 1024 at the top-up's (93%), the loop's four keys
(plain, WHERE, GROUP BY 16 groups, both), a 34,000-row resident state
and a 34,000 x 4096 uint8 register plane.  For each call it prints one
JSON line: the card and its power limit, the tree's label, the pane, the
launches a call made, and the milliseconds a call takes

* ``kernel_ms``: the fold's (merge's) own kernels on the card, from the
  profiler's device events over 20 calls; each merge starts from the
  plane before the tick (``cold``: zeros) or after a first merge of the
  same pane (``warm``: every lane finds its register raised already);
* ``event_ms``: CUDA events around 20 calls, the card held busy while
  the host enqueues them, so launch gaps count and host time does not.

``--mode pilot`` times ``distributed.pilot_stats_device`` (the one
signature every tree of the port shares) on seeded normal(100, 20)
pilots of 1000, 10^5, 10^6 and 10^7 samples, one JSON line each:
``host_ms``, the median host wall time of a call (it ends in its
readback); ``kernel_ms``, the device time of the pilot kernels (names
containing ``pilot``) a call, from the profiler; ``device_ms``, that of
every kernel of the call (the pilot kernels and any torch op the tree
runs after them) and ``copy_ms``, of its upload and readback; and
``launches``, the kernel launches a call by the profiler and by the
tree's ``pilot_stats.launches``.

``--mode tagged`` times ``distributed._segment_carry_sum`` (the tagged
tick's fold; its positional signature is every tree's) on block-major
float64 streams made as the loop makes them: the four keys' slices one
after another, each block by block, 1000 blocks of 318 (the cold tick)
and 954 rows (the top-up), GROUP BY ids of 16 groups, a WHERE that keeps
half, per-cell cuts of two anchors, a 34,000-row resident state.  On a
tree whose fold takes a run table (``runs=``) it times both paths, the
run table and the stable sort.  One JSON line a stream and path:
``kernel_ms``, every device event of a call from the profiler (the sort
and the fold), ``events``, their count a call, ``event_ms`` by CUDA
events, and ``bound_ms`` (12 B a sample, the rows read and written once,
over 3.35 TB/s).  Then one run alone (``solo``): 954 samples of one
block, ungrouped and over 16 groups, the device time of a single run with
the card otherwise idle.

``--mode dense64`` times one ``distributed.fold_panes`` call on the
serving loop's panes (as above) with the values, cuts and resident rows
in float64 (the fold's float64 form; the masks stay fp32), then on the
same panes in fp32, one JSON line a pane: ``f64_kernel_ms`` and
``f32_kernel_ms`` from the profiler, ``f64_event_ms`` by CUDA events,
``launches_per_call`` (``isla_fold.launches_f64`` and
``isla_fold.launches``) and ``bound_ms`` (8 B a real value and 4 B of
each mask and id pane, the 34,000 x 11 rows of 8 B read and written, over
3.35 TB/s).  It needs a tree whose fold has a float64 form.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KEYS = ((1, -1, -1), (1, -1, 0), (16, 0, -1), (16, 0, 0))  # G, gid, valid
PANES = ((512, 0.62), (1024, 0.93))  # quota, share of real lanes
N_BLOCKS = 1000
REPS = 20
PILOT_SIZES = (1000, 100_000, 1_000_000, 10_000_000)


def event_ms(fn, reps=REPS, warm=3):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * reps * host_s, 0.5) * 2.0e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, name, setup=None, reps=REPS, warm=3, count=False):
    """Device ms a call in the kernels whose names contain ``name``, from
    the profiler (a short device spin opens the window, not counted);
    with ``count``, also their events a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    time.sleep(0.005)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(200_000)
        for _ in range(reps):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if str(e.device_type).endswith("CUDA") and name in e.name
          and "spin_kernel" not in e.name]
    ms = sum(us) / reps * 1e-3 if us else None
    return (ms, len(us) / reps) if count else ms


def panes(quota, fill, seed=0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    shape = (N_BLOCKS, quota)
    q = np.clip(np.round(rng.normal(fill, 0.05, N_BLOCKS) * quota), 1,
                quota).astype(np.int64)
    live = np.arange(quota)[None, :] < q[:, None]
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), dtype=dt, device=dev)
    raw = np.where(live, np.round(rng.normal(100.0, 20.0, shape)), 0.0)
    return dict(
        values=t(raw / 100.0), pad=t(live),
        gid=t(np.where(live, rng.integers(0, 16, shape), 0), torch.int32),
        valid=t(np.where(live, rng.random(shape) < 0.5, 0.0)),
        bounds=t([[0.5, 0.875, 1.125, 1.5]]),
        bits=t(raw.view(np.int64), torch.int64),
        n_real=int(live.sum()))


def tagged_stream(rows, seed=0):
    """A block-major tagged float64 stream of the loop's four keys over
    ``N_BLOCKS`` blocks of ``rows`` rows: ``(values, seg, bounds, lengths,
    offsets)`` as numpy (ids, a per-cell cut table, the (4, N_BLOCKS) run
    lengths and the key offsets)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    block = np.repeat(np.arange(N_BLOCKS), rows)
    x = rng.normal(100.0, 20.0, block.size)
    grp = rng.integers(0, 16, block.size)
    flag = rng.random(block.size) < 0.5
    offsets = np.concatenate([[0], np.cumsum([k[0] * N_BLOCKS
                                              for k in KEYS])])
    vals, segs, lengths = [], [], []
    for (g, _, valid), off in zip(KEYS, offsets):
        keep = flag if valid >= 0 else np.ones(block.size, dtype=bool)
        vals.append(x[keep])
        segs.append((off + (grp % g) * N_BLOCKS + block)[keep])
        lengths.append(np.bincount(block[keep], minlength=N_BLOCKS))
    n = int(offsets[-1])
    cuts = np.where(np.arange(n)[:, None] % 2 == 0,
                    (60.0, 80.0, 120.0, 140.0), (62.0, 81.0, 119.0, 138.0))
    bounds = np.concatenate([cuts, np.full((1, 4), np.inf)])
    return (np.concatenate(vals), np.concatenate(segs).astype(np.int32),
            bounds, np.stack(lengths), offsets)


def tagged_rows(card, label):
    """One JSON line a stream and path: the tagged fold's device time (see
    the module docstring)."""
    import inspect

    import numpy as np
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import isla_moments as K

    has_runs = "runs" in inspect.signature(D._segment_carry_sum).parameters
    dev = torch.device("cuda")
    streams = [(f"loop {rows} rows a block",) + tagged_stream(rows)
               for rows in (318, 954)]
    for groups in (1, 16):
        rng = np.random.default_rng(groups)
        seg = rng.integers(0, groups, 954).astype(np.int32)
        bounds = np.concatenate([np.tile([[60.0, 80.0, 120.0, 140.0]],
                                         (groups, 1)), np.full((1, 4),
                                                               np.inf)])
        streams.append((f"solo run, {groups} groups",
                        rng.normal(100.0, 20.0, 954), seg, bounds,
                        np.array([[954]]), np.array([0, groups])))
    for name, values, seg, bounds, lengths, offsets in streams:
        n = int(offsets[-1])
        state = torch.zeros((n, 11), dtype=torch.float64, device=dev)
        v = torch.as_tensor(values, device=dev)
        sg = torch.as_tensor(seg, device=dev)
        b = torch.as_tensor(bounds, device=dev)
        paths = [("sorted", None)]
        if has_runs:
            table = torch.as_tensor(K.tagged_run_table(lengths, offsets),
                                    device=dev)
            paths.insert(0, ("runs", K.TaggedRuns(
                table, lengths.shape[0], lengths.shape[1], deferred=True)))
        for path, runs in paths:
            kw = {} if runs is None else dict(runs=runs)

            def fold():
                D._segment_carry_sum(state[:, 0:4], state[:, 4:8],
                                     state[:, 8:11], v, sg, b, **kw)

            ms, events = kernel_ms(fold, "", count=True)
            print(json.dumps(dict(
                card=card, tree=label, mode="tagged", stream=name, path=path,
                tile=getattr(K, "TAGGED_TILE", None) if runs else None,
                samples=int(v.numel()), cells=n, kernel_ms=ms,
                events=events, event_ms=event_ms(fold),
                bound_ms=(12 * v.numel() + 32 * b.shape[0] + 2 * 88 * n)
                / 3.35e12 * 1e3)), flush=True)


def pilot_rows(card, label):
    """One JSON line a pilot size: ``pilot_stats_device``'s host and
    device time (see the module docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import distributed as D
    from repro_torch.kernels import isla_moments as K

    for n in PILOT_SIZES:
        v = np.random.default_rng(n).normal(100.0, 20.0, n)
        reps = 5 if n >= 10 ** 7 else REPS

        def call():
            return D.pilot_stats_device(v, device="cuda")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            walls.append((time.perf_counter() - t0) * 1e3)
        K.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        ev = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if str(e.device_type).endswith("CUDA")]
        copy = [us for name, us in ev if "memcpy" in name.lower()]
        kern = [(name, us) for name, us in ev
                if "memcpy" not in name.lower()
                and "memset" not in name.lower()]
        print(json.dumps(dict(
            card=card, tree=label, mode="pilot", n=n,
            host_ms=sorted(walls)[len(walls) // 2],
            kernel_ms=sum(us for name, us in kern if "pilot" in name)
            / reps * 1e-3,
            device_ms=sum(us for _, us in kern) / reps * 1e-3,
            copy_ms=sum(copy) / reps * 1e-3,
            launches=dict(profiler=len(kern) / reps,
                          pilot_kernels=sum(1 for name, _ in kern
                                            if "pilot" in name) / reps,
                          counter=K.pilot_stats.launches / reps),
            bound_ms=4 * n / 3.35e12 * 1e3)), flush=True)


def dense64_rows(card, label):
    """``--mode dense64``: one float64 and one fp32 ``fold_panes`` call a
    pane (see the module's note)."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import isla_moments as K

    kw = dict(n_groups_list=tuple(k[0] for k in KEYS),
              gid_slots=tuple(k[1] for k in KEYS),
              valid_slots=tuple(k[2] for k in KEYS))
    n_cells = sum(k[0] for k in KEYS) * N_BLOCKS
    for quota, fill in PANES:
        p = panes(quota, fill)
        row = dict(card=card, tree=label, pane=[N_BLOCKS, quota],
                   real_lanes=p["n_real"], keys=[k[0] for k in KEYS],
                   bound_ms=((8 + 4 * 3) * p["n_real"]
                             + 2 * 8 * 11 * n_cells) / 3.35e12 * 1e3)
        for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
            values, bounds = p["values"].to(dt), p["bounds"].to(dt)
            state = torch.zeros((n_cells, 11), dtype=dt, device="cuda")

            def fold():
                D.fold_panes(state[:, 0:4], state[:, 4:8], state[:, 8:11],
                             values, p["pad"], (p["gid"],), (p["valid"],),
                             bounds, **kw)

            K.reset_launch_counts()
            fold()
            torch.cuda.synchronize()
            if tag == "f64":
                row["launches_per_call"] = dict(
                    isla_fold_f64=K.isla_fold.launches_f64,
                    isla_fold=K.isla_fold.launches)
                row["f64_event_ms"] = event_ms(fold)
            row[f"{tag}_kernel_ms"] = kernel_ms(fold, "isla_fold")
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--mode", choices=("stack", "pilot", "tagged",
                                       "dense64"), default="stack")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("isla_stack_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import distributed as D
    from repro_torch.kernels import isla_moments as K

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    K.build()
    if args.mode == "pilot":
        pilot_rows(card, args.label)
        return 0
    if args.mode == "tagged":
        tagged_rows(card, args.label)
        return 0
    if args.mode == "dense64":
        dense64_rows(card, args.label)
        return 0
    kw = dict(n_groups_list=tuple(k[0] for k in KEYS),
              gid_slots=tuple(k[1] for k in KEYS),
              valid_slots=tuple(k[2] for k in KEYS))
    n_cells = sum(k[0] for k in KEYS) * N_BLOCKS
    state = torch.zeros((n_cells, 11), dtype=torch.float32, device="cuda")
    regs0 = torch.zeros((n_cells, 4096), dtype=torch.uint8, device="cuda")
    regs = regs0.clone()
    for quota, fill in PANES:
        p = panes(quota, fill)

        def fold():
            D.fold_panes(state[:, 0:4], state[:, 4:8], state[:, 8:11],
                         p["values"], p["pad"], (p["gid"],), (p["valid"],),
                         p["bounds"], **kw)

        def merge():
            D.sketch_panes(regs, p["bits"], p["pad"], (p["gid"],),
                           (p["valid"],), **kw)

        K.reset_launch_counts()
        fold()
        merge()
        torch.cuda.synchronize()
        launches = (K.isla_fold.launches, K.isla_sketch.launches)
        row = dict(card=card, tree=args.label, pane=[N_BLOCKS, quota],
                   real_lanes=p["n_real"], keys=[k[0] for k in KEYS],
                   launches_per_call=dict(isla_fold=launches[0],
                                          isla_sketch=launches[1]),
                   fold_kernel_ms=kernel_ms(fold, "isla_fold"),
                   fold_event_ms=event_ms(fold))
        regs.zero_()
        merge()
        warm = regs.clone()
        row.update(
            sketch_cold_kernel_ms=kernel_ms(
                merge, "isla_sketch", setup=lambda: regs.copy_(regs0)),
            sketch_warm_kernel_ms=kernel_ms(
                merge, "isla_sketch", setup=lambda: regs.copy_(warm)),
            sketch_warm_event_ms=event_ms(merge))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
