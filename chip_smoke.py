"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
then drives the main path — the ISLA admission loop on ``route="device"``
over 1000 blocks x 16 groups x 20000 rows — twice: once with the four
moment aggregates on the four serving keys (the moment-only tick), once
with COUNT DISTINCT on the four keys added (the sketch stack's tick).
For each run it checks that it ran through the kernels (launch counts
reset just before, read just after) and that its answers agree with the port's float64 ``route="host"`` on
the same queries and seed (COUNT DISTINCT exactly: the register planes
are bit-identical).  It keeps a copy of every value pane the loop folded
and every hash pane it merged into the HLL registers, and replays each
fold and each register merge, kernel against plain PyTorch version, on
those very panes and times both; it also holds the fold at the tick's
shape with synthetic 64- and 4096-sample panes, and times every
Pallas-signature wrapper against its plain version.  Each run's cold plan
must make exactly one pilot kernel launch.  The pilot kernel is held
against its plain version and timed at the loop's pilot size and at
10^5, 10^6 and 10^7 samples (beside the card's smallest launch at the
loop's size), with the device pilot's host time and its stages; one
device-route plan at a precision tight enough for a pilot of at least
100,000 samples reports its pilot's size and seconds.

Then the same loop twice more with the torch default dtype float64 (set
for the run, restored after it), so every key's store runs float64 and
each drawing tick folds one tagged stream of every key's samples with
``isla_tagged_fold`` by the stream's (key, block) run table (and, with
COUNT DISTINCT, merges it with ``isla_sketch_tagged``): one launch each a
tagged fold, no dense launch, one pilot launch a run; a profiled re-run
of each loop must show the run kernel once a drawing tick and no sort
kernel.  A host-route run of the same loop under the same anchor (the
host route takes the device pilot too) must hold every key's moment
rows, totals, draw ledger and register plane bit for bit, and the
partials must equal Phase 2 run on the CPU over the card's state (their
gaps to the host solve are counted in ulps; the cells the division
repair moved are counted in every run, fp32 too).  Each tick's tagged
fold is replayed on both paths, the run table and the stable sort, each
against its plain version run on the CPU over the same tensors, bit for
bit, and timed beside its bound (and the same stream folded at fp32);
each merge likewise.

Then the same four loops (moments and distinct, fp32 and float64) on
``route="mesh"``: the cell axis split by block runs over four shards,
all on ``cuda:0``, each shard launching the tick kernels on its own rows.
It checks one launch of each tick kernel a shard a drawing tick and one
pilot launch a run, and each tick's cross-device steps: one sum of the
O(groups) stat rows (and with COUNT DISTINCT one max of the folded
register rows) a drawing tick, nothing of O(cells).  The fp32 answers
must agree with the host route's as the device route's do; a float64 run
is held to a device-route run of the same loop made beside it: every
key's moment rows, totals, draw ledgers, register plane and partials bit
for bit.  Each mesh tick's stage times print beside the device route's.

Then it drives the LM serving path: olmo-1b at full width and depth
(16 layers, d_model 2048, 16 heads of 128) in bf16 from a seeded
generator, six seeded prompts of 384-2048 tokens through a
``BatchScheduler`` of four slots, 16 new tokens each.  It checks that
every prefill ran its attention through the hand-written
``flash_attention`` kernel (one launch per layer per prefill; counts
reset just before, read just after), keeps the q, k, v of every one of
those calls and replays the kernel against its plain version on them,
timing the kernel, the plain version and PyTorch's
``scaled_dot_product_attention`` (the library yardstick; the port never
calls it).  It also holds the kernel on GQA, MQA, fp32 and every
head_dim it takes, and a reduced olmo-1b on the card against the CPU.

Then the VLM path: paligemma-3b at full width and depth (18 layers,
d_model 2048, 8 heads of 256 over one KV head) in bf16 from a seeded
generator, served as the reference serves a frontend config: two
prefills through ``serve_prefill`` with 256 seeded patch embeddings
(``synth_frontend_embeds``) before 767 tokens at batch 2 and 1791 at
batch 1 (S = 1023 and 2047), each followed by 8 greedy ``serve_decode``
steps.  It checks one ``flash_attention`` launch per layer of each
prefill, replays each of those calls against the plain version and times
it beside SDPA (``enable_gqa``).  The flash library's SASS
(``cuobjdump``) must show tensor-core instructions in every bf16
instantiation, and its ``-Xptxas -v`` log no spill.

Every failure exits nonzero.  The last three lines of standard output
are the card's name and power limit, one JSON object describing every
kernel, and the result object; details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
FOLD_SOURCE = "src/repro_torch/kernels/csrc/isla_kernels.cu"


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


SLEEP_CYCLES_PER_S = 2.0e9    # above the H100's SM clock: sleeps err long


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` warmed calls, CUDA events.
    The card spins (``torch.cuda._sleep``) while the host enqueues the
    timed calls, so a call that takes the card less time than the host
    takes to issue it is timed by the card's work, not the host's."""
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
    torch.cuda._sleep(int(min(1.5 * reps * host_s, 0.5)
                          * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_TRIES = 3       # windows a measurement takes when events go astray
PROFILE_GAP_S = 0.005   # host pause between the last work and a window
PROFILE_LEAD_S = 1e-4   # device spin that opens a window, not counted


def kernel_events(fn, names, reps: int = 20, warm: int = 3, setup=None):
    """The profiler's device events of the kernels whose names contain one
    of ``names`` over ``reps`` calls of ``fn``, each after ``setup()`` when
    given (untimed unless it runs such a kernel): ``(mean device ms a call
    or None when the trace holds no such event, events a call)``.

    The trace's window edges are not exact on the card: a kernel that ran
    just before a window can land in it, and the first kernel inside it
    can be left out (seen on the parent tree too).  So a window opens
    after a host pause with a short device spin (``torch.cuda._sleep``,
    never counted), and a window whose events are not a whole number a
    call is taken again, up to ``PROFILE_TRIES`` windows (the last one is
    reported)."""
    events = window_events(fn, names, reps, warm, setup)
    us = [t for _, t in events]
    return (sum(us) / reps * 1e-3 if us else None), len(us) / reps


def window_events(fn, names, reps: int = 20, warm: int = 3, setup=None):
    """``kernel_events``'s window: the ``(name, us)`` of each device event
    whose name contains one of ``names`` over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        if setup is not None:
            setup()
        fn()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        time.sleep(PROFILE_GAP_S)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(int(PROFILE_LEAD_S * SLEEP_CYCLES_PER_S))
            for _ in range(reps):
                if setup is not None:
                    setup()
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if str(e.device_type).endswith("CUDA")
                  and "spin_kernel" not in e.name
                  and any(n in e.name for n in names)]
        if events and len(events) % reps == 0:
            break
    return events


def kernel_ms(fn, names, reps: int = 20, warm: int = 3, setup=None):
    """Mean device milliseconds a call of ``fn`` spends in the kernels
    whose names contain one of ``names`` (``kernel_events``)."""
    return kernel_events(fn, names, reps, warm, setup)[0]


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# ---------------------------------------------------------------------------
# Kernel A: the dense fold at the serving tick's shapes.
# ---------------------------------------------------------------------------

# The serving tick's four keys (plain, WHERE, GROUP BY, WHERE + GROUP BY)
# over 16 groups x 1000 blocks: 34,000 cells.
FOLD_KEYS = ((1, False), (1, True), (16, False), (16, True))


def fold_case(device, n_blocks: int, quota: int, seed: int = 0):
    """The panes and resident rows one tick folds: value, pad, GROUP BY
    and predicate panes (n_blocks, quota), one bounds row, prior rows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_groups = max(g for g, _ in FOLD_KEYS)

    def dev(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=dt, device=device).contiguous()

    shape = (n_blocks, quota)
    case = dict(
        values=dev(rng.normal(1.0, 0.25, shape)),
        pad=torch.ones(shape, dtype=torch.float32, device=device),
        gid=dev(rng.integers(0, n_groups, shape), torch.int32),
        valid=dev(rng.random(shape) < 0.5),
        bounds=dev([0.5, 0.875, 1.125, 1.5]),
        n_cells=sum(g * n_blocks for g, _ in FOLD_KEYS))
    case["prior"] = dev(rng.uniform(0, 50, (case["n_cells"], 11)))
    return case


def fold_tick(fold, case, state) -> None:
    """One tick's fold: a launch per key onto its rows of ``state``."""
    n_b = case["values"].shape[0]
    o = 0
    for g, where in FOLD_KEYS:
        rows = state[o:o + g * n_b]
        fold(case["values"], case["bounds"], rows[:, 0:4], rows[:, 4:8],
             rows[:, 8:11], pad=case["pad"],
             valid=case["valid"] if where else None,
             gid=case["gid"] if g > 1 else None, n_groups=g)
        o += g * n_b


def fold_stack_tick(case, state) -> None:
    """The same tick's fold through ``fold_panes``: one launch folds all
    four keys onto their rows of ``state``."""
    from repro_torch.core import distributed as D

    D.fold_panes(state[:, 0:4], state[:, 4:8], state[:, 8:11],
                 case["values"], case["pad"], (case["gid"],),
                 (case["valid"],), case["bounds"],
                 n_groups_list=tuple(g for g, _ in FOLD_KEYS),
                 gid_slots=tuple(0 if g > 1 else -1 for g, _ in FOLD_KEYS),
                 valid_slots=tuple(0 if w else -1 for _, w in FOLD_KEYS))


def panes_bound_ms(values2d, pad_valid, gid_panes, valid_panes, bounds,
                   n_cells: int, n_keys: int, cell_idx=None
                   ) -> "tuple[float, float]":
    """Least time for one ``fold_panes`` call on this run's data: every
    real (unpadded) sample's value, pad, GROUP BY and predicate entries
    read once, the cuts and the cell map read once, the addressed
    resident rows read and written once; against the fp32 work of every
    key on every real sample (4 compares, 2 muls, 11 adds).  Returns
    the milliseconds the bytes take and those the operations take."""
    n_real = int(pad_valid.count_nonzero())
    n_panes = 2 + len(gid_panes) + len(valid_panes)
    in_bytes = 4 * n_panes * n_real + 4 * bounds.numel()
    if cell_idx is not None:
        in_bytes += 4 * cell_idx.numel()
    row_bytes = 2 * 4 * 11 * n_cells
    t_bytes = (in_bytes + row_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 17 * n_real * n_keys / FP32_FLOP_PER_S * 1e3
    return t_bytes, t_ops


def check_fold(device, n_blocks: int, quota: int) -> dict:
    import torch
    from repro_torch.kernels import isla_moments as K
    from repro_torch.kernels import ref

    case = fold_case(device, n_blocks, quota)
    want = case["prior"].clone()
    fold_tick(ref.isla_fold_ref, case, want)
    err, rel = 0.0, 0.0
    # The tick's fold through the stacked entry (one launch) and through
    # the one-key entry (a launch per key), each twice.
    for tick in (fold_stack_tick, lambda c, st: fold_tick(K.isla_fold, c,
                                                          st)):
        got, again = case["prior"].clone(), case["prior"].clone()
        tick(case, got)
        tick(case, again)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "isla_fold is not deterministic")
        err = max(err, max_abs_err(got, want))
        rel = max(rel, float(((got.double() - want.double()).abs()
                              / want.double().abs().clamp_min(1.0)).max()))
    check(rel <= 1e-5, f"isla_fold disagrees with its plain version at "
                       f"quota {quota}: max rel err {rel:.3g} > 1e-5")
    scratch = case["prior"].clone()
    ms = time_ms(lambda: fold_stack_tick(case, scratch))
    per_key_ms = time_ms(lambda: fold_tick(K.isla_fold, case, scratch))
    plain_ms = time_ms(lambda: fold_tick(ref.isla_fold_ref, case, scratch),
                       reps=5, warm=1)
    t_bytes, t_ops = panes_bound_ms(
        case["values"], case["pad"], (case["gid"],), (case["valid"],),
        case["bounds"], n_cells=case["n_cells"], n_keys=len(FOLD_KEYS))
    bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")
    return dict(quota=quota, n_blocks=n_blocks, cells=case["n_cells"],
                samples=case["values"].numel(), max_abs_err=err,
                max_rel_err=rel, tolerance="rel 1e-5", ms=ms,
                per_key_ms=per_key_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, launches_per_tick=1)


class Recorder:
    """Counts the calls the main path makes to ``distributed.<name>`` and,
    with ``keep``, keeps a copy of the arguments of every one
    (``fold_panes``: the value panes and the resident rows just before the
    fold; ``sketch_panes``: the hash panes and the resident register plane
    just before the merge), by wrapping it while installed."""

    def __init__(self, name: str, keep: bool = True):
        self.name = name
        self.keep = keep
        self.count = 0
        self.calls = []

    def __enter__(self):
        from repro_torch.core import distributed as D

        self._real = real = getattr(D, self.name)

        def clone(x):
            if hasattr(x, "_fields"):  # a NamedTuple (TaggedRuns)
                return type(x)(*(clone(v) for v in x))
            if isinstance(x, (tuple, list)):
                return type(x)(clone(v) for v in x)
            if isinstance(x, dict):
                return {k: clone(v) for k, v in x.items()}
            return x.clone() if hasattr(x, "clone") else x

        def spy(*args, **kw):
            self.count += 1
            if self.keep:
                self.calls.append(dict(args=clone(args), kw=clone(kw)))
            return real(*args, **kw)

        setattr(D, self.name, spy)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import distributed as D

        setattr(D, self.name, self._real)
        return False


class PlainVersions:
    """While installed, every kernel wrapper takes its plain PyTorch
    version for card tensors too (``on_gpu`` answers False), so a plain
    replay or a plain time is the same call on the same card tensors.
    Calls made under it launch nothing and count nothing."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.kernels import isla_moments as K

        self._mods = (K, FA)
        self._real = K.on_gpu
        for m in self._mods:
            m.on_gpu = lambda t: False
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            m.on_gpu = self._real
        return False


def check_main_path_folds(calls) -> "list[dict]":
    """Replay each fold of the main path on a copy of its rows: the kernel
    (twice: identical bits) against its plain version on the very panes
    the serving tick folded, then both timed, with the call's bound."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import isla_moments as K

    out = []
    for c in calls:
        state, panes = c["args"][:3], c["args"][3:]
        kw = c["kw"]

        def fold_into(rows):
            D.fold_panes(*rows, *panes, **kw)

        def run():
            rows = [t.clone() for t in state]
            fold_into(rows)
            return torch.cat(rows, dim=1)

        got, again = run(), run()
        with PlainVersions():
            want = run()
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              "isla_fold is not deterministic on the main path's panes")
        rel = float(((got.double() - want.double()).abs()
                     / want.double().abs().clamp_min(1.0)).max())
        values2d = panes[0]
        check(rel <= 1e-5, f"isla_fold disagrees with its plain version on "
                           f"the main path's {tuple(values2d.shape)} pane: "
                           f"max rel err {rel:.3g} > 1e-5")
        scratch = [t.clone() for t in state]
        event_ms = time_ms(lambda: fold_into(scratch))
        dev_ms = kernel_ms(lambda: fold_into(scratch), ("isla_fold",))
        with PlainVersions():
            plain_ms = time_ms(lambda: fold_into(scratch), reps=5, warm=1)
        g_list = kw["n_groups_list"]
        n_b = values2d.shape[0]
        active = kw.get("active_cells")
        _, _, stage = K.fold_stage(values2d.shape[1], D.stack_keys(
            n_b, g_list, kw["gid_slots"], kw["valid_slots"]))
        t_bytes, t_ops = panes_bound_ms(
            *panes, n_cells=sum(g * n_b for g in g_list),
            n_keys=len(g_list),
            cell_idx=None if active is None else active[0])
        out.append(dict(pane=list(values2d.shape), keys=len(g_list),
                        groups=list(g_list),
                        real_samples=int(panes[1].count_nonzero()),
                        compacted=active is not None,
                        dynamic_smem_bytes=stage,
                        max_abs_err=max_abs_err(got, want), max_rel_err=rel,
                        tolerance="rel 1e-5",
                        ms=event_ms if dev_ms is None else dev_ms,
                        kernel_ms=dev_ms, event_ms=event_ms,
                        plain_ms=plain_ms, bytes_ms=t_bytes, ops_ms=t_ops,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations"))
    return out


# ---------------------------------------------------------------------------
# Kernel C: the HLL register merge on the main path's hash panes.
# ---------------------------------------------------------------------------

PLAIN_REPS_LANE_CAP = 10_000_000  # wider panes: one plain replay, not five
SKETCH_OPS_PER_LANE = 30          # mix (3 64-bit muls as 32-bit IMADs,
                                  # shifts, xors), clz, shared max


def sketch_bound_ms(pad_valid, gid_panes, valid_panes, n_keys: int,
                    changed_regs: int) -> "tuple[float, float]":
    """Least time for one ``sketch_panes`` call on this run's data: every
    live lane's 8 bytes of raw bits and its pad, GROUP BY and predicate
    entries read once, and each register the merge raised read and
    written once (1 byte each); against ~30 integer operations per live
    lane and key at the guide's fp32 non-tensor peak (it lists no
    integer rate).  Returns the milliseconds the bytes take and those the
    operations take."""
    n_real = int(pad_valid.count_nonzero())
    in_bytes = n_real * (8 + 4 + 4 * (len(gid_panes) + len(valid_panes)))
    reg_bytes = 2 * changed_regs
    t_bytes = (in_bytes + reg_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = SKETCH_OPS_PER_LANE * n_real * n_keys / FP32_FLOP_PER_S * 1e3
    return t_bytes, t_ops


def check_main_path_sketches(calls) -> "list[dict]":
    """Replay each register merge of the main path on a copy of its
    plane: the kernel (twice: identical bits) against its plain version
    on the very hash panes the serving tick merged — bit for bit — then
    both timed, with the call's bound."""
    import torch
    from repro_torch.core import distributed as D

    out = []
    for c in calls:
        regs0, panes = c["args"][0], c["args"][1:]
        kw = c["kw"]

        def merge(regs):
            D.sketch_panes(regs, *panes, **kw)

        def run():
            regs = regs0.clone()
            merge(regs)
            return regs

        got, again = run(), run()
        with PlainVersions():
            want = run()
        torch.cuda.synchronize()
        bits = panes[0]
        check(torch.equal(got, again),
              "isla_sketch is not deterministic on the main path's panes")
        check(torch.equal(got, want),
              f"isla_sketch disagrees with its plain version on the main "
              f"path's {tuple(bits.shape)} hash pane")
        raised = got != regs0
        touched = int(raised.any(dim=1).sum())
        changed = int(raised.sum())
        scratch = regs0.clone()
        # Each timed merge starts from the plane the tick found (a repeat
        # on the merged plane would time the skip path alone); the events
        # time repeats on the merged plane.
        dev_ms = kernel_ms(lambda: merge(scratch), ("isla_sketch",),
                           setup=lambda: scratch.copy_(regs0))
        event_ms = time_ms(lambda: merge(scratch))
        plain_reps = 1 if bits.numel() > PLAIN_REPS_LANE_CAP else 5
        with PlainVersions():
            plain_ms = time_ms(lambda: merge(scratch), reps=plain_reps,
                               warm=1)
        g_list = kw["n_groups_list"]
        t_bytes, t_ops = sketch_bound_ms(*panes[1:4], n_keys=len(g_list),
                                         changed_regs=changed)
        out.append(dict(pane=list(bits.shape), keys=len(g_list),
                        groups=list(g_list),
                        live_lanes=int(panes[1].count_nonzero()),
                        touched_cells=touched, changed_registers=changed,
                        compacted=kw.get("active_cells") is not None,
                        max_abs_err=max_abs_err(got, want),
                        tolerance="0 (bit-identical)",
                        ms=event_ms if dev_ms is None else dev_ms,
                        kernel_ms=dev_ms, repeat_event_ms=event_ms,
                        plain_ms=plain_ms, plain_reps=plain_reps,
                        bytes_ms=t_bytes, ops_ms=t_ops,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations"))
    return out


# ---------------------------------------------------------------------------
# The Pallas-signature wrappers, each against its plain version.
# ---------------------------------------------------------------------------


def check_wrappers(device, n_cells: int = 1000, lanes: int = 1024,
                   n_groups: int = 16) -> "list[dict]":
    """Every Pallas-signature wrapper at the serving loop's widest pane
    (``n_cells`` blocks x ``lanes`` samples, as (n_cells, lanes/128, 128)
    tiles), each held against its plain version on the same card tensors
    (moments rel 1e-5, registers bit for bit) and both timed, with the
    byte bound of what the call reads and writes."""
    import numpy as np
    import torch
    from repro_torch.core.types import IslaParams
    from repro_torch.kernels import isla_moments as K

    rng = np.random.default_rng(3)
    rows = lanes // 128
    shape = (n_cells, rows, 128)
    raw = np.round(rng.normal(100, 20, shape))
    bits = raw.view(np.uint64)

    def dev(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    x = dev(raw, torch.float32)
    hi = dev((bits >> np.uint64(32)).astype(np.uint32).view(np.int32))
    lo = dev((bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
             .view(np.int32))
    valid = dev((rng.random(shape) < 0.9).astype(np.int32))
    bounds = dev([60.0, 90.0, 110.0, 140.0], torch.float32)
    prior = dev(rng.uniform(0, 50, (n_cells, 2, 4)), torch.float32)
    prior_regs = dev(rng.integers(0, 8, (n_cells, 32, 128)), torch.uint8)
    grouped = dev(np.round(rng.normal(100, 20, (n_groups,) + shape)),
                  torch.float32)
    params = IslaParams(e=0.5)
    n = x.numel()
    mom_rw = 2 * 4 * 8  # a (2, 4) fp32 cell row read and written
    def raised(out):  # registers the merge raised, each read and written
        return 2 * int((out[1] != prior_regs).sum())

    # name: (values shape, call, bytes it must move given its outputs)
    cases = {
        "isla_moments": (
            (n_cells * rows, 128),
            lambda: K.isla_moments(x.reshape(-1, 128), bounds, tm=rows),
            lambda out: 4 * n + mom_rw),
        "isla_moments_grouped": (
            tuple(grouped.shape),
            lambda: K.isla_moments_grouped(grouped, bounds, tm=rows),
            lambda out: 4 * grouped.numel() + mom_rw * n_groups * n_cells),
        "isla_fused": (
            shape,
            lambda: K.isla_fused(x, bounds, prior.clone(), 100.0, params,
                                 tm=rows),
            lambda out: 4 * n + (mom_rw + 4) * n_cells),
        "isla_fused_sketch": (
            shape,
            lambda: K.isla_fused_sketch(x, bounds, prior.clone(),
                                        prior_regs.clone(), hi, lo, valid,
                                        100.0, params, tm=rows),
            lambda out: 16 * n + (mom_rw + 4) * n_cells + raised(out)),
    }
    out = []
    for name, (v_shape, call, need_bytes) in cases.items():
        got = call()
        with PlainVersions():
            want = call()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, rel = 0.0, 0.0
        for g, w in zip(got, want):
            if g.dtype == torch.uint8:
                check(torch.equal(g, w), f"{name} registers disagree with "
                                         f"its plain version")
                continue
            err = max(err, max_abs_err(g, w))
            rel = max(rel, float(((g.double() - w.double()).abs()
                                  / w.double().abs().clamp_min(1.0)).max()))
        check(rel <= 1e-5, f"{name} disagrees with its plain version: max "
                           f"rel err {rel:.3g} > 1e-5")
        ms = time_ms(call)
        with PlainVersions():
            plain_ms = time_ms(call, reps=5, warm=1)
        out.append(dict(name=name, shape=list(v_shape), max_abs_err=err,
                        max_rel_err=rel,
                        tolerance="rel 1e-5; registers bit-identical",
                        ms=ms, plain_ms=plain_ms,
                        bound_ms=need_bytes(got) / HBM_BYTES_PER_S * 1e3,
                        bound_by="bytes"))
    return out


def check_batched(device) -> dict:
    """``isla_moments_batched`` (the Pallas signature on the fold kernel)
    with a tile stride and per-cell cuts, against the fold's plain
    version on the same card tensors."""
    import numpy as np
    import torch
    from repro_torch.kernels import isla_moments as K
    from repro_torch.kernels import ref

    rng = np.random.default_rng(1)
    n, rows, tm, stride = 1000, 64 * 8, 64, 2
    x = torch.as_tensor(rng.normal(100, 20, (n, rows, 128)),
                        dtype=torch.float32, device=device)
    b = torch.as_tensor(np.asarray([60.0, 90.0, 110.0, 140.0])[None]
                        + rng.uniform(-5, 5, (n, 1)), dtype=torch.float32,
                        device=device)
    chunks = (tm * 128, stride * tm * 128, rows // tm // stride)

    def plain():
        out = torch.zeros((n, 2, 4), dtype=torch.float32, device=device)
        ref.isla_fold_ref(x.reshape(n, rows * 128), b, out[:, 0],
                          out[:, 1], chunks=chunks)
        return out

    got = K.isla_moments_batched(x, b, tm=tm, stride=stride)
    want = plain()
    rel = float(((got.double() - want.double()).abs()
                 / want.double().abs().clamp_min(1.0)).max())
    check(rel <= 1e-5, f"isla_moments_batched disagrees with its plain "
                       f"version: max rel err {rel:.3g} > 1e-5")
    ms = time_ms(lambda: K.isla_moments_batched(x, b, tm=tm, stride=stride))
    plain_ms = time_ms(plain, reps=5, warm=1)
    read = 4 * (n * chunks[0] * chunks[2] + b.numel())
    return dict(shape=[n, rows, 128], tm=tm, stride=stride,
                max_abs_err=max_abs_err(got, want), max_rel_err=rel,
                tolerance="rel 1e-5", ms=ms, plain_ms=plain_ms,
                bound_ms=(read + 4 * 8 * n) / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes")


# ---------------------------------------------------------------------------
# Kernel B: pilot statistics.
# ---------------------------------------------------------------------------


PILOT_SIZES = (100_000, 1_000_000, 10_000_000)  # beside the loop's pilot
PILOT_KERNEL = "pilot_moments_kernel"
L2_FLUSH_BYTES = 64 << 20  # read between calls: more than the 50 MB L2


def pilot_host_ms(v_host, reps: int) -> dict:
    """Host milliseconds (median of ``reps``) of ``pilot_stats_device`` as
    a whole, and of its stages run one by one with a sync after each:
    scale (``prescale_pilot``), upload, launch (the kernel finished) and
    readback."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import isla_moments as K

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[len(ts) // 2]

    dev = torch.device("cuda")
    box = {}

    def scale():
        box["v32"], _ = D.prescale_pilot(v_host)

    def upload():
        box["v"] = D.h2d(box["v32"], torch.float32, dev)

    def launch():
        box["m"] = K.pilot_moments(box["v"])

    out = dict(whole=median_ms(
        lambda: D.pilot_stats_device(v_host, device="cuda")))
    for name, fn in (("scale", scale), ("upload", upload),
                     ("launch", launch),
                     ("readback", lambda: box["m"].tolist())):
        out[name] = median_ms(fn)
    return out


def check_pilot(device, loop_n: int) -> "list[dict]":
    """The pilot kernel at the loop's pilot size and at 10^5, 10^6 and 10^7
    samples: ``pilot_moments`` against its float64 plain version (count
    and min exact, mean, M2 and sigma within rel 1e-5; a second run
    bit-identical), ``pilot_stats`` with and without a centre against the
    form derived from the plain moments (``ref.stats_from_moments``); its
    device time from the profiler (as after the upload, and after a read
    of 64 MB has flushed L2) beside the byte bound and the launches a
    call; the plain version's and ``torch.std_mean`` +
    ``torch.min``'s time (no one call computes the function); and the
    device pilot's host time with its stages.  At the loop's size it also
    times the card's smallest launch (a one-element ``fill_``) the same
    way."""
    import numpy as np
    import torch
    from repro_torch.kernels import isla_moments as K
    from repro_torch.kernels import ref

    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    tiny = torch.zeros(1, device=device)
    rows = []
    for n in (loop_n,) + PILOT_SIZES:
        v_host = np.random.default_rng(2).normal(0.8, 0.1, n)
        v = torch.as_tensor(v_host, dtype=torch.float32, device=device)
        got, again = K.pilot_moments(v), K.pilot_moments(v)
        want = ref.pilot_moments_ref(v)
        check(torch.equal(got, again),
              f"pilot_moments n={n}: two runs differ: {got} vs {again}")
        g, w = got.tolist(), want.tolist()
        rel = [abs(g[i] - w[i]) / max(abs(w[i]), 1e-300) for i in (1, 2, 4)]
        check(g[0] == w[0] == n and g[3] == w[3] and max(rel) <= 1e-5,
              f"pilot_moments n={n} disagrees with its plain version: "
              f"{g} vs {w} (rel {rel})")
        err = max(abs(a - b) for a, b in zip(g, w))
        # pilot_stats (the same launch): its (count, sum (x-c), sum
        # (x-c)^2, min) against the form derived from the plain moments,
        # sum (x-c) = n (mean - c) to 4 n ulps of c absolute (c is the
        # run's fp32 mean there, so the sum is ~0 and rests on the fp32
        # mean's last bits).
        center = (v.sum() / n).reshape(1)
        for c in (None, center):
            st = K.pilot_stats(v, center=c).double()
            ws = ref.stats_from_moments(want, c).double()
            floor = 0.0 if c is None else 4 * n * float(
                np.spacing(np.float32(c.item())))
            bad = (st - ws).abs() > 1e-5 * ws.abs() + torch.tensor(
                [0.0, floor, 0.0, 0.0], dtype=torch.float64, device=device)
            check(not bool(bad.any()) and float(st[0]) == n
                  and float(st[3]) == float(ws[3]),
                  f"pilot_stats n={n} disagrees with its plain version: "
                  f"{st} vs {ws}")
            err = max(err, max_abs_err(st, ws))
        hot_ms, per_call = kernel_events(lambda: K.pilot_moments(v),
                                         (PILOT_KERNEL,))
        cold_ms, _ = kernel_events(lambda: K.pilot_moments(v),
                                   (PILOT_KERNEL,),
                                   setup=lambda: flush.max())
        check(per_call == 1.0, f"pilot_moments n={n}: {per_call} kernel "
                               f"launches a call, not 1")
        bound = 4 * n / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * n / FP32_FLOP_PER_S * 1e3
        row = dict(n=n, max_abs_err=err, max_rel_err=max(rel),
                   tolerance=("rel 1e-5; count and min exact; pilot_stats' "
                              "sum (x-c) also 4 n ulps of c"), ms=hot_ms,
                   cold_ms=cold_ms, launches_per_call=per_call,
                   event_ms=time_ms(lambda: K.pilot_moments(v)),
                   plain_ms=time_ms(lambda: ref.pilot_moments_ref(v)),
                   std_mean_min_ms=time_ms(
                       lambda: (torch.std_mean(v), torch.min(v))),
                   bound_ms=max(bound, t_ops),
                   bound_by="bytes" if bound >= t_ops else "operations",
                   host_ms=pilot_host_ms(v_host, 5 if n >= 10 ** 7 else 20))
        if n == loop_n:
            row["smallest_launch_ms"] = kernel_ms(lambda: tiny.fill_(1.0),
                                                  ("",))
        rows.append(row)
    del flush
    return rows


# ---------------------------------------------------------------------------
# The main path: the admission loop on route="device".
# ---------------------------------------------------------------------------


# The main path's two runs.  A COUNT DISTINCT ask on a key gives its
# store a register plane, and one sketch member makes the whole stacked
# mode-group a sketch stack, so moment-only traffic and traffic with
# COUNT DISTINCT take two different ticks; each run drives one of them.
MAIN_RUNS = (("moments", False), ("distinct", True))


def serve_queries(C, e: float, distinct: bool):
    """One tick's batch: the four serving keys (plain, WHERE, GROUP BY,
    WHERE + GROUP BY) under the four moment aggregates, and with
    ``distinct`` COUNT DISTINCT on each of the four keys."""
    flag = C.Predicate(column="flag", eq=1.0)
    qs = [C.IslaQuery(e=e, agg="AVG"),
          C.IslaQuery(e=e, agg="SUM", where=flag),
          C.IslaQuery(e=e, agg="AVG", group_by="region"),
          C.IslaQuery(e=e, agg="COUNT", group_by="region", where=flag),
          C.IslaQuery(e=e, agg="VAR")]
    if distinct:
        qs += [C.IslaQuery(e=e, agg="count_distinct"),
               C.IslaQuery(e=e, agg="count_distinct", where=flag),
               C.IslaQuery(e=e, agg="count_distinct", group_by="region"),
               C.IslaQuery(e=e, agg="count_distinct", group_by="region",
                           where=flag)]
    return qs


def run_serve(device: str, route: str, n_blocks: int, n_groups: int,
              rows: int, ticks, distinct: bool, seed: int = 0,
              profile_at=(), pilot_device: "str | None" = None,
              mesh=None):
    """Drive the admission loop: one batch of ``serve_queries`` per entry
    of ``ticks`` (its precision e), the ticks in ``profile_at`` (their
    indices) under the torch profiler.  ``pilot_device`` gives the executor the device pilot on
    that device whatever its route (a host-route run that shares the
    device route's anchor); ``mesh`` is the executor's cell mesh of
    ``route="mesh"`` (its shards' devices).  Returns the finished tickets,
    the executor and per-tick records (with the host seconds the tick
    spent on its run tables: ``DeviceStack.key_runs`` and
    ``tagged_run_table``, and the tick's cross-device reduces)."""
    import functools

    import numpy as np
    import repro_torch.core as C
    import repro_torch.core.moment_store as MS
    import repro_torch.core.multiquery as MQ
    from repro_torch.kernels import isla_moments as K
    from repro_torch.launch.serve import (IslaAdmissionLoop,
                                          _synthetic_grouped_blocks)

    samplers = _synthetic_grouped_blocks(n_blocks, n_groups, rows, seed)
    ex = C.MultiQueryExecutor(samplers, [10 ** 7] * n_blocks,
                              params=C.IslaParams(e=ticks[0]),
                              group_domains={"region": n_groups},
                              device=device, mesh=mesh)
    if pilot_device is not None:
        ex._pilot_stats_fn = lambda route: functools.partial(
            MQ.pilot_stats_device, device=pilot_device)
    loop = IslaAdmissionLoop(ex, np.random.default_rng(seed + 1),
                             route=route, incremental=True)
    done, records = [], []
    table_s = [0.0]

    def timed(fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                table_s[0] += time.perf_counter() - t0
        return run

    real_runs, real_table = MS.DeviceStack.key_runs, MS.tagged_run_table
    MS.DeviceStack.key_runs = timed(real_runs)
    MS.tagged_run_table = timed(real_table)
    try:
        with Recorder("fold_panes", keep=False) as folds, \
                Recorder("sketch_panes", keep=False) as merges, \
                Recorder("_segment_carry_sum", keep=False) as tagged:
            serve_ticks(loop, ex, C, K, ticks, distinct, device, profile_at,
                        folds, merges, tagged, table_s, done, records)
    finally:
        MS.DeviceStack.key_runs, MS.tagged_run_table = real_runs, real_table
    return done, ex, records


def serve_ticks(loop, ex, C, K, ticks, distinct, device, profile_at, folds,
                merges, tagged, table_s, done, records) -> None:
    """``run_serve``'s ticks, each recorded (see there)."""
    from repro_torch.core import distributed as D

    for k, e in enumerate(ticks):
        for q in serve_queries(C, e, distinct):
            loop.submit(q)
        f0, p0 = K.isla_fold.launches, K.pilot_stats.launches
        s0 = K.isla_sketch.launches
        tt0, ts0 = K.isla_tagged_fold.launches, \
            K.isla_sketch_tagged.launches
        fc0, sc0, tc0 = folds.count, merges.count, tagged.count
        rt0 = table_s[0]
        prof = profile_tick(device, k in profile_at)
        t0 = time.perf_counter()
        with prof, D.collective_footprint() as reduces:
            out = loop.tick()
            if device == "cuda":
                import torch
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        records.append(dict(
            e=e, wall_s=wall, answered=len(out),
            device_busy_s=device_seconds(prof),
            kernel_events=device_kernel_counts(prof),
            new_samples=sum({a.answer.pass_id: a.answer.new_samples
                             for a in out}.values()),
            fold_calls=folds.count - fc0,
            sketch_calls=merges.count - sc0,
            tagged_calls=tagged.count - tc0,
            fold_launches=K.isla_fold.launches - f0,
            pilot_launches=K.pilot_stats.launches - p0,
            sketch_launches=K.isla_sketch.launches - s0,
            tagged_launches=K.isla_tagged_fold.launches - tt0,
            tagged_sketch_launches=K.isla_sketch_tagged.launches - ts0,
            run_table_host_s=table_s[0] - rt0,
            collectives=list(reduces),
            stages_s=dict(ex.last_stage_times)))
        done.extend(out)


def profile_tick(device: str, on: bool):
    """A torch.profiler context over one tick (CPU + CUDA activity) when
    ``on`` and on the card, else a no-op context."""
    import contextlib

    if not (on and device == "cuda"):
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_seconds(prof):
    """Seconds of kernel time on the card inside a profiled tick (the sum
    of the device events' durations), None when not profiled or when the
    trace holds no device event."""
    if not hasattr(prof, "events"):
        return None
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    return sum(spans) * 1e-6 if spans else None


def device_kernel_seconds(prof) -> dict:
    """Seconds of device time by kernel name in a profiled window (empty
    when not profiled or when the trace holds no device event)."""
    out = {}
    if not hasattr(prof, "events"):
        return out
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            us = e.time_range.elapsed_us()
            out[e.name] = out.get(e.name, 0.0) + us * 1e-6
    return out


ISLA_KERNELS = ("isla_fold_kernel", "isla_fold_combine_kernel",
                "isla_sketch_kernel", "pilot_moments_kernel",
                "isla_tagged_fold_kernel", "isla_tagged_runs_kernel")


def device_kernel_counts(prof) -> "dict | None":
    """How many times each ISLA ``__global__`` kernel ran on the card in a
    profiled window (by the device events' names), and how many sort
    kernels (``sort`` in the name), None when not profiled or when the
    trace holds no device event."""
    if not hasattr(prof, "events"):
        return None
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    if not names:
        return None
    out = {k: sum(1 for n in names if k in n) for k in ISLA_KERNELS}
    out["sort"] = sum(1 for n in names if "sort" in n.lower())
    return out


def trace_whole(r: dict) -> bool:
    """Whether a profiled tick's trace holds every ISLA kernel that the
    wrappers' launch counts say the tick ran."""
    ev = r["kernel_events"]
    want = {"isla_fold_kernel": r["fold_launches"],
            "pilot_moments_kernel": r["pilot_launches"],
            "isla_sketch_kernel": r["sketch_launches"]
            + r["tagged_sketch_launches"]}
    if not any(want.values()) and not r["tagged_launches"]:
        return True
    return ev is not None and all(ev[k] >= n for k, n in want.items()) \
        and ev["isla_tagged_fold_kernel"] + ev["isla_tagged_runs_kernel"] \
        >= r["tagged_launches"]


def profiled_serve(name: str, n_blocks, n_groups, rows, ticks, distinct,
                   profile_at, forbidden=()) -> "tuple[list, int]":
    """A re-run of the main path's loop (same seed, same draws) with the
    ticks in ``profile_at`` under the profiler.  The profiler can lose a
    window's kernel records on the card (seen once: a traced tick that
    held none of the ISLA kernels it launched), and a trace that lost
    kernels cannot show that one did not run.  So every traced tick must
    be ``trace_whole``; the run is taken again when one is not, up to
    ``PROFILE_TRIES`` runs, and fails after that.  A kernel of
    ``forbidden`` (``device_kernel_counts``' keys) in any trace fails at
    once.  Returns the last run's records and the runs it took."""
    for run in range(1, PROFILE_TRIES + 1):
        _, _, recs = run_serve("cuda", "device", n_blocks, n_groups, rows,
                               ticks, distinct, profile_at=profile_at)
        for k in profile_at:
            ev = recs[k]["kernel_events"] or {}
            check(not any(ev.get(f) for f in forbidden),
                  f"the {name} run's profiled tick {k + 1} ran {ev}")
        if all(trace_whole(recs[k]) for k in profile_at):
            return recs, run
        print(f"the {name} run's profiled re-run {run}: the trace lost "
              f"kernels the launch counts name: "
              + "; ".join(f"tick {k + 1} {recs[k]['kernel_events']}"
                          for k in profile_at))
    check(False, f"the {name} run's profiled ticks lost kernels in "
                 f"{PROFILE_TRIES} runs")


def host_op_seconds(prof, top: int = 12) -> dict:
    """The ``top`` operators by host (self CPU) seconds in a profiled
    window, with their call counts."""
    if not hasattr(prof, "key_averages"):
        return {}
    rows = sorted(prof.key_averages(), key=lambda r: -r.self_cpu_time_total)
    return {r.key: [r.self_cpu_time_total * 1e-6, r.count]
            for r in rows[:top]}


def check_answers(dev_done, host_done, distinct: bool) -> dict:
    """Device route vs the port's float64 host route: finite values,
    identical draw ledgers, values rel 2e-3 and groups rel 5e-3 (the
    reference's device-versus-host tolerances); COUNT DISTINCT answers
    equal (the same registers give the same host estimate)."""
    check(len(dev_done) == len(host_done) > 0, "answer counts differ")
    worst, worst_g, n_distinct = 0.0, 0.0, 0
    for d, h in zip(dev_done, host_done):
        a, b = d.answer, h.answer
        check(math.isfinite(a.value), f"non-finite answer {a.value}")
        check(a.new_samples == b.new_samples
              and a.sample_size == b.sample_size,
              f"draw ledgers differ: {a.new_samples}/{a.sample_size} vs "
              f"{b.new_samples}/{b.sample_size}")
        if a.query.agg == "count_distinct":
            check(a.value == b.value and a.error_bound == b.error_bound,
                  f"count_distinct device {a.value} vs host {b.value}")
            check(b.groups is None or [g.value for g in a.groups]
                  == [g.value for g in b.groups],
                  "count_distinct group answers differ")
            n_distinct += 1
            continue
        rel = abs(a.value - b.value) / max(abs(b.value), 1e-12)
        worst = max(worst, rel)
        check(rel <= 2e-3, f"{a.query.agg} device {a.value} vs host "
                           f"{b.value}: rel {rel:.3g} > 2e-3")
        if b.groups is not None:
            for gd, gh in zip(a.groups, b.groups):
                check(gd.n_samples == gh.n_samples,
                      "group sample counts differ")
                if math.isfinite(gh.value):
                    r = abs(gd.value - gh.value) / max(abs(gh.value), 1e-12)
                    worst_g = max(worst_g, r)
                    check(r <= 5e-3, f"group value rel {r:.3g} > 5e-3")
    check(n_distinct > 0 or not distinct,
          "no count_distinct answer was served")
    return dict(answers=len(dev_done), distinct_answers_equal=n_distinct,
                max_rel_value=worst, max_rel_group=worst_g)


def main_path(name: str, distinct: bool, n_blocks=1000, n_groups=16,
              rows=20000, ticks=(0.5, 0.25, 0.25)) -> dict:
    """One run of the main path: the launch counts are set to 0 just
    before the loop and read just after; every kernel of the run's tick
    must have launched (``isla_sketch`` exactly when COUNT DISTINCT is
    asked).  Its answers are then held against the float64 host route,
    and a second, profiled run of the same loop gives the device's busy
    time."""
    import torch
    from repro_torch.kernels import isla_moments as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    with Recorder("fold_panes") as folds, \
            Recorder("sketch_panes") as sketches:
        dev_done, ex, records = run_serve("cuda", "device", n_blocks,
                                          n_groups, rows, ticks, distinct)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"isla_fold": K.isla_fold.launches,
                "pilot_stats": K.pilot_stats.launches,
                "isla_sketch": K.isla_sketch.launches}
    check(K.isla_tagged_fold.launches == K.isla_sketch_tagged.launches == 0,
          f"the {name} run (fp32) launched a tagged kernel")
    for kernel, n in launches.items():
        if kernel == "isla_sketch" and not distinct:
            check(n == 0, f"the {name} run launched isla_sketch: its "
                          f"moment-only tick took the sketch stack")
        else:
            check(n > 0, f"the {name} run never launched {kernel}")
    # One launch folds (merges) every key of a tick: each fold_panes
    # (sketch_panes) call of every tick launches its kernel exactly once.
    for k, r in enumerate(records):
        check(r["fold_launches"] == r["fold_calls"]
              and r["sketch_launches"] == r["sketch_calls"],
              f"the {name} run's tick {k + 1} made {r['fold_calls']} "
              f"fold_panes and {r['sketch_calls']} sketch_panes calls but "
              f"{r['fold_launches']} isla_fold and {r['sketch_launches']} "
              f"isla_sketch launches")
    # One cold plan a run (the anchor stays frozen), one device pilot,
    # one pilot kernel launch.
    check(launches["pilot_stats"] == 1 and records[0]["pilot_launches"] == 1,
          f"the {name} run's cold plan made {records[0]['pilot_launches']} "
          f"pilot_stats launches ({launches['pilot_stats']} in the run), "
          f"not 1")
    pilot_n = int(ex._anchor[0].pilot_size)
    repair = phase2_repair(ex)
    del ex  # the host run below rebuilds the same tables
    host_done, _, _ = run_serve("cpu", "host", n_blocks, n_groups, rows,
                                ticks, distinct)
    agree = check_answers(dev_done, host_done, distinct)
    # The profiler inflates the host stages of the tick it traces, so the
    # device's busy time comes from a second, profiled run of the same
    # loop (same seed, same draws) after the counts were read.
    profiled, traced_runs = profiled_serve(
        name, n_blocks, n_groups, rows, ticks, distinct, (1,),
        forbidden=("isla_fold_combine_kernel",))
    # The profiler's own count of the traced tick's ISLA kernels: one fold
    # kernel per fold_panes call (its combine only when a row is sliced,
    # which the loop's panes never are) and one merge per sketch_panes.
    ev, r = profiled[1]["kernel_events"], profiled[1]
    check(ev["isla_fold_kernel"] == r["fold_calls"]
          and ev["isla_fold_combine_kernel"] == 0
          and ev["isla_sketch_kernel"] == r["sketch_calls"],
          f"the {name} run's profiled tick ran {ev} for "
          f"{r['fold_calls']} fold_panes and {r['sketch_calls']} "
          f"sketch_panes calls")
    return dict(name=name, launches=launches, wall_s=wall, ticks=records,
                profiled_ticks=profiled, traced_runs=traced_runs,
                pilot_size=pilot_n,
                agreement=agree, phase2=repair, fold_calls=folds.calls,
                sketch_calls=sketches.calls,
                shape=dict(blocks=n_blocks, groups=n_groups, rows=rows))


# ---------------------------------------------------------------------------
# The float64 tagged tick: the same loop with the torch default dtype
# float64, so every key's device store runs float64 (scale 1.0) and each
# drawing tick folds its tagged stream with isla_tagged_fold.
# ---------------------------------------------------------------------------

F64_RUNS = (("moments f64", False), ("distinct f64", True))
FP64_FLOP_PER_S = 34e12  # H100 SXM float64 outside the tensor cores
                         # (NVIDIA's data sheet; the guide lists none)


def ulp_gap(got, want) -> "tuple[int, float]":
    """How many float64 values differ and the largest gap in ulps of the
    wanted value."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    if not diff.any():
        return 0, 0.0
    gap = np.abs(got - want)[diff] / np.spacing(np.abs(want[diff]))
    return int(diff.sum()), float(gap.max())


def phase2_gaps(dst) -> dict:
    """A device store's last partials against Phase 2 run on the CPU over
    the card's state (cells that differ, the largest gap in ulps), and
    the cells the division repair moved: Phase 2 on the card again with
    its divisions by constants taken by a host scalar, as torch does it
    (a product with the reciprocal), against the partials."""
    import torch
    from repro_torch.core import distributed as D

    params, mode, geometry = dst._stats_cfg
    card = dst._partials
    cpu, old = [], None
    for dev in ("cpu", card.device):
        inv = torch.full((dst.n_cells,), 1.0 / dst.scale, dtype=dst.dtype,
                         device=dev)
        thr, geo = D._scaled_solve_args(params, geometry, inv)
        args = (dst.mom_s.to(dev), dst.mom_l.to(dev),
                dst._sketch0_dev.to(dev).expand(dst.n_cells), params)
        kw = dict(mode=mode, geometry=geo, thr=thr)
        if dev == "cpu":
            cpu = D.phase2(*args, **kw)
            continue
        real = D._div
        D._div = lambda x, d: x / d
        try:
            old = D.phase2(*args, **kw)
        finally:
            D._div = real
    n, g = ulp_gap(card.cpu().numpy(), cpu.numpy())
    return dict(cells=dst.n_cells, differ_from_cpu=n, max_ulps_from_cpu=g,
                moved_by_repair=int((old != card).sum()))


def phase2_repair(ex) -> dict:
    """``phase2_gaps`` summed over an executor's device stores."""
    out = dict(cells=0, differ_from_cpu=0, max_ulps_from_cpu=0.0,
               moved_by_repair=0)
    for dst in ex._device_stores.values():
        g = phase2_gaps(dst)
        for k in ("cells", "differ_from_cpu", "moved_by_repair"):
            out[k] += g[k]
        out["max_ulps_from_cpu"] = max(out["max_ulps_from_cpu"],
                                       g["max_ulps_from_cpu"])
    return out


def check_f64_state(dev_ex, host_ex) -> dict:
    """Every key's float64 device state against the host route's
    ``MomentStore`` after the same draws under the same anchor: moment
    rows, totals, draw ledger and register plane bit for bit, and the
    partials equal to Phase 2 run on the CPU over the card's state.  The
    device partials' gaps to the host solve of the same state are counted
    (the reference's own formula parts from it; not gated)."""
    import numpy as np
    import torch

    n_keys, p_host, gap_host, cells = 0, 0, 0.0, 0
    for skey, dst in dev_ex._device_stores.items():
        check(dst.dtype == torch.float64 and dst.scale == 1.0,
              f"the float64 run's store {skey} runs {dst.dtype} at scale "
              f"{dst.scale}")
        hs = host_ex._stores[skey]
        got = dst.to_host()
        for f in ("mom_s", "mom_l", "totals", "n_sampled"):
            check(np.array_equal(getattr(got, f), getattr(hs, f)),
                  f"the float64 store {skey} is not bit-identical to the "
                  f"host route's in {f}")
        if hs.has_sketch:
            check(np.array_equal(got.regs, hs.regs),
                  f"the float64 store {skey}'s register plane differs from "
                  f"the host route's")
        params, mode, geometry = dst._stats_cfg
        host = hs.solve(params, mode=mode, geometry=geometry).avg
        n, g = ulp_gap(dst.partials_host(), host)
        p_host, gap_host = p_host + n, max(gap_host, g)
        n_keys += 1
        cells += dst.n_cells
    check(n_keys > 0, "the float64 run kept no device store")
    repair = phase2_repair(dev_ex)
    check(repair["differ_from_cpu"] == 0,
          f"{repair['differ_from_cpu']} float64 partials differ from Phase 2 "
          f"run on the CPU over the card's state (max "
          f"{repair['max_ulps_from_cpu']:g} ulp)")
    return dict(keys=n_keys, cells=cells, state_bit_identical=True,
                partials_differing_from_host_solve=p_host,
                max_ulps_from_host_solve=gap_host, phase2=repair)


def main_path_f64(name: str, distinct: bool, n_blocks=1000, n_groups=16,
                  rows=20000, ticks=(0.5, 0.25, 0.25)) -> dict:
    """One float64 run of the main path, the torch default dtype float64
    for the run and restored after it: the launch counts are set to 0 just
    before the loop and read just after; every drawing tick must make one
    ``isla_tagged_fold`` launch a tagged fold (and, with COUNT DISTINCT,
    one ``isla_sketch_tagged`` launch), no dense launch, one pilot launch
    a run.  A host-route run of the same loop under the same anchor (the
    host route takes the device pilot too) then holds every key's state
    bit for bit and the answers."""
    import torch
    from repro_torch.kernels import isla_moments as K

    was = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with Recorder("_segment_carry_sum") as folds, \
                Recorder("isla_sketch_tagged") as merges:
            dev_done, ex, records = run_serve("cuda", "device", n_blocks,
                                              n_groups, rows, ticks,
                                              distinct)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"isla_tagged_fold": K.isla_tagged_fold.launches,
                    "isla_sketch_tagged": K.isla_sketch_tagged.launches,
                    "pilot_stats": K.pilot_stats.launches,
                    "isla_fold": K.isla_fold.launches,
                    "isla_sketch": K.isla_sketch.launches}
        check(launches["isla_tagged_fold"] > 0
              and launches["isla_fold"] == launches["isla_sketch"] == 0,
              f"the {name} run launched {launches}")
        check((launches["isla_sketch_tagged"] > 0) == distinct,
              f"the {name} run made {launches['isla_sketch_tagged']} "
              f"tagged register merges")
        for k, r in enumerate(records):
            check(r["tagged_launches"] == r["tagged_calls"]
                  and r["tagged_sketch_launches"]
                  == (r["tagged_calls"] if distinct else 0)
                  and r["fold_calls"] == r["sketch_calls"] == 0,
                  f"the {name} run's tick {k + 1} made {r['tagged_calls']} "
                  f"tagged folds with {r['tagged_launches']} isla_tagged_fold "
                  f"and {r['tagged_sketch_launches']} isla_sketch_tagged "
                  f"launches")
        check(launches["pilot_stats"] == 1
              and records[0]["pilot_launches"] == 1,
              f"the {name} run made {launches['pilot_stats']} pilot "
              f"launches, not 1")
        host_done, host_ex, _ = run_serve("cpu", "host", n_blocks, n_groups,
                                          rows, ticks, distinct,
                                          pilot_device="cuda")
        state = check_f64_state(ex, host_ex)
        agree = check_answers(dev_done, host_done, distinct)
        exact = sum(d.answer.value == h.answer.value
                    for d, h in zip(dev_done, host_done))
        del ex, host_ex
        # The profiler's view of both drawing ticks, in a re-run of the
        # same loop: the run kernel once a tagged fold, the sorted path's
        # kernel never, no sort kernel at all.
        profiled, traced_runs = profiled_serve(
            name, n_blocks, n_groups, rows, ticks, distinct, (0, 1),
            forbidden=("isla_tagged_fold_kernel", "sort"))
        for k in (0, 1):
            ev, r = profiled[k]["kernel_events"], profiled[k]
            check(ev is not None and r["tagged_calls"] > 0
                  and ev["isla_tagged_runs_kernel"] == r["tagged_calls"]
                  and ev["isla_tagged_fold_kernel"] == 0 and ev["sort"] == 0,
                  f"the {name} run's profiled tick {k + 1} ran {ev} for "
                  f"{r['tagged_calls']} tagged folds")
    finally:
        torch.set_default_dtype(was)
    return dict(name=name, launches=launches, wall_s=wall, ticks=records,
                profiled_ticks=profiled, traced_runs=traced_runs,
                agreement=dict(agree, answers_equal=exact), state=state,
                tagged_calls=folds.calls, sketch_calls=merges.calls,
                shape=dict(blocks=n_blocks, groups=n_groups, rows=rows))


# ---------------------------------------------------------------------------
# The mesh route: the same loop on route="mesh", its cell axis split by
# block runs over four shards on the one card, each shard launching the
# tick kernels on its own rows.
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_DEVICES = ("cuda:0",) * MESH_SHARDS
# (name, COUNT DISTINCT, float64, the device-route run of the same loop)
MESH_RUNS = (("moments mesh", False, False, "moments"),
             ("distinct mesh", True, False, "distinct"),
             ("moments f64 mesh", False, True, "moments f64"),
             ("distinct f64 mesh", True, True, "distinct f64"))
N_REGS = 4096  # HLL registers a cell: bytes a folded register row


def mesh_tick_launches(distinct: bool, f64: bool, n_shards: int,
                       drawing: bool, first: bool) -> dict:
    """What one tick of a mesh run launches: a drawing tick one launch of
    each of its tick kernels a shard (fp32: a ``fold_panes`` and, with
    COUNT DISTINCT, a ``sketch_panes`` call a shard; float64: a
    ``_segment_carry_sum`` a shard and its tagged merge), a warm tick
    nothing, and the run's cold plan one pilot launch."""
    s = n_shards if drawing else 0
    out = dict(fold_calls=0, fold_launches=0, sketch_calls=0,
               sketch_launches=0, tagged_calls=0, tagged_launches=0,
               tagged_sketch_launches=0, pilot_launches=int(first))
    if f64:
        out.update(tagged_calls=s, tagged_launches=s,
                   tagged_sketch_launches=s if distinct else 0)
    else:
        out.update(fold_calls=s, fold_launches=s,
                   sketch_calls=s if distinct else 0,
                   sketch_launches=s if distinct else 0)
    return out


def check_mesh_ticks(name: str, records, n_shards: int, distinct: bool,
                     f64: bool, n_rows: int) -> None:
    """Each tick of a mesh run against ``mesh_tick_launches``, and its
    cross-device steps: a drawing tick reduces once, the sum of its
    stack's stat rows, 9 columns a row (a sketch stack adds the max of
    its folded register rows, 4096 bytes a row), at most ``n_rows`` rows
    (the loop's keys': nothing of O(cells)); a warm tick reduces nothing
    when its stats are cached, else as a drawing tick."""
    for k, r in enumerate(records):
        drawing = r["new_samples"] > 0
        want = mesh_tick_launches(distinct, f64, n_shards, drawing, k == 0)
        got = {key: r[key] for key in want}
        check(got == want, f"the {name} run's tick {k + 1} launched {got}, "
                           f"not {want}")
        ops = r["collectives"]
        rows = ops[0][1] // 9 if ops and ops[0][0] == "sum" else 0
        reduce = [("sum", 9 * rows)] + ([("max", N_REGS * rows)]
                                        if distinct else [])
        check((0 < rows <= n_rows and ops == reduce)
              or (not drawing and ops == []),
              f"the {name} run's tick {k + 1} reduced {ops}: not one sum of "
              f"at most {n_rows} stat rows"
              + (" and one max of as many register rows" if distinct
                 else ""))


def check_mesh_state(mesh_ex, dev_ex) -> dict:
    """Every key's float64 state on the mesh route against the device
    route's after the same draws: moment rows, totals, both draw ledgers,
    register plane and partials bit for bit."""
    import numpy as np

    n_keys, cells = 0, 0
    check(set(mesh_ex._device_stores) == set(dev_ex._device_stores),
          "the mesh and device runs kept different keys")
    for skey, dst in dev_ex._device_stores.items():
        mst = mesh_ex._device_stores[skey]
        got, want = mst.to_host(), dst.to_host()
        for f in ("mom_s", "mom_l", "totals", "n_sampled"):
            check(np.array_equal(getattr(got, f), getattr(want, f)),
                  f"the mesh store {skey} differs from the device route's "
                  f"in {f}")
        check(np.array_equal(mst._n_sampled_dev.cpu().numpy(),
                             dst._n_sampled_dev.cpu().numpy()),
              f"the mesh store {skey}'s device ledger differs")
        if want.has_sketch:
            check(np.array_equal(got.regs, want.regs),
                  f"the mesh store {skey}'s register plane differs")
        check(np.array_equal(mst.partials_host(), dst.partials_host()),
              f"the mesh store {skey}'s partials differ")
        n_keys += 1
        cells += dst.n_cells
    check(n_keys > 0, "the float64 mesh run kept no device store")
    return dict(keys=n_keys, cells=cells, state_bit_identical=True,
                partials_bit_identical=True)


def main_path_mesh(name: str, distinct: bool, f64: bool, n_blocks=1000,
                   n_groups=16, rows=20000, ticks=(0.5, 0.25, 0.25)
                   ) -> dict:
    """One run of the main path on ``route="mesh"`` over ``MESH_SHARDS``
    shards on the card (the torch default dtype float64 for a float64
    run, restored after it): the launch counts and the reduce's counters
    are read around the loop and every tick is held to
    ``check_mesh_ticks``.  A float64 run is then held to a device-route
    run of the same loop, made here (``check_mesh_state``; its tick
    records are kept beside); an fp32 run's answers to the float64 host
    route, as the device route's are."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core.moment_store import MeshDeviceStack
    from repro_torch.kernels import isla_moments as K

    was = torch.get_default_dtype()
    if f64:
        torch.set_default_dtype(torch.float64)
    try:
        K.reset_launch_counts()
        calls0 = D.mesh_all_reduce.calls
        elems0 = D.mesh_all_reduce.elements
        t0 = time.perf_counter()
        done, ex, records = run_serve("cuda", "mesh", n_blocks, n_groups,
                                      rows, ticks, distinct,
                                      mesh=MESH_DEVICES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(K, k).launches
                    for k in ("isla_fold", "isla_sketch", "isla_tagged_fold",
                              "isla_sketch_tagged", "pilot_stats")}
        reduces = dict(calls=D.mesh_all_reduce.calls - calls0,
                       elements=D.mesh_all_reduce.elements - elems0)
        stacks = list(ex._device_stacks.values())
        check(stacks and all(isinstance(st, MeshDeviceStack)
                             and st.n_shards == MESH_SHARDS
                             for st in stacks),
              f"the {name} run served from {stacks}")
        # The loop's four keys: plain, WHERE, GROUP BY, WHERE + GROUP BY.
        check_mesh_ticks(name, records, MESH_SHARDS, distinct, f64,
                         2 + 2 * n_groups)
        device_ticks, state = None, None
        if f64:
            dev_done, dev_ex, device_ticks = run_serve(
                "cuda", "device", n_blocks, n_groups, rows, ticks, distinct)
            state = check_mesh_state(ex, dev_ex)
            agree = check_answers(done, dev_done, distinct)
            agree["answers_equal"] = sum(
                a.answer.value == b.answer.value
                for a, b in zip(done, dev_done))
            del dev_ex
        else:
            host_done, _, _ = run_serve("cpu", "host", n_blocks, n_groups,
                                        rows, ticks, distinct)
            agree = check_answers(done, host_done, distinct)
        del ex
    finally:
        torch.set_default_dtype(was)
    return dict(name=name, shards=MESH_SHARDS, devices=list(MESH_DEVICES),
                launches=launches, reduces=reduces, wall_s=wall,
                ticks=records, device_ticks=device_ticks, agreement=agree,
                state=state,
                shape=dict(blocks=n_blocks, groups=n_groups, rows=rows))


def tagged_bound_ms(values, seg, bounds, n_cells: int
                    ) -> "tuple[float, float]":
    """Least time for one tagged fold on this stream: every sample's value
    and id read once, the cuts read once, every resident row (11 columns)
    read and written once; against ~17 operations a sample (two
    multiplies, four compares, up to eleven adds) at the float64 (or
    fp32) rate outside the tensor cores."""
    w = values.element_size()
    in_bytes = values.numel() * (w + 4) + bounds.numel() * w
    t_bytes = (in_bytes + 2 * 11 * w * n_cells) / HBM_BYTES_PER_S * 1e3
    rate = FP64_FLOP_PER_S if w == 8 else FP32_FLOP_PER_S
    return t_bytes, 17 * values.numel() / rate * 1e3


def check_main_path_tagged(calls) -> "list[dict]":
    """Replay each tagged fold of the float64 runs on a copy of its rows,
    on both paths: the run table the tick carried (the main path) and the
    stable sort (the path of streams in any order).  On each, the kernel
    twice (identical bits) against its plain version run on the CPU over
    the same tensors, bit for bit; then the call's device time and
    events, its kernel's time, its bound and the ratio, the plain version
    on the card, and (run table) the same stream folded at fp32.  A
    run-table call must hold one run kernel and no sort kernel."""
    import torch
    from repro_torch.kernels import isla_moments as K

    out = []
    for c in calls:
        state, (values, seg, bounds) = c["args"][:3], c["args"][3:]
        runs = c["kw"].get("runs")
        check(runs is not None, "a float64 tick folded with no run table")
        table = bounds.reshape(-1, 4).contiguous()
        n = state[0].shape[0]
        t_bytes, t_ops = tagged_bound_ms(values, seg, table, n)
        bound = max(t_bytes, t_ops)

        def fold(rows, v=values, b=table, r=runs):
            K.isla_tagged_fold(v, seg, b, *rows, runs=r)

        rows = [t.to("cpu", copy=True) for t in state]
        K.isla_tagged_fold(values.cpu(), seg.cpu(), table.cpu(), *rows,
                           runs=runs._replace(table=runs.table.cpu()))
        want = torch.cat(rows, dim=1)
        row = dict(samples=values.numel(), cells=n,
                   per_cell_cuts=table.shape[0] > 1,
                   tolerance="0 (bit-identical)", bytes_ms=t_bytes,
                   ops_ms=t_ops, bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        for path, r, kernel in (("runs", runs, "isla_tagged_runs_kernel"),
                                ("sorted", None, "isla_tagged_fold_kernel")):
            def run():
                rows = [t.clone() for t in state]
                fold(rows, r=r)
                return torch.cat(rows, dim=1)

            got, again = run(), run()
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"isla_tagged_fold ({path}) is "
                                           f"not deterministic on the main "
                                           f"path")
            check(torch.equal(got.cpu(), want),
                  f"isla_tagged_fold ({path}) disagrees with its plain "
                  f"version on the main path's {values.numel()}-sample "
                  f"stream")
            scratch = [t.clone() for t in state]
            call_ms, events = kernel_events(lambda: fold(scratch, r=r),
                                            ("",))
            kern_ms = kernel_ms(lambda: fold(scratch, r=r), (kernel,))
            row[path] = dict(ms=call_ms, kernel_ms=kern_ms,
                             kernels_a_call=events,
                             over_bound=(None if call_ms is None
                                         else call_ms / bound),
                             max_abs_err=max_abs_err(got.cpu(), want))
        check(int(runs.count) == 0, "the main path's run table was found "
                                    "out of place")
        scratch = [t.clone() for t in state]
        names = [n for n, _ in window_events(lambda: fold(scratch), ("",),
                                             reps=5)]
        check(sum("isla_tagged_runs_kernel" in n for n in names) == 5
              and not any("sort" in n.lower() for n in names),
              f"five run-table folds ran {names}")
        rs, sd = row["runs"], row["sorted"]
        with PlainVersions():
            plain_ms = time_ms(lambda: fold(scratch), reps=3, warm=1)
        s32 = [t.float() for t in state]
        v32, b32 = values.float(), table.float()
        f32_ms = kernel_events(lambda: fold(s32, v32, b32), ("",))[0]
        b32_bytes, b32_ops = tagged_bound_ms(v32, seg, b32, n)
        row.update(ms=rs["ms"], kernel_ms=rs["kernel_ms"],
                   max_abs_err=max(rs["max_abs_err"], sd["max_abs_err"]),
                   call_kernels=sorted(set(names)),
                   sort_share=(None if sd["ms"] is None
                               or sd["kernel_ms"] is None
                               else 1.0 - sd["kernel_ms"] / sd["ms"]),
                   plain_ms=plain_ms, fp32_ms=f32_ms,
                   fp32_bound_ms=max(b32_bytes, b32_ops))
        out.append(row)
    return out


def check_main_path_tagged_sketches(calls) -> "list[dict]":
    """Replay each tagged register merge of the float64 distinct run on a
    copy of the plane it found: the kernel twice against its plain version
    run on the CPU over the same tensors, bit for bit, then timed from
    that plane, with the call's bound."""
    import torch
    from repro_torch.kernels import isla_moments as K

    out = []
    for c in calls:
        bits, seg, regs0 = c["args"]

        def run():
            regs = regs0.clone()
            K.isla_sketch_tagged(bits, seg, regs)
            return regs

        got, again = run(), run()
        want = regs0.to("cpu", copy=True)
        K.isla_sketch_tagged(bits.cpu(), seg.cpu(), want)
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              "isla_sketch_tagged is not deterministic on the main path")
        check(torch.equal(got.cpu(), want),
              f"isla_sketch_tagged disagrees with its plain version on the "
              f"main path's {bits.numel()}-lane stream")
        changed = int((got != regs0).sum())
        scratch = regs0.clone()
        dev_ms = kernel_ms(lambda: K.isla_sketch_tagged(bits, seg, scratch),
                           ("isla_sketch",),
                           setup=lambda: scratch.copy_(regs0))
        event_ms = time_ms(lambda: K.isla_sketch_tagged(bits, seg, scratch))
        with PlainVersions():
            plain_ms = time_ms(lambda: K.isla_sketch_tagged(bits, seg,
                                                            scratch),
                               reps=3, warm=1)
        live = int(((seg >= 0) & (seg < regs0.shape[0])).sum())
        t_bytes = (live * 12 + 2 * changed) / HBM_BYTES_PER_S * 1e3
        t_ops = SKETCH_OPS_PER_LANE * live / FP32_FLOP_PER_S * 1e3
        out.append(dict(lanes=bits.numel(), live_lanes=live,
                        changed_registers=changed,
                        max_abs_err=max_abs_err(got.cpu(), want),
                        tolerance="0 (bit-identical)",
                        ms=event_ms if dev_ms is None else dev_ms,
                        kernel_ms=dev_ms, repeat_event_ms=event_ms,
                        plain_ms=plain_ms, bytes_ms=t_bytes, ops_ms=t_ops,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations"))
    return out


TIGHT_E = 0.04  # ~166 pilot samples a block, ~166,000 in all


def tight_plan(n_blocks=1000, n_groups=16, rows=20000, seed=0) -> dict:
    """One device-route ``plan`` (no tick) on the loop's tables at a
    precision e tight enough that the pilot draws at least 100,000
    samples: its pilot size, the device pilot's seconds (host clock around
    ``pilot_stats_device``) and its launches, counted from 0."""
    import numpy as np
    import repro_torch.core as C
    import repro_torch.core.multiquery as MQ
    import torch
    from repro_torch.kernels import isla_moments as K
    from repro_torch.launch.serve import _synthetic_grouped_blocks

    samplers = _synthetic_grouped_blocks(n_blocks, n_groups, rows, seed)
    ex = C.MultiQueryExecutor(samplers, [10 ** 7] * n_blocks,
                              params=C.IslaParams(e=TIGHT_E),
                              group_domains={"region": n_groups},
                              device="cuda")
    real, spent = MQ.pilot_stats_device, []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        spent.append(time.perf_counter() - t0)
        return out

    MQ.pilot_stats_device = timed
    try:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        plan = ex.plan(serve_queries(C, TIGHT_E, False),
                       np.random.default_rng(seed + 1), route="device")
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
    finally:
        MQ.pilot_stats_device = real
    n = int(plan.pilot.pilot_size)
    check(n >= 100_000 and len(spent) == 1 and K.pilot_stats.launches == 1,
          f"the tight plan drew a pilot of {n} samples with "
          f"{len(spent)} device pilots and {K.pilot_stats.launches} "
          f"pilot_stats launches")
    check(math.isfinite(plan.pilot.sketch0) and plan.pilot.sigma > 0,
          f"the tight plan's pilot has sketch0 {plan.pilot.sketch0} and "
          f"sigma {plan.pilot.sigma}")
    return dict(e=TIGHT_E, pilot_size=n, pilot_s=spent[0], plan_s=plan_s,
                pilot_launches=K.pilot_stats.launches,
                sketch0=plan.pilot.sketch0, sigma=plan.pilot.sigma)


# ---------------------------------------------------------------------------
# The LM serving path: olmo-1b at full width, every prefill's attention
# through the hand-written flash kernel.
# ---------------------------------------------------------------------------

LM_ARCH = "olmo-1b"
LM_REQUESTS = 6
LM_SLOTS = 4
LM_MAX_NEW = 16
LM_PROMPT_LENS = (384, 2048)   # seeded prompt lengths, both ends included
LM_MAX_SEQ = 2048 + LM_MAX_NEW + 16
# Profiled ticks of the LM re-run: two decode ticks of the four first
# requests, and the tick that admits (prefills) the last two.
LM_PROFILE_TICKS = (2, 3, 16)
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 dense tensor cores
# bf16 output: one to two bf16 ulps on O(1) values; fp32: the reference
# sweep's tolerance (tests/test_kernels_flash.py).  An element is held to
# max(tolerance, one ulp of the plain value in the output type): from
# |o| = 4 one bf16 ulp (2^-5) exceeds 2e-2, and two implementations that
# sum in different fp32 orders round an element there one ulp apart now
# and then (paligemma's values reach that range), which no bf16 kernel
# can avoid.  Below |o| = 4 the floor changes nothing.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def ulp_excess(got, want, tol: float) -> dict:
    """Each element of ``got`` against max(tol, one ulp of ``want`` in its
    type): the elements beyond that (``over``), those beyond ``tol`` that
    the one-ulp floor admits (``floor_only``), the largest difference as a
    share of what its element is allowed (``worst``), and max |want|."""
    import torch

    w = want.double()
    mag = w.abs()
    ulp = torch.finfo(want.dtype).eps * torch.exp2(torch.floor(torch.log2(
        mag.clamp_min(torch.finfo(want.dtype).tiny))))
    diff = (got.double() - w).abs()
    allowed = torch.clamp(ulp, min=tol)
    return dict(over=int((diff > allowed).sum()),
                floor_only=int(((diff > tol) & (diff <= allowed)).sum()),
                worst=float((diff / allowed).max()),
                max_abs_out=float(mag.max()))


def flash_err_text(fs) -> str:
    """The replays' agreement with the plain version, summed over ``fs``."""
    return (f"max abs err {max(f['max_abs_err'] for f in fs):.3g} at max "
            f"|o| {max(f['max_abs_out'] for f in fs):.3g}, "
            f"{sum(f['floor_only'] for f in fs)} elements past "
            f"{fs[0]['tolerance']} within one ulp, worst "
            f"{max(f['worst'] for f in fs):.2f} of max(tol, 1 ulp)")


class FlashCalls:
    """Keeps the arguments of every call the LM path makes to
    ``flash_attention`` (the (B*H, S, hd) q, k, v views of one layer's
    prefill), by wrapping the name ``models.attention`` calls while
    installed, and times every ``serve_prefill`` (synchronised host
    clock)."""

    def __enter__(self):
        from repro_torch.models import attention as A
        from repro_torch.models import model as M

        self.calls, self.prefill_s, self.logits = [], [], []
        self._flash, self._prefill = A.flash_attention, M.serve_prefill
        flash, prefill = self._flash, self._prefill

        def spy_flash(q, k, v, *, groups=1):
            self.calls.append((q, k, v, groups))
            return flash(q, k, v, groups=groups)

        def spy_prefill(*args, **kw):
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(*args, **kw)
            torch.cuda.synchronize()
            self.prefill_s.append(time.perf_counter() - t0)
            self.logits.append(logits)
            return logits, cache

        A.flash_attention, M.serve_prefill = spy_flash, spy_prefill
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        from repro_torch.models import model as M

        A.flash_attention, M.serve_prefill = self._flash, self._prefill
        return False


def flash_bound_ms(bh: int, bkv: int, s: int, hd: int, dtype
                   ) -> "tuple[float, float]":
    """Least time for one causal flash call: q, k, v read once and the
    output written once, against the 4 * hd flops of each (query, key <=
    query) pair of this call — S(S+1)/2 pairs a head — at the peak for the
    inputs' type (bf16 tensor cores; fp32 outside them).  The softmax's
    exponentials are not counted.  Returns (bytes ms, operations ms)."""
    import torch

    size = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (2 * bh + 2 * bkv) * s * hd * size / HBM_BYTES_PER_S * 1e3
    flops = 4.0 * bh * hd * s * (s + 1) / 2
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return t_bytes, flops / peak * 1e3


def check_flash(q, k, v, groups: int, reps: int = 10) -> dict:
    """The kernel (twice: identical bits) against its plain version on the
    same card tensors, then the kernel, the plain version and PyTorch's
    ``scaled_dot_product_attention`` (the library yardstick, used nowhere
    in the port) timed on them, with the call's bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    bh, s, hd = q.shape
    dt = str(q.dtype).replace("torch.", "")
    got = FA.flash_attention(q, k, v, groups=groups)
    again = FA.flash_attention(q, k, v, groups=groups)
    with PlainVersions():
        want = FA.flash_attention(q, k, v, groups=groups)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "flash_attention is not deterministic")
    err = max_abs_err(got, want)
    ulp = ulp_excess(got, want, FLASH_TOL[dt])
    check(ulp["over"] == 0, f"flash_attention disagrees with its plain "
                            f"version at {tuple(q.shape)} {dt}, groups "
                            f"{groups}: {ulp['over']} elements off by more "
                            f"than max({FLASH_TOL[dt]}, one ulp); max abs "
                            f"err {err:.3g}, max |o| "
                            f"{ulp['max_abs_out']:.3g}")
    ms = time_ms(lambda: FA.flash_attention(q, k, v, groups=groups),
                 reps=reps, warm=2)
    with PlainVersions():
        plain_ms = time_ms(lambda: FA.flash_attention(q, k, v, groups=groups),
                           reps=3, warm=1)
    q4, k4, v4 = (t[None] for t in (q, k, v))
    gqa = {"enable_gqa": True} if groups > 1 else {}
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, **gqa), reps=reps, warm=2)
    t_bytes, t_ops = flash_bound_ms(bh, k.shape[0], s, hd, q.dtype)
    return dict(shape=[bh, s, hd], kv_heads=k.shape[0], groups=groups,
                dtype=dt, max_abs_err=err, tolerance=FLASH_TOL[dt],
                floor_only=ulp["floor_only"], worst=ulp["worst"],
                max_abs_out=ulp["max_abs_out"], ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bytes_ms=t_bytes,
                ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_flash_synthetic(device) -> "list[dict]":
    """The kernel off the two LM paths: GQA (4 q heads per KV head), MQA
    (8 q heads of 256 over one KV head, paligemma's layout), fp32 inputs
    (the CUDA-core body), and each head_dim it takes, at ragged prefill
    lengths."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    cases = [("gqa", 32, 4, 1000, 128, torch.bfloat16),
             ("mqa", 16, 8, 1000, 256, torch.bfloat16),
             ("fp32", 16, 1, 777, 128, torch.float32),
             ("hd256_fp32", 16, 1, 777, 256, torch.float32),
             ("hd32", 16, 1, 1000, 32, torch.bfloat16),
             ("hd64", 16, 1, 1000, 64, torch.bfloat16),
             ("hd128", 16, 1, 1000, 128, torch.bfloat16),
             ("hd256", 16, 1, 1000, 256, torch.bfloat16)]
    out = []
    for name, bh, groups, s, hd, dtype in cases:
        def t(heads, scale):
            return torch.as_tensor(rng.normal(size=(heads, s, hd)) * scale,
                                   dtype=dtype, device=device)
        q, k, v = t(bh, 0.3), t(bh // groups, 0.3), t(bh // groups, 1.0)
        out.append(dict(check_flash(q, k, v, groups), name=name))
    return out


def check_lm_small(device) -> dict:
    """The slice on a small input against the same weights on the CPU
    (the kernels' plain versions): reduced olmo-1b with fp32 params, one
    prefill of 100 tokens (logits rel/abs 1e-4) and 4 decode steps
    (1e-3: an entry of the bf16 cache may round one ulp apart between the
    card's and the CPU's fp32 projections)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM

    cfg = get_config(LM_ARCH, reduced=True).replace(param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k_: to(v_, dev) for k_, v_ in tree.items()}
        if isinstance(tree, list):
            return [to(v_, dev) for v_ in tree]
        return tree.to(dev)

    toks = np.random.default_rng(12).integers(0, cfg.vocab, (1, 104))
    logits = {}
    for dev in ("cpu", device):
        p = to(params, dev)
        cache = TM.init_cache(cfg, 1, 104, device=dev)
        t = torch.as_tensor(toks, device=dev)
        out = [TM.serve_prefill(cfg, p, {"tokens": t[:, :100]}, cache)[0]]
        for i in range(100, 104):
            pos = torch.full((1,), i, device=dev)
            out.append(TM.serve_decode(cfg, p, t[:, i:i + 1], pos,
                                       cache)[0])
        logits[str(dev)] = [o.float().cpu() for o in out]
    errs = []
    for k_, (c, g) in enumerate(zip(logits["cpu"], logits[str(device)])):
        tol = 1e-4 if k_ == 0 else 1e-3
        check(bool(torch.isfinite(g).all()), "non-finite small-model logits")
        bad = (g - c).abs() > tol + tol * c.abs()
        check(not bool(bad.any()), f"the small model's step {k_} logits on "
                                   f"the card disagree with the CPU's")
        errs.append(float((g - c).abs().max()))
    return dict(arch=f"{LM_ARCH} (reduced, fp32 params)", prefill_tokens=100,
                decode_steps=4, max_abs_err=errs,
                tolerance="1e-4 prefill, 1e-3 decode (rel + abs)")


def lm_path(seed: int = 0) -> dict:
    """The LM main path: olmo-1b at full width and depth in bf16 from a
    seeded generator on the card, ``LM_REQUESTS`` seeded prompts through a
    ``BatchScheduler`` of ``LM_SLOTS`` slots until drained.  The launch
    counts are set to 0 just before the scheduler runs and read just
    after: ``flash_attention`` must have launched once per layer of every
    prefill, and no ISLA kernel.  Every call's q, k, v are kept for the
    replays."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K
    from repro_torch.models import model as TM
    from repro_torch.serve import BatchScheduler, Request

    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed + 1)
    lo, hi = LM_PROMPT_LENS
    lens = [int(n) for n in rng.integers(lo, hi + 1, LM_REQUESTS)]
    check(any(n % 64 for n in lens), "no prompt length off the 64-row tile")
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in lens]

    def scheduler():
        sched = BatchScheduler(cfg, params, batch_slots=LM_SLOTS,
                               max_seq=LM_MAX_SEQ, eos_id=-1)
        for rid, prompt in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=prompt,
                                 max_new=LM_MAX_NEW))
        return sched

    sched = scheduler()
    K.reset_launch_counts()
    with FlashCalls() as spy:
        t0 = time.perf_counter()
        done = sched.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(flash_attention=FA.flash_attention.launches,
                    isla_fold=K.isla_fold.launches,
                    pilot_stats=K.pilot_stats.launches,
                    isla_sketch=K.isla_sketch.launches)
    admitted = len(spy.prefill_s)
    check(admitted == LM_REQUESTS and len(done) == LM_REQUESTS,
          f"{len(done)} of {LM_REQUESTS} requests served")
    check(launches["flash_attention"] == admitted * cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times, "
          f"not once per layer of {admitted} prefills "
          f"({admitted * cfg.n_layers})")
    check(launches["isla_fold"] + launches["pilot_stats"]
          + launches["isla_sketch"] == 0, "the LM path ran an ISLA kernel")
    for r in done:
        check(len(r.generated) == LM_MAX_NEW + 1 and all(
            0 <= t < cfg.padded_vocab for t in r.generated),
              f"request {r.rid} generated {r.generated}")
    for lg in spy.logits:
        check(tuple(lg.shape) == (1, 1, cfg.padded_vocab)
              and bool(torch.isfinite(lg).all()),
              "prefill logits are not finite (1, 1, V)")
    prefill_s = sum(spy.prefill_s)
    decode_s = wall - prefill_s
    new_tokens = sum(len(r.generated) for r in done)
    decoded = new_tokens - admitted  # one token of each comes from prefill
    # Where the time goes, after the counts were read: a re-run of the same
    # traffic tick by tick (host clock, synchronised: the ticks that admit
    # carry their prefills), then a second one with LM_PROFILE_TICKS under
    # the profiler (device time by kernel and host time by operator; the
    # profiler inflates the host side, so those ticks' wall times come from
    # the first re-run).
    tick_s, _ = drive(scheduler())
    _, profiled = drive(scheduler(), LM_PROFILE_TICKS)
    return dict(arch=LM_ARCH, n_params=n_params, init_s=init_s,
                prompt_lens=lens, slots=LM_SLOTS, max_new=LM_MAX_NEW,
                max_seq=LM_MAX_SEQ, launches=launches, wall_s=wall,
                prefill_s=prefill_s, prefill_each_s=spy.prefill_s,
                decode_s=decode_s, new_tokens=new_tokens,
                tokens_per_s=new_tokens / wall,
                prefill_tokens_per_s=sum(lens) / prefill_s,
                decode_tokens_per_s=decoded / decode_s,
                finish_order=[r.rid for r in done], rerun_tick_s=tick_s,
                profiled_ticks=[dict(p, wall_s=tick_s[p["tick"]])
                                for p in profiled],
                calls=spy.calls)


# ---------------------------------------------------------------------------
# The VLM path: paligemma-3b at full width, its prefix prefill at head_dim
# 256 over one KV head through the flash kernel, then greedy decode.
# ---------------------------------------------------------------------------

VLM_ARCH = "paligemma-3b"
# (batch, prompt tokens) after the 256 patch rows: S = 1023 and 2047,
# neither a multiple of the 64-row tile.
VLM_BATCHES = ((2, 767), (1, 1791))
VLM_DECODE_STEPS = 8


def vlm_path(seed: int = 0) -> dict:
    """paligemma-3b at full width and depth in bf16 from a seeded generator
    on the card, served as the reference serves a frontend config (its
    slot scheduler cannot): for each of ``VLM_BATCHES``, ``serve_prefill``
    of seeded patch embeddings and tokens into a bf16 cache of S + 8 rows,
    then ``VLM_DECODE_STEPS`` greedy ``serve_decode`` steps (synchronised
    host clock each, the argmax included).  The launch counts are set to 0
    just before the first prefill and read just after the last step:
    ``flash_attention`` must have launched once per layer of each prefill,
    and no ISLA kernel.  Every flash call's q, k, v are kept for the
    replays."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K
    from repro_torch.models import model as TM
    from repro_torch.models.frontends import synth_frontend_embeds

    cfg = get_config(VLM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = TM.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed + 2)
    inputs = [(synth_frontend_embeds(cfg, b, gen), torch.as_tensor(
        rng.integers(0, cfg.vocab, (b, n)), device="cuda"))
        for b, n in VLM_BATCHES]
    seqs = [cfg.frontend_len + n for _, n in VLM_BATCHES]
    check(all(s % 64 for s in seqs), "a VLM prefill length on the 64-row "
                                     "tile")
    steps_s, generated = [], []
    K.reset_launch_counts()
    with FlashCalls() as spy:
        for (prefix, toks), s in zip(inputs, seqs):
            b = toks.shape[0]
            cache = TM.init_cache(cfg, b, s + VLM_DECODE_STEPS,
                                  device="cuda")
            logits, cache = TM.serve_prefill(
                cfg, params, {"tokens": toks, "prefix_embeds": prefix},
                cache)
            check(tuple(logits.shape) == (b, 1, cfg.padded_vocab)
                  and bool(torch.isfinite(logits).all()),
                  f"paligemma prefill logits are not finite ({b}, 1, V)")
            tok = torch.argmax(logits[:, -1, :].float(), dim=-1)[:, None]
            gen_toks, walls = [tok], []
            for i in range(VLM_DECODE_STEPS):
                pos = torch.full((b,), s + i, dtype=torch.int64,
                                 device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = TM.serve_decode(cfg, params, tok, pos,
                                                cache)
                tok = torch.argmax(logits[:, -1, :].float(), dim=-1)[:, None]
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                check(bool(torch.isfinite(logits).all()),
                      f"paligemma decode step {i} logits are not finite")
                gen_toks.append(tok)
            steps_s.append(walls)
            generated.append(torch.cat(gen_toks, dim=1).tolist())
        torch.cuda.synchronize()
    launches = dict(flash_attention=FA.flash_attention.launches,
                    isla_fold=K.isla_fold.launches,
                    pilot_stats=K.pilot_stats.launches,
                    isla_sketch=K.isla_sketch.launches)
    n_prefills = len(VLM_BATCHES)
    check(len(spy.prefill_s) == n_prefills, "a VLM prefill was not run")
    check(launches["flash_attention"] == n_prefills * cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times "
          f"on the VLM path, not once per layer of {n_prefills} prefills "
          f"({n_prefills * cfg.n_layers})")
    check(launches["isla_fold"] + launches["pilot_stats"]
          + launches["isla_sketch"] == 0, "the VLM path ran an ISLA kernel")
    for q, k, v, g in spy.calls:
        check(q.shape[-1] == cfg.head_dim and g == cfg.n_heads
              // cfg.n_kv_heads, f"a VLM flash call at {tuple(q.shape)}, "
                                  f"groups {g}")
    for toks in generated:
        check(all(0 <= t < cfg.padded_vocab for row in toks for t in row),
              f"paligemma generated {toks}")
    return dict(arch=VLM_ARCH, n_params=n_params, init_s=init_s,
                batches=[dict(batch=b, prompt_tokens=n, seq=s)
                         for (b, n), s in zip(VLM_BATCHES, seqs)],
                launches=launches, prefill_s=spy.prefill_s,
                decode_step_s=steps_s, generated=generated,
                calls=spy.calls)


def ptxas_figures(log: str) -> dict:
    """Each function's registers, spill bytes and static shared memory
    from a ``-Xptxas -v`` log."""
    figs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            figs[cur] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            figs[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            figs[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            figs[cur]["smem_bytes"] = int(m.group(1)) if m else 0
    return figs


def isla_ptxas(log: str) -> dict:
    """The ISLA kernels' ``-Xptxas -v`` figures by readable name
    (``isla_fold_kernel<float>``, ``isla_sketch_kernel``, ...)."""
    out = {}
    for fn, fig in ptxas_figures(log).items():
        for k in ISLA_KERNELS:
            if k in fn:
                t = ("<bf16>" if "bfloat16" in fn else
                     "<float>" if k == "isla_fold_kernel" or "IfE" in fn
                     else "<double>" if "IdE" in fn else
                     "<one_warp>" if "ILb1E" in fn else
                     "<grid>" if "ILb0E" in fn else "")
                out[k + t] = fig
    return out


FLASH_FN = re.compile(r"(flash_fwd_[a-z0-9]+)ILi(\d+)E")


def flash_sass() -> dict:
    """Per instantiation of the flash kernels (``flash_fwd_mma<hd>``, the
    bf16 tensor-core body; ``flash_fwd_f32<hd>``): its count of tensor-core
    (HMMA, HGMMA), fp32 FMA, ldmatrix (LDSM) and cp.async (LDGSTS)
    instructions in the built library's SASS (``cuobjdump -sass``)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K

    tool = Path(K.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass",
                          str(K._library_path(FA.SOURCE))],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    counts = {}
    for chunk in out.split("Function : ")[1:]:
        m = FLASH_FN.search(chunk.split("\n", 1)[0])
        if m:
            counts[f"{m.group(1)}<{m.group(2)}>"] = {
                op: len(re.findall(rf"\b{op}\b", chunk))
                for op in ("HMMA", "HGMMA", "FFMA", "LDSM", "LDGSTS")}
    return counts


def drive(sched, profile_ticks=()):
    """Run a scheduler to the end one tick at a time, synchronised; the
    ticks in ``profile_ticks`` (0-based) under the profiler.  Returns the
    ticks' wall seconds and, for each profiled tick, its device seconds by
    kernel and its top host operators."""
    import torch

    walls, profiled = [], []
    while sched.queue or any(x is not None for x in sched.slots):
        k = len(walls)
        with profile_tick("cuda", k in profile_ticks) as prof:
            t0 = time.perf_counter()
            active = sched.tick()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if k in profile_ticks:
            kernels_s = device_kernel_seconds(prof)
            profiled.append(dict(
                tick=k, active=active,
                device_s=sum(kernels_s.values()),
                kernels_s=dict(sorted(kernels_s.items(),
                                      key=lambda kv: -kv[1])[:8]),
                host_ops_s=host_op_seconds(prof, top=8)))
    return walls, profiled


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import isla_moments as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    logs = K.build()
    for src in K.SOURCES:
        K.library(src)
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s ({len(logs)} source(s) compiled)")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    from repro_torch.kernels import flash_attention as FA
    ptxas = {}
    if FA.SOURCE in logs:
        for fn, fig in ptxas_figures(logs[FA.SOURCE]).items():
            m = FLASH_FN.search(fn)
            if m:
                ptxas[f"{m.group(1)}<{m.group(2)}>"] = fig
        check(len(ptxas) == 8 and all(
            f.get("spill_bytes") == 0 for f in ptxas.values()),
              f"flash_attention.cu: a kernel spills or is missing: {ptxas}")
        print("flash_attention.cu -Xptxas -v: " + ", ".join(
            f"{n} {f['registers']} regs" for n, f in sorted(ptxas.items()))
              + "; no spills")
    else:
        print("flash_attention.cu was built before this run: its ptxas "
              "figures are not checked")
    islaptx = {}
    if K.SOURCES[0] in logs:
        islaptx = isla_ptxas(logs[K.SOURCES[0]])
        check(len(islaptx) == 10 and all(
            f.get("spill_bytes", 0) == 0 for n, f in islaptx.items()
            if n.startswith("isla_tagged_runs")),
              f"isla_kernels.cu: a kernel is missing from the ptxas log or "
              f"the run kernel spills: {islaptx}")
        print("isla_kernels.cu -Xptxas -v: " + "; ".join(
            f"{n} {f['registers']} regs, {f['smem_bytes']} B static smem, "
            f"{f.get('spill_bytes', 0)} B spilled"
            for n, f in sorted(islaptx.items())))
    else:
        print("isla_kernels.cu was built before this run: its ptxas "
              "figures are not printed")
    sass = flash_sass()
    check(len(sass) == 8 and all(
        c["HMMA"] + c["HGMMA"] > 0
        for n, c in sass.items() if n.startswith("flash_fwd_mma")),
          f"a bf16 flash kernel runs no tensor-core instruction: {sass}")
    print("flash_attention SASS (cuobjdump): " + ", ".join(
        f"{n} HMMA {c['HMMA']} HGMMA {c['HGMMA']} FFMA {c['FFMA']}"
        for n, c in sorted(sass.items())))

    phase_s = {"build": build_s}
    stamp = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - stamp[0]
        stamp[0] = now

    runs = [main_path(name, distinct) for name, distinct in MAIN_RUNS]
    lap("isla main path runs")
    for path in runs:
        rp = path["phase2"]
        print(f"main path, {path['name']} run: "
              f"{json.dumps(path['launches'])} launches, "
              f"{path['agreement']}, {path['wall_s']:.2f} s; partials: "
              f"{rp['differ_from_cpu']} of {rp['cells']} differ from Phase 2 "
              f"on the CPU over the card's state (max "
              f"{rp['max_ulps_from_cpu']:g} fp32 ulp), the division repair "
              f"moved {rp['moved_by_repair']}; profiled re-runs taken "
              f"{path['traced_runs']}")
        for k, (r, q) in enumerate(zip(path["ticks"],
                                       path["profiled_ticks"])):
            stages = ", ".join(f"{n} {t:.4f}"
                               for n, t in r["stages_s"].items())
            busy = q["device_busy_s"]
            print(f"  tick {k + 1} (e={r['e']}): {r['new_samples']} new "
                  f"samples, {r['fold_calls']} fold_panes / "
                  f"{r['sketch_calls']} sketch_panes calls, "
                  f"{r['fold_launches']} fold / "
                  f"{r['sketch_launches']} sketch launches, stages s: "
                  f"{stages}"
                  + ("" if busy is None else
                     f"; profiled re-run: device busy {busy * 1e3:.3f} ms "
                     f"of {q['wall_s']:.3f} s wall")
                  + ("" if q["kernel_events"] is None else
                     f", ISLA kernels {json.dumps(q['kernel_events'])}"))
    dev = torch.device("cuda")
    served = []
    for path in runs:
        for f in check_main_path_folds(path.pop("fold_calls")):
            served.append(dict(f, run=path["name"]))
    check(len(served) > 0, "the main path folded no pane")
    for f in served:
        print(f"isla_fold on the {f['run']} run's pane {tuple(f['pane'])} "
              f"({f['keys']} keys, {f['real_samples']} samples): "
              f"{f['ms']:.4f} ms on the card (CUDA events "
              f"{f['event_ms']:.4f} ms; plain {f['plain_ms']:.3f} ms, bound "
              f"{f['bound_ms']:.4f} ms by {f['bound_by']}), max abs err "
              f"{f['max_abs_err']:.3g}, max rel err {f['max_rel_err']:.3g} "
              f"(tol rel 1e-5), one launch, "
              f"{f['dynamic_smem_bytes']} B of staged row a block")
    merged = []
    for path in runs:
        for f in check_main_path_sketches(path.pop("sketch_calls")):
            merged.append(dict(f, run=path["name"]))
    check(len(merged) > 0, "the main path merged no hash pane")
    for f in merged:
        print(f"isla_sketch on the {f['run']} run's hash pane "
              f"{tuple(f['pane'])} ({f['keys']} keys, {f['live_lanes']} "
              f"live lanes, {f['touched_cells']} cells changed): "
              f"{f['ms']:.4f} ms on the card from the tick's plane (a "
              f"repeat on the merged plane {f['repeat_event_ms']:.4f} ms "
              f"by CUDA events; plain {f['plain_ms']:.3f} ms over "
              f"{f['plain_reps']} reps, bound {f['bound_ms']:.4f} ms by "
              f"{f['bound_by']}), bit-identical to its plain version")
    lap("isla main path replays")
    f64_runs = [main_path_f64(name, distinct)
                for name, distinct in F64_RUNS]
    lap("isla float64 runs")
    for path, fp32 in zip(f64_runs, runs):
        st = path["state"]
        print(f"main path, {path['name']} run: "
              f"{json.dumps(path['launches'])} launches, "
              f"{path['agreement']}, {path['wall_s']:.2f} s; "
              f"{st['keys']} keys, {st['cells']} cells: moment rows, "
              f"totals, draw ledger"
              + (" and register planes" if path["name"].startswith("dist")
                 else "")
              + " bit-identical to the host route's; partials: "
              f"{st['partials_differing_from_host_solve']} differ from the "
              f"host solve (max {st['max_ulps_from_host_solve']:g} ulp), "
              f"{st['phase2']['differ_from_cpu']} from Phase 2 on the CPU "
              f"over the card's state; the division repair moved "
              f"{st['phase2']['moved_by_repair']} of {st['cells']}; "
              f"profiled re-runs taken {path['traced_runs']}")
        for k, (r, q) in enumerate(zip(path["ticks"], fp32["ticks"])):
            stages = ", ".join(f"{n} {t:.4f}"
                               for n, t in r["stages_s"].items())
            print(f"  tick {k + 1} (e={r['e']}): {r['new_samples']} new "
                  f"samples, {r['tagged_calls']} tagged folds, "
                  f"{r['tagged_launches']} isla_tagged_fold / "
                  f"{r['tagged_sketch_launches']} isla_sketch_tagged "
                  f"launches, stages s: {stages}; run tables "
                  f"{r['run_table_host_s'] * 1e3:.3f} ms of host time; "
                  f"fp32 run's tick {q['wall_s']:.4f} s wall (h2d "
                  f"{q['stages_s'].get('h2d', 0.0):.4f}), this tick "
                  f"{r['wall_s']:.4f} s; profiled re-run: ISLA kernels "
                  f"{json.dumps(path['profiled_ticks'][k]['kernel_events'])}")
    tagged = []
    for path in f64_runs:
        for f in check_main_path_tagged(path.pop("tagged_calls")):
            tagged.append(dict(f, run=path["name"]))
    check(len(tagged) > 0, "the float64 runs folded no tagged stream")
    for f in tagged:
        rs, sd = f["runs"], f["sorted"]
        print(f"isla_tagged_fold on the {f['run']} run's stream "
              f"({f['samples']} samples, {f['cells']} cells"
              + (", per-cell cuts" if f["per_cell_cuts"] else "") + "), "
              f"bound {f['bound_ms']:.4f} ms by {f['bound_by']}: run table "
              f"{rs['ms']:.4f} ms a call ({rs['kernels_a_call']:g} device "
              f"events, the run kernel {rs['kernel_ms']:.4f} ms, "
              f"{rs['over_bound']:.1f}x the bound); stable sort "
              f"{sd['ms']:.4f} ms ({sd['kernels_a_call']:g} events, the fold "
              f"kernel {sd['kernel_ms']:.4f} ms, the sort's share "
              f"{f['sort_share']:.2f}, {sd['over_bound']:.1f}x); fp32 by the "
              f"run table {f['fp32_ms']:.4f} ms (bound "
              f"{f['fp32_bound_ms']:.4f}); plain {f['plain_ms']:.3f} ms; "
              f"both paths bit-identical to the plain version on the CPU, "
              f"two runs identical")
    tagged_merges = []
    for path in f64_runs:
        for f in check_main_path_tagged_sketches(path.pop("sketch_calls")):
            tagged_merges.append(dict(f, run=path["name"]))
    check(len(tagged_merges) > 0,
          "the float64 distinct run merged no tagged lane stream")
    for f in tagged_merges:
        print(f"isla_sketch_tagged on the {f['run']} run's stream "
              f"({f['lanes']} lanes, {f['changed_registers']} registers "
              f"raised): {f['ms']:.4f} ms on the card from the tick's plane "
              + ("(profiler" if f["kernel_ms"] is not None
                 else "(the profiler saw no event: CUDA events")
              + f"; a repeat on the merged plane {f['repeat_event_ms']:.4f} "
              f"ms by CUDA events; "
              f"plain {f['plain_ms']:.3f} ms, bound {f['bound_ms']:.4f} ms "
              f"by {f['bound_by']}), bit-identical to its plain version on "
              f"the CPU")
    lap("isla float64 replays")
    folds = [check_fold(dev, 1000, q) for q in (64, 4096)]
    for f in folds:
        print(f"isla_fold synthetic quota {f['quota']}: {f['ms']:.4f} ms "
              f"in one launch ({f['per_key_ms']:.4f} ms as a launch per "
              f"key; plain {f['plain_ms']:.3f} ms, bound "
              f"{f['bound_ms']:.4f} ms by {f['bound_by']}), max abs err "
              f"{f['max_abs_err']:.3g}, max rel err {f['max_rel_err']:.3g} "
              f"(tol rel 1e-5)")
    batched = check_batched(dev)
    print(f"isla_moments_batched stride {batched['stride']} per-cell cuts: "
          f"{batched['ms']:.4f} ms (plain {batched['plain_ms']:.3f} ms, "
          f"bound {batched['bound_ms']:.4f} ms), "
          f"max rel err {batched['max_rel_err']:.3g} (tol rel 1e-5)")
    wrappers = check_wrappers(dev)
    for w in wrappers:
        print(f"wrapper {w['name']} {tuple(w['shape'])}: {w['ms']:.4f} ms "
              f"(plain {w['plain_ms']:.3f} ms, bound {w['bound_ms']:.4f} "
              f"ms by bytes), max rel err {w['max_rel_err']:.3g} "
              f"({w['tolerance']})")
    pilots = check_pilot(dev, runs[0]["pilot_size"])
    pilot = pilots[0]  # the loop's own pilot size
    for r in pilots:
        h = r["host_ms"]
        print(f"pilot_stats n={r['n']}: {r['ms']:.4f} ms on the card as "
              f"after the upload, {r['cold_ms']:.4f} ms with L2 flushed "
              f"by a 64 MB read "
              f"(profiler; CUDA events {r['event_ms']:.4f} ms), "
              f"{r['launches_per_call']:g} launch a call, bound "
              f"{r['bound_ms']:.6f} ms by {r['bound_by']}"
              + (f", the card's smallest launch (one-element fill_) "
                 f"{r['smallest_launch_ms']:.4f} ms"
                 if "smallest_launch_ms" in r else "")
              + f"; plain {r['plain_ms']:.4f} ms, torch.std_mean + "
              f"torch.min {r['std_mean_min_ms']:.4f} ms; max rel err "
              f"{r['max_rel_err']:.3g} ({r['tolerance']}), two runs "
              f"identical")
        print(f"  pilot_stats_device n={r['n']}: {h['whole']:.4f} ms of "
              f"host time (stages one by one: scale {h['scale']:.4f}, "
              f"upload {h['upload']:.4f}, launch {h['launch']:.4f}, "
              f"readback {h['readback']:.4f} ms)")
    tight = tight_plan()
    print(f"tight device-route plan (e={tight['e']}): pilot of "
          f"{tight['pilot_size']} samples in {tight['pilot_s']:.4f} s, "
          f"plan {tight['plan_s']:.4f} s, {tight['pilot_launches']} "
          f"pilot_stats launch")

    lap("isla synthetic checks")
    mesh_runs = [main_path_mesh(name, distinct, f64)
                 for name, distinct, f64, _ in MESH_RUNS]
    lap("isla mesh runs")
    device_runs = {p["name"]: p for p in runs + f64_runs}
    for path, (_, _, _, dev_name) in zip(mesh_runs, MESH_RUNS):
        st = path["state"]
        print(f"mesh path, {path['name']} run ({path['shards']} shards on "
              f"{path['devices'][0]}): {json.dumps(path['launches'])} "
              f"launches, {path['reduces']['calls']} reduces of "
              f"{path['reduces']['elements']} elements in all, "
              f"{path['agreement']}, {path['wall_s']:.2f} s"
              + ("" if st is None else
                 f"; {st['keys']} keys, {st['cells']} cells: state, ledgers"
                 f", register planes and partials bit-identical to the "
                 f"device route's"))
        dev_ticks = path["device_ticks"] or device_runs[dev_name]["ticks"]
        for k, (r, q) in enumerate(zip(path["ticks"], dev_ticks)):
            stages = ", ".join(f"{n} {t:.4f}"
                               for n, t in r["stages_s"].items())
            dev_stages = ", ".join(f"{n} {t:.4f}"
                                   for n, t in q["stages_s"].items())
            print(f"  tick {k + 1} (e={r['e']}): {r['new_samples']} new "
                  f"samples, reduces {r['collectives']}, "
                  f"{r['fold_launches']} isla_fold / {r['sketch_launches']} "
                  f"isla_sketch / {r['tagged_launches']} isla_tagged_fold / "
                  f"{r['tagged_sketch_launches']} isla_sketch_tagged "
                  f"launches; wall {r['wall_s']:.4f} s, stages s: {stages}; "
                  f"device route ({dev_name} run) wall {q['wall_s']:.4f} s, "
                  f"stages s: {dev_stages}")
    lm = lm_path()
    lap("lm path runs")
    print(f"LM path, {lm['arch']} at full width and depth "
          f"({lm['n_params'] / 1e9:.3f} B params, bf16, init "
          f"{lm['init_s']:.2f} s): {LM_REQUESTS} requests, prompt lengths "
          f"{lm['prompt_lens']}, {LM_SLOTS} slots, max_new {LM_MAX_NEW}: "
          f"{json.dumps(lm['launches'])} launches")
    print(f"  prefill {lm['prefill_s']:.3f} s "
          f"({lm['prefill_tokens_per_s']:.0f} prompt tok/s), decode "
          f"{lm['decode_s']:.3f} s ({lm['decode_tokens_per_s']:.1f} tok/s), "
          f"{lm['new_tokens']} new tokens in {lm['wall_s']:.3f} s = "
          f"{lm['tokens_per_s']:.1f} tok/s")
    ticks = lm["rerun_tick_s"]
    print(f"  re-run tick by tick: {len(ticks)} ticks, first "
          f"{ticks[0]:.3f} s, median {sorted(ticks)[len(ticks) // 2]:.4f} "
          f"s, sum {sum(ticks):.3f} s")
    for p in lm["profiled_ticks"]:
        top = list(p["kernels_s"].items())[:3]
        print(f"  tick {p['tick']} ({p['active']} slots): device busy "
              f"{p['device_s'] * 1e3:.2f} ms of {p['wall_s'] * 1e3:.2f} ms "
              f"wall (profiled re-run); top kernels "
              + ", ".join(f"{n[:48]} {t * 1e3:.2f} ms" for n, t in top))
    calls = lm.pop("calls")
    flash = [check_flash(q, k, v, g) for q, k, v, g in calls]
    del calls
    n_layers = len(flash) // len(lm["prompt_lens"])
    for i, s_len in enumerate(lm["prompt_lens"]):
        layer = flash[i * n_layers:(i + 1) * n_layers]
        print(f"flash_attention on prefill {i} (S={s_len}, "
              f"{tuple(layer[0]['shape'])}, {n_layers} layers): "
              f"{sum(f['ms'] for f in layer):.3f} ms (plain "
              f"{sum(f['plain_ms'] for f in layer):.3f} ms, SDPA "
              f"{sum(f['library_ms'] for f in layer):.3f} ms, bound "
              f"{sum(f['bound_ms'] for f in layer):.4f} ms by "
              f"{layer[0]['bound_by']}); a call "
              f"{sum(f['ms'] for f in layer) / n_layers:.4f} ms (SDPA "
              f"{sum(f['library_ms'] for f in layer) / n_layers:.4f}, bound "
              f"{layer[0]['bound_ms']:.4f}); " + flash_err_text(layer))
    lap("lm path replays")
    synth = check_flash_synthetic(dev)
    for f in synth:
        print(f"flash_attention synthetic {f['name']} {tuple(f['shape'])} "
              f"groups {f['groups']} {f['dtype']}: {f['ms']:.4f} ms (plain "
              f"{f['plain_ms']:.3f} ms, SDPA {f['library_ms']:.4f} ms, bound "
              f"{f['bound_ms']:.4f} ms by {f['bound_by']}); "
              + flash_err_text([f]))
    small = check_lm_small(dev)
    print(f"LM small-input check, {small['arch']}: card vs CPU logits max "
          f"abs err {max(small['max_abs_err']):.3g} ({small['tolerance']})")
    lap("lm synthetic checks")
    vlm = vlm_path()
    lap("vlm path runs")
    print(f"VLM path, {vlm['arch']} at full width and depth "
          f"({vlm['n_params']} params, bf16, init {vlm['init_s']:.2f} s): "
          f"{json.dumps(vlm['launches'])} launches")
    vcalls = vlm.pop("calls")
    vflash = [check_flash(q, k, v, g) for q, k, v, g in vcalls]
    del vcalls
    v_layers = len(vflash) // len(vlm["batches"])
    for i, bt in enumerate(vlm["batches"]):
        layer = vflash[i * v_layers:(i + 1) * v_layers]
        steps = vlm["decode_step_s"][i]
        n = len(layer)
        print(f"  batch {bt['batch']} x ({bt['prompt_tokens']} tokens + "
              f"256 patches, S={bt['seq']}): prefill "
              f"{vlm['prefill_s'][i]:.4f} s, decode steps "
              f"{', '.join(f'{t:.4f}' for t in steps)} s (median "
              f"{sorted(steps)[len(steps) // 2]:.4f})")
        print(f"  flash_attention per call at {tuple(layer[0]['shape'])} "
              f"over {layer[0]['kv_heads']} KV heads (groups "
              f"{layer[0]['groups']}), {n} layers: "
              f"{sum(f['ms'] for f in layer) / n:.4f} ms (min "
              f"{min(f['ms'] for f in layer):.4f}, max "
              f"{max(f['ms'] for f in layer):.4f}), bound "
              f"{layer[0]['bound_ms']:.4f} ms by {layer[0]['bound_by']}, "
              f"plain {sum(f['plain_ms'] for f in layer) / n:.3f} ms, SDPA "
              f"{sum(f['library_ms'] for f in layer) / n:.4f} ms; "
              + flash_err_text(layer))
    lap("vlm path replays")
    print("phase seconds: " + ", ".join(f"{n} {t:.1f}"
                                         for n, t in phase_s.items()))

    # Each kernel's entry sums the main path's own calls (every drawing
    # tick's launches in both ISLA runs, replayed on their panes; every
    # prefill layer's attention in the olmo-1b and paligemma-3b runs,
    # replayed on its q, k, v); its launches are the runs' counts added,
    # the mesh runs' included.
    def launched(kernel):
        return sum(path["launches"][kernel] for path in runs + mesh_runs)

    f_bytes = sum(f["bytes_ms"] for f in served)
    f_ops = sum(f["ops_ms"] for f in served)
    s_bytes = sum(f["bytes_ms"] for f in merged)
    s_ops = sum(f["ops_ms"] for f in merged)
    t_bytes = sum(f["bytes_ms"] for f in tagged)
    t_ops = sum(f["ops_ms"] for f in tagged)
    g_bytes = sum(f["bytes_ms"] for f in tagged_merges)
    g_ops = sum(f["ops_ms"] for f in tagged_merges)
    lm_flash = flash + vflash
    a_bytes = sum(f["bytes_ms"] for f in lm_flash)
    a_ops = sum(f["ops_ms"] for f in lm_flash)
    kernels = [
        dict(name="isla_fold", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:162",
             launches=launched("isla_fold"),
             max_abs_err=max(f["max_abs_err"] for f in served + folds),
             ms=sum(f["ms"] for f in served),
             plain_ms=sum(f["plain_ms"] for f in served),
             bound_ms=max(f_bytes, f_ops),
             bound_by="bytes" if f_bytes >= f_ops else "operations",
             library_ms=None),
        dict(name="pilot_stats", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:463",
             launches=launched("pilot_stats"),
             max_abs_err=pilot["max_abs_err"], ms=pilot["ms"],
             plain_ms=pilot["plain_ms"], bound_ms=pilot["bound_ms"],
             bound_by=pilot["bound_by"], library_ms=None),
        dict(name="isla_sketch", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:362",
             launches=launched("isla_sketch"),
             max_abs_err=max(f["max_abs_err"] for f in merged),
             ms=sum(f["ms"] for f in merged),
             plain_ms=sum(f["plain_ms"] for f in merged),
             bound_ms=max(s_bytes, s_ops),
             bound_by="bytes" if s_bytes >= s_ops else "operations",
             library_ms=None),
        dict(name="isla_tagged_fold", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/core/distributed.py:269",
             launches=sum(p["launches"]["isla_tagged_fold"]
                          for p in f64_runs + mesh_runs),
             max_abs_err=max(f["max_abs_err"] for f in tagged),
             ms=sum(f["ms"] for f in tagged),
             plain_ms=sum(f["plain_ms"] for f in tagged),
             bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             library_ms=None),
        dict(name="isla_sketch_tagged", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:362",
             launches=sum(p["launches"]["isla_sketch_tagged"]
                          for p in f64_runs + mesh_runs),
             max_abs_err=max(f["max_abs_err"] for f in tagged_merges),
             ms=sum(f["ms"] for f in tagged_merges),
             plain_ms=sum(f["plain_ms"] for f in tagged_merges),
             bound_ms=max(g_bytes, g_ops),
             bound_by="bytes" if g_bytes >= g_ops else "operations",
             library_ms=None),
        dict(name="flash_attention", route="cuda", source=FLASH_SOURCE,
             replaces="src/repro/kernels/flash_attention.py:65",
             launches=(lm["launches"]["flash_attention"]
                       + vlm["launches"]["flash_attention"]),
             max_abs_err=max(f["max_abs_err"] for f in lm_flash + synth),
             ms=sum(f["ms"] for f in lm_flash),
             plain_ms=sum(f["plain_ms"] for f in lm_flash),
             bound_ms=max(a_bytes, a_ops),
             bound_by="bytes" if a_bytes >= a_ops else "operations",
             library_ms=sum(f["library_ms"] for f in lm_flash)),
    ]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, build_logs=logs, main_path=runs,
        main_path_folds=served, main_path_sketches=merged,
        main_path_f64=f64_runs, main_path_tagged=tagged,
        main_path_mesh=mesh_runs,
        main_path_tagged_sketches=tagged_merges, fold=folds,
        batched=batched, wrappers=wrappers, pilot=pilots, tight_plan=tight,
        lm_path=lm,
        phase_s=phase_s,
        lm_flash=flash, flash_synthetic=synth, lm_small=small,
        vlm_path=vlm, vlm_flash=vflash, flash_ptxas=ptxas, flash_sass=sass,
        isla_ptxas=islaptx,
        kernels=kernels),
        indent=1, default=str))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
