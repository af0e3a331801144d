"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
then drives the main path — the ISLA admission loop on ``route="device"``
over 1000 blocks x 16 groups x 20000 rows — and checks that it ran
through the kernels (launch counts reset just before, read just after)
and that its answers agree with the port's float64 ``route="host"`` on
the same queries and seed.  It keeps a copy of every pane the loop
folded and replays each fold, kernel against plain PyTorch version, on
those very panes and times both; it also holds the fold at the tick's
shape with synthetic 64- and 4096-sample panes, the Pallas-signature
wrapper, and the pilot kernel at the loop's pilot size.  Every
failure exits nonzero.  The last three lines of standard output are the
card's name and power limit, one JSON object describing every kernel,
and the result object; details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
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


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` warmed calls, CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    got = case["prior"].clone()
    again = case["prior"].clone()
    want = case["prior"].clone()
    fold_tick(K.isla_fold, case, got)
    fold_tick(K.isla_fold, case, again)
    fold_tick(ref.isla_fold_ref, case, want)
    torch.cuda.synchronize()
    check(torch.equal(got, again), "isla_fold is not deterministic")
    err = max_abs_err(got, want)
    rel = float(((got.double() - want.double()).abs()
                 / want.double().abs().clamp_min(1.0)).max())
    check(rel <= 1e-5, f"isla_fold disagrees with its plain version at "
                       f"quota {quota}: max rel err {rel:.3g} > 1e-5")
    scratch = case["prior"].clone()
    ms = time_ms(lambda: fold_tick(K.isla_fold, case, scratch))
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
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                launches_per_tick=len(FOLD_KEYS))


class FoldRecorder:
    """Keeps a copy of every pane set the main path folds, and of the
    resident rows just before the fold, by wrapping
    ``distributed.fold_panes`` while it is installed."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.core import distributed as D

        self._real = real = D.fold_panes

        def clone(x):
            if isinstance(x, (tuple, list)):
                return type(x)(clone(v) for v in x)
            return x.clone() if hasattr(x, "clone") else x

        def spy(*args, **kw):
            self.calls.append(dict(args=clone(args), kw=clone(kw)))
            return real(*args, **kw)

        D.fold_panes = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.core import distributed as D

        D.fold_panes = self._real
        return False


def check_main_path_folds(calls) -> "list[dict]":
    """Replay each fold of the main path on a copy of its rows: the kernel
    (twice: identical bits) against its plain version on the very panes
    the serving tick folded, then both timed, with the call's bound."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ref

    out = []
    for c in calls:
        state, panes = c["args"][:3], c["args"][3:]
        kw = c["kw"]

        def fold_into(rows, fold=None):
            extra = {} if fold is None else {"fold": fold}
            D.fold_panes(*rows, *panes, **kw, **extra)

        def run(fold=None):
            rows = [t.clone() for t in state]
            fold_into(rows, fold)
            return torch.cat(rows, dim=1)

        got, again, want = run(), run(), run(ref.isla_fold_ref)
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
        ms = time_ms(lambda: fold_into(scratch))
        plain_ms = time_ms(lambda: fold_into(scratch, ref.isla_fold_ref),
                           reps=5, warm=1)
        g_list = kw["n_groups_list"]
        n_b = values2d.shape[0]
        active = kw.get("active_cells")
        t_bytes, t_ops = panes_bound_ms(
            *panes, n_cells=sum(g * n_b for g in g_list),
            n_keys=len(g_list),
            cell_idx=None if active is None else active[0])
        out.append(dict(pane=list(values2d.shape), keys=len(g_list),
                        groups=list(g_list),
                        real_samples=int(panes[1].count_nonzero()),
                        compacted=active is not None,
                        max_abs_err=max_abs_err(got, want), max_rel_err=rel,
                        tolerance="rel 1e-5", ms=ms, plain_ms=plain_ms,
                        bytes_ms=t_bytes, ops_ms=t_ops,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations"))
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


def check_pilot(device, n: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import isla_moments as K
    from repro_torch.kernels import ref

    v = torch.as_tensor(np.random.default_rng(2).normal(0.8, 0.1, n),
                        dtype=torch.float32, device=device)
    center = (v.sum() / n).reshape(1)
    err = 0.0
    for c in (None, center):
        got = K.pilot_stats(v, center=c)
        want = ref.pilot_stats_ref(v, c)
        rel = ((got.double() - want.double()).abs()
               / want.double().abs().clamp_min(1.0))
        check(float(rel.max()) <= 1e-5 or float(
            (got.double() - want.double()).abs().max()) <= 1e-3,
              f"pilot_stats disagrees with its plain version: {got} vs "
              f"{want}")
        err = max(err, max_abs_err(got, want))
    ms = time_ms(lambda: K.pilot_stats(v))
    plain_ms = time_ms(lambda: ref.pilot_stats_ref(v))
    bound = 4 * n / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * n / FP32_FLOP_PER_S * 1e3
    return dict(n=n, max_abs_err=err, tolerance="rel 1e-5 or abs 1e-3",
                ms=ms, plain_ms=plain_ms, bound_ms=max(bound, t_ops),
                bound_by="bytes" if bound >= t_ops else "operations")


# ---------------------------------------------------------------------------
# The main path: the admission loop on route="device".
# ---------------------------------------------------------------------------


def serve_queries(C, e: float):
    """One tick's batch: the four serving keys (plain, WHERE, GROUP BY,
    WHERE + GROUP BY) under the four moment aggregates."""
    flag = C.Predicate(column="flag", eq=1.0)
    return [C.IslaQuery(e=e, agg="AVG"),
            C.IslaQuery(e=e, agg="SUM", where=flag),
            C.IslaQuery(e=e, agg="AVG", group_by="region"),
            C.IslaQuery(e=e, agg="COUNT", group_by="region", where=flag),
            C.IslaQuery(e=e, agg="VAR")]


def run_serve(device: str, route: str, n_blocks: int, n_groups: int,
              rows: int, ticks, seed: int = 0):
    """Drive the admission loop: one batch of ``serve_queries`` per entry
    of ``ticks`` (its precision e).  Returns the finished tickets, the
    executor and per-tick records."""
    import numpy as np
    import repro_torch.core as C
    from repro_torch.kernels import isla_moments as K
    from repro_torch.launch.serve import (IslaAdmissionLoop,
                                          _synthetic_grouped_blocks)

    samplers = _synthetic_grouped_blocks(n_blocks, n_groups, rows, seed)
    ex = C.MultiQueryExecutor(samplers, [10 ** 7] * n_blocks,
                              params=C.IslaParams(e=ticks[0]),
                              group_domains={"region": n_groups},
                              device=device)
    loop = IslaAdmissionLoop(ex, np.random.default_rng(seed + 1),
                             route=route, incremental=True)
    done, records = [], []
    for k, e in enumerate(ticks):
        for q in serve_queries(C, e):
            loop.submit(q)
        f0, p0 = K.isla_fold.launches, K.pilot_stats.launches
        prof = profile_tick(device, k == 1)
        t0 = time.perf_counter()
        with prof:
            out = loop.tick()
            if device == "cuda":
                import torch
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        records.append(dict(
            e=e, wall_s=wall, answered=len(out),
            device_busy_s=device_seconds(prof),
            new_samples=sum({a.answer.pass_id: a.answer.new_samples
                             for a in out}.values()),
            fold_launches=K.isla_fold.launches - f0,
            pilot_launches=K.pilot_stats.launches - p0,
            stages_s=dict(ex.last_stage_times)))
        done.extend(out)
    return done, ex, records


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


def check_answers(dev_done, host_done) -> dict:
    """Device route vs the port's float64 host route: finite values,
    identical draw ledgers, values rel 2e-3 and groups rel 5e-3 (the
    reference's device-versus-host tolerances)."""
    check(len(dev_done) == len(host_done) > 0, "answer counts differ")
    worst, worst_g = 0.0, 0.0
    for d, h in zip(dev_done, host_done):
        a, b = d.answer, h.answer
        check(math.isfinite(a.value), f"non-finite answer {a.value}")
        check(a.new_samples == b.new_samples
              and a.sample_size == b.sample_size,
              f"draw ledgers differ: {a.new_samples}/{a.sample_size} vs "
              f"{b.new_samples}/{b.sample_size}")
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
    return dict(answers=len(dev_done), max_rel_value=worst,
                max_rel_group=worst_g)


def main_path(n_blocks=1000, n_groups=16, rows=20000,
              ticks=(0.5, 0.25, 0.25)) -> dict:
    import torch
    from repro_torch.kernels import isla_moments as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    with FoldRecorder() as folds:
        dev_done, ex, records = run_serve("cuda", "device", n_blocks,
                                          n_groups, rows, ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"isla_fold": K.isla_fold.launches,
                "pilot_stats": K.pilot_stats.launches}
    check(launches["isla_fold"] > 0, "the main path never launched isla_fold")
    check(launches["pilot_stats"] > 0,
          "the main path never launched pilot_stats")
    pilot_n = int(ex._anchor[0].pilot_size)
    del ex  # the host run below rebuilds the same tables
    host_done, _, _ = run_serve("cpu", "host", n_blocks, n_groups, rows,
                                ticks)
    agree = check_answers(dev_done, host_done)
    return dict(launches=launches, wall_s=wall, ticks=records,
                pilot_size=pilot_n, agreement=agree, fold_calls=folds.calls,
                shape=dict(blocks=n_blocks, groups=n_groups, rows=rows))


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
    K.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s ({len(logs)} source(s) compiled)")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    path = main_path()
    print(f"main path: {json.dumps(path['launches'])} launches, "
          f"{path['agreement']}, {path['wall_s']:.2f} s")
    dev = torch.device("cuda")
    served = check_main_path_folds(path.pop("fold_calls"))
    check(len(served) > 0, "the main path folded no pane")
    for f in served:
        print(f"isla_fold on the main path's pane {tuple(f['pane'])} "
              f"({f['keys']} keys, {f['real_samples']} samples): "
              f"{f['ms']:.4f} ms (plain {f['plain_ms']:.3f} ms, bound "
              f"{f['bound_ms']:.4f} ms by {f['bound_by']}), max abs err "
              f"{f['max_abs_err']:.3g}, max rel err {f['max_rel_err']:.3g} "
              f"(tol rel 1e-5)")
    folds = [check_fold(dev, 1000, q) for q in (64, 4096)]
    for f in folds:
        print(f"isla_fold synthetic quota {f['quota']}: {f['ms']:.4f} ms "
              f"(plain {f['plain_ms']:.3f} ms, bound {f['bound_ms']:.4f} "
              f"ms by {f['bound_by']}), max abs err {f['max_abs_err']:.3g}"
              f", max rel err {f['max_rel_err']:.3g} (tol rel 1e-5)")
    batched = check_batched(dev)
    print(f"isla_moments_batched stride {batched['stride']} per-cell cuts: "
          f"{batched['ms']:.4f} ms (plain {batched['plain_ms']:.3f} ms, "
          f"bound {batched['bound_ms']:.4f} ms), "
          f"max rel err {batched['max_rel_err']:.3g} (tol rel 1e-5)")
    pilot = check_pilot(dev, path["pilot_size"])
    print(f"pilot_stats n={pilot['n']}: {pilot['ms']:.4f} ms (plain "
          f"{pilot['plain_ms']:.4f} ms, bound {pilot['bound_ms']:.6f} ms), "
          f"max abs err {pilot['max_abs_err']:.3g}")

    # The fold's entry sums the main path's own folds (every drawing
    # tick's launches, replayed on its panes).
    f_bytes = sum(f["bytes_ms"] for f in served)
    f_ops = sum(f["ops_ms"] for f in served)
    kernels = [
        dict(name="isla_fold", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:162",
             launches=path["launches"]["isla_fold"],
             max_abs_err=max(f["max_abs_err"] for f in served + folds),
             ms=sum(f["ms"] for f in served),
             plain_ms=sum(f["plain_ms"] for f in served),
             bound_ms=max(f_bytes, f_ops),
             bound_by="bytes" if f_bytes >= f_ops else "operations",
             library_ms=None),
        dict(name="pilot_stats", route="cuda", source=FOLD_SOURCE,
             replaces="src/repro/kernels/isla_moments.py:463",
             launches=path["launches"]["pilot_stats"],
             max_abs_err=pilot["max_abs_err"], ms=pilot["ms"],
             plain_ms=pilot["plain_ms"], bound_ms=pilot["bound_ms"],
             bound_by=pilot["bound_by"], library_ms=None),
    ]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, build_logs=logs, main_path=path,
        main_path_folds=served, fold=folds, batched=batched, pilot=pilot,
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
