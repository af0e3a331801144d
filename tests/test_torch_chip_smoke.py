"""CPU tests of ``chip_smoke.py``'s reading of profiled ticks: a trace that
lost kernels the launch counts name is taken again, never read as proof
that a kernel did not run."""
import sys
from pathlib import Path

import pytest
import torch

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


# The mesh phase's checks.

N_ROWS = 34  # the loop's stack: 1 + 1 + 16 + 16 rows


def mesh_tick(distinct, f64, drawing, first, collectives=None, **over):
    r = S.mesh_tick_launches(distinct, f64, S.MESH_SHARDS, drawing, first)
    reduce = [("sum", 9 * N_ROWS)] + ([("max", S.N_REGS * N_ROWS)]
                                      if distinct else [])
    r.update(new_samples=1000 if drawing else 0,
             collectives=reduce if collectives is None else collectives)
    r.update(over)
    return r


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("f64", [False, True])
def test_check_mesh_ticks_takes_a_launch_a_shard(distinct, f64):
    recs = [mesh_tick(distinct, f64, True, True),
            mesh_tick(distinct, f64, True, False),
            mesh_tick(distinct, f64, False, False, collectives=[])]
    S.check_mesh_ticks("mesh", recs, S.MESH_SHARDS, distinct, f64, N_ROWS)
    want = S.MESH_SHARDS if f64 else 0
    assert recs[0]["tagged_launches"] == want
    assert recs[0]["fold_launches"] == S.MESH_SHARDS - want
    assert recs[0]["pilot_launches"] == 1 and recs[1]["pilot_launches"] == 0


@pytest.mark.parametrize("bad", [
    dict(fold_launches=1),                      # one launch, not one a shard
    dict(fold_calls=4, fold_launches=5),        # a launch outside the calls
    dict(pilot_launches=2),                     # a second pilot
    dict(collectives=[("sum", 9 * N_ROWS)] * 2),   # two reduces a tick
    dict(collectives=[("sum", 4 * 34_000)]),    # O(cells) crosses
    dict(collectives=[("max", 9 * N_ROWS)]),    # not the stat rows' sum
    dict(collectives=[]),                       # a drawing tick unreduced
], ids=["one-launch", "extra-launch", "two-pilots", "two-reduces",
        "cells-cross", "max-only", "no-reduce"])
def test_check_mesh_ticks_fails(bad):
    recs = [mesh_tick(False, False, True, True, **bad)]
    with pytest.raises(S.SmokeFailure, match="tick 1"):
        S.check_mesh_ticks("mesh", recs, S.MESH_SHARDS, False, False, N_ROWS)


@pytest.fixture
def float64_default():
    import torch

    was = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(was)


def test_check_mesh_state_on_the_cpu(float64_default):
    """The float64 loop on a four-shard CPU mesh and on the device route,
    at a small size: ``check_mesh_state`` holds them bit for bit, and
    each drawing tick records one sum and one max of O(groups) rows; a
    changed cell fails it."""
    args = (12, 3, 400, (0.5, 0.25, 0.25), True)
    _, mesh_ex, recs = S.run_serve("cpu", "mesh", *args,
                                   mesh=["cpu"] * S.MESH_SHARDS)
    _, dev_ex, _ = S.run_serve("cpu", "device", *args)
    st = S.check_mesh_state(mesh_ex, dev_ex)
    assert st["keys"] == 4 and st["cells"] == (1 + 1 + 3 + 3) * 12
    rows = 1 + 1 + 3 + 3  # the four keys' stat rows
    assert [r["collectives"] for r in recs[:2]] == [
        [("sum", 9 * rows), ("max", S.N_REGS * rows)]] * 2
    dst = next(iter(dev_ex._device_stores.values()))
    dst.mom_s = dst.mom_s + 1.0
    with pytest.raises(S.SmokeFailure, match="mom_s"):
        S.check_mesh_state(mesh_ex, dev_ex)


# The pipelined phase's runs, batch and checks.


def test_pipelined_runs_cover_the_main_path():
    """Four pipelined runs on the device route (moments and COUNT
    DISTINCT, fp32 and float64) and one float64 COUNT DISTINCT run on a
    four-shard mesh on the card; four chunks a group at 1000 blocks."""
    got = {(distinct, f64, mesh is not None)
           for _, distinct, f64, mesh in S.PIPE_RUNS}
    assert got == {(d, f, False) for d in (False, True)
                   for f in (False, True)} | {(True, True, True)}
    (mesh,) = [m for *_, m in S.PIPE_RUNS if m is not None]
    assert list(mesh) == ["cuda:0"] * 4
    assert -(-1000 // S.PIPE_CHUNK_BLOCKS) == 4


@pytest.mark.parametrize("distinct", [False, True])
def test_pipeline_queries_plan_two_mode_groups(distinct):
    """The pipelined batch is ``serve_queries`` under both modes: the
    executor plans it as two mode groups over the same four keys."""
    import numpy as np
    import repro_torch.core as C
    from repro_torch.launch.serve import _synthetic_grouped_blocks

    ex = C.MultiQueryExecutor(_synthetic_grouped_blocks(8, 3, 200, 0),
                              [10 ** 7] * 8, group_domains={"region": 3},
                              device="cpu")
    qs = S.pipeline_queries(C, 0.5, distinct)
    assert len(qs) == 2 * len(S.serve_queries(C, 0.5, distinct))
    plan = ex.plan(qs, np.random.default_rng(0), route="device")
    assert len(plan.mode_groups) == 2
    assert {q.mode for q in qs} == set(S.PIPE_MODES)


@pytest.mark.parametrize("run", S.PIPE_RUNS, ids=[r[0] for r in S.PIPE_RUNS])
def test_pipe_path_on_the_cpu(run):
    """Each pipelined run of the phase, rehearsed on the CPU at a small
    size (the mesh on four CPU shards): its serial twin holds it bit for
    bit, and the fp32 runs' two serial runs agree."""
    name, distinct, f64, mesh = run
    path = S.pipe_path(name, distinct, f64,
                       None if mesh is None else ["cpu"] * len(mesh),
                       n_blocks=40, n_groups=3, rows=400, device="cpu")
    tw = path["twin"]
    assert tw["pipe_gap"] == tw["serial_gap"] == 0
    assert not tw["pipe_gap_arrays"] and not tw["serial_gap_arrays"]
    assert [r["new_samples"] > 0 for r in path["ticks"]] == [True, True,
                                                             False]


def answer(value, **kw):
    from types import SimpleNamespace

    fields = dict(value=value, mean=value, error_bound=None,
                  sampling_rate=0.1, sample_size=10, mode="calibrated",
                  pass_id=0, n_matched=5, est_population=50.0,
                  new_samples=10, half_width=1.0, groups=None)
    fields.update(kw)
    return SimpleNamespace(**fields)


def run_of(values, cell=0.0):
    import numpy as np

    return ([[answer(v) for v in values]],
            {("k", "mom_s"): np.array([1.0, cell])})


@pytest.mark.parametrize("piped, serial2, gaps", [
    (run_of([1.0, 2.0]), None, (0, 0, 0, 0)),
    (run_of([1.0, 2.5]), None, None),            # a float64 answer moved
    (run_of([1.0, 2.0], cell=1.0), None, None),  # a state array moved
    (run_of([1.0, 2.5]), run_of([1.0, 2.0]), None),  # serial repeats
    (run_of([1.0, 2.5]), run_of([1.0, 2.25]), (1, 0, 1, 0)),
    (run_of([1.0, 2.0], cell=1.0), run_of([1.0, 2.0], cell=2.0),
     (0, 1, 0, 1)),
], ids=["equal", "f64-answer", "f64-array", "fp32-reproducible",
        "fp32-serial-gap", "fp32-serial-array-gap"])
def test_check_twin(piped, serial2, gaps):
    """A pipelined run must equal its serial twin wherever a second serial
    run repeats the first (float64: everywhere); the gaps are counted."""
    serial = run_of([1.0, 2.0])
    if gaps is None:
        with pytest.raises(S.SmokeFailure, match="serial twin"):
            S.check_twin("x", piped, serial, serial2)
        return
    got = S.check_twin("x", piped, serial, serial2)
    assert (got["pipe_gap"], len(got["pipe_gap_arrays"]), got["serial_gap"],
            len(got["serial_gap_arrays"])) == gaps


def event(name, thread, start, end, device_type="DeviceType.CPU"):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, thread=thread, device_type=device_type,
                           time_range=SimpleNamespace(start=start, end=end))


def test_stage_ranges_tell_the_threads_apart():
    evs = [event(S.WORKER_MARK, 7, 0, 1), event(S.MAIN_MARK, 1, 0, 1),
           event("isla:launch", 7, 10, 30), event("isla:launch", 7, 50, 60),
           event("isla:draw", 1, 20, 55), event("isla:draw", 1, 70, 80),
           event("isla:h2d", 7, 5, 10), event("aten::add", 7, 12, 13),
           # a range's device-side span, on a stream whose id is a thread's
           event("isla:launch", 1, 11, 29, device_type="DeviceType.CUDA")]
    rg = S.stage_ranges(evs)
    assert rg == dict(worker_launch=[(10, 30), (50, 60)], main_launch=[],
                      main_draw=[(20, 55), (70, 80)])
    assert S.overlap_us(rg["worker_launch"], rg["main_draw"]) == 10 + 5
    r = dict(ranges=rg)
    assert S.check_pipe_profile(r, 2)["overlap_us"] == 15
    with pytest.raises(S.SmokeFailure, match="isla:launch ranges"):
        S.check_pipe_profile(r, 3)
    late = dict(ranges=dict(rg, main_draw=[(70, 80)]))
    with pytest.raises(S.SmokeFailure, match="under a main-thread draw"):
        S.check_pipe_profile(late, 2)
    with pytest.raises(S.SmokeFailure, match="launch worker"):
        S.stage_ranges(evs[1:])


def test_profiled_pipelined_tick_on_the_cpu():
    """A profiled pipelined top-up tick on the CPU at a small size, every
    thread's ranges in the window: eight chunk ticks' ``isla:launch`` on
    the launch worker (two groups of four chunks), none on the main
    thread, which holds the draws."""
    _, _, recs = S.pipe_serve("cpu", "device", 40, 3, 400,
                              (0.5, 0.25, 0.25), False, True,
                              profile_at=(1,), chunk_blocks=10)
    rg = recs[1]["ranges"]
    assert len(rg["worker_launch"]) == 8 and not rg["main_launch"]
    assert len(rg["main_draw"]) >= 8


@pytest.mark.parametrize("rec, whole", [
    (dict(kernel_events=events(isla_fold_kernel=1), fold_f64_launches=1,
          sketch_launches=0), True),
    (dict(kernel_events=events(isla_fold_kernel=1, isla_sketch_kernel=1),
          fold_f64_launches=1, sketch_launches=1), True),
    (dict(kernel_events=events(isla_fold_kernel=1), fold_f64_launches=1,
          sketch_launches=1), False),
    (dict(kernel_events=events(), fold_f64_launches=1, sketch_launches=0),
     False),
    (dict(kernel_events=None, fold_f64_launches=1, sketch_launches=0),
     False),
], ids=["moments", "distinct", "lost-merge", "lost-fold", "no-trace"])
def test_dense64_trace_whole(rec, whole):
    assert S.dense64_trace_whole(rec) is whole


def test_rel_gap():
    import numpy as np

    assert S.rel_gap(np.array([1.0, 2.0]), np.array([1.0, 2.0])) == 0.0
    assert S.rel_gap(np.array([1.0, 2.0 + 2e-12]),
                     np.array([1.0, 2.0])) == pytest.approx(1e-12)
    assert S.rel_gap(np.array([1e-300]), np.array([0.0])) == float("inf")


@pytest.mark.parametrize("run", S.DENSE64_RUNS,
                         ids=[r[0] for r in S.DENSE64_RUNS])
def test_dense64_path_on_the_cpu(run, monkeypatch):
    """Each float64 dense run of the phase, rehearsed on the CPU at a small
    size (the mesh on four CPU shards; the plain fold and merge stand in
    for the kernels and count as their launches): the compacted, full and
    mesh runs give the same bits, the tagged run lies within 1e-12, and
    every drawing tick is one float64 fold (one a shard on the mesh)."""
    from repro_torch.core import distributed as D
    from repro_torch.kernels import isla_moments as K

    real_fold, real_sketch = D.isla_fold_stack, D.isla_sketch_stack

    def fold(values, *args, **kw):
        real_fold(values, *args, **kw)
        if values.dtype == torch.float64:
            K.isla_fold.launches_f64 += 1
        else:
            K.isla_fold.launches += 1

    def sketch(*args, **kw):
        real_sketch(*args, **kw)
        K.isla_sketch.launches += 1

    monkeypatch.setattr(D, "isla_fold_stack", fold)
    monkeypatch.setattr(D, "isla_sketch_stack", sketch)
    monkeypatch.setattr(S, "dense64_trace_whole", lambda r: True)
    name, distinct = run
    path = S.dense64_path(name, distinct, device="cpu", n_blocks=40,
                          n_groups=4, rows=500)
    assert path["launches"] == {"isla_fold_f64": 3, "isla_fold": 0,
                                "isla_sketch": 3 * distinct}
    assert path["mesh_launches"]["isla_fold_f64"] == 3 * S.MESH_SHARDS
    assert max(path["tagged_gaps"].values()) <= S.DENSE64_TOL
    assert len(path["fold_calls"]) == 3
    assert [r["active_blocks"] for r in path["ticks"]] == [20, 20, 20]


def count_folds(monkeypatch, per_call: int = 1):
    """The plain fold stands in for the kernel on the CPU and counts as
    ``per_call`` launches."""
    from repro_torch.kernels import isla_moments as K

    real = K.isla_fold_stack

    def fold(*args, **kw):
        real(*args, **kw)
        K.isla_fold.launches += per_call

    monkeypatch.setattr(K, "isla_fold_stack", fold)


TELEMETRY_SMALL = dict(shapes=((64, 256), (128, 256)),
                       mesh_devices=["cpu"] * 4, accuracy_shape=(32, 256),
                       router_tokens=(4, 64))


def test_telemetry_path_on_the_cpu(monkeypatch):
    """The telemetry phase rehearsed on the CPU at small sizes (the mesh
    on four CPU shards): one fold a shard an ISLA call, the cross-shard
    sums of each call, no upload, answers that agree with the plain runs."""
    count_folds(monkeypatch)
    path = S.telemetry_path(device="cpu", **TELEMETRY_SMALL)
    names = [n for n, _, _ in S.telemetry_calls()]
    assert len(names) == 11
    calls = path["calls"]
    assert len(calls) == 2 * (11 + 10)
    for c in calls:
        per_shard, sums = S.telemetry_expect(c["kind"], {
            "semantics": c["name"].split()[1],
            "mode": c["name"].split()[2]} if c["kind"] == "isla_mean"
            else {})
        assert c["fold_launches"] == per_shard * c["shards"]
        assert c["footprint"] == (sums if c["route"] == "mesh" else [])
        assert max(max(g.values()) for g in c["gaps"].values()) <= \
            S.TELEMETRY_TOL
    by = {(c["name"], c["route"], tuple(c["shape"])): c for c in calls}
    assert by[("isla_mean merged empirical strided", "mesh", (64, 256))][
        "footprint"] == [3, 6, 8]
    assert by[("loss_stats", "mesh", (128, 256))]["footprint"] == [3, 6, 2, 2]
    assert ("loss_stats_trimmed_exact", "mesh", (64, 256)) not in by
    assert all("abs_err" in c for c in calls
               if c["kind"] in ("isla_mean", "loss_stats"))
    assert [a["route"] for a in path["accuracy"]] == ["device", "mesh"]
    assert [r["fold_launches"] for r in path["router"]] == [1, 4]
    assert path["router_experts"] == 128
    assert sorted(path["panes"]) == [82, 164, 205, 328, 410, 655, 819, 1638]


@pytest.mark.parametrize("fault", ["two launches", "upload", "footprint"])
def test_telemetry_call_fails(monkeypatch, fault):
    """A call that launches the fold twice, uploads through ``h2d`` or
    reduces more than its sums fails the phase."""
    import numpy as np
    from repro_torch.core import distributed as D

    count_folds(monkeypatch, 2 if fault == "two launches" else 1)
    if fault == "upload":
        real = D.isla_mean

        def uploading(values, *a, **kw):
            D.h2d(np.zeros(1, np.float32), device="cpu")
            return real(values, *a, **kw)

        monkeypatch.setattr(D, "isla_mean", uploading)
    if fault == "footprint":
        real_psum = D._psum

        def psum(x, mesh):
            if mesh is not None:
                D.mesh_all_reduce(mesh, x)
            return real_psum(x, mesh)

        monkeypatch.setattr(D, "_psum", psum)
    x = torch.from_numpy(np.random.default_rng(0).gamma(
        2.0, 2.0, (64, 64)).astype(np.float32))
    (dev, _), (shards, mesh) = S.telemetry_routes(x, ["cpu"] * 2, "cpu")
    kw = dict(semantics="blocks", mode="calibrated", generator=False)
    with pytest.raises(S.SmokeFailure):
        S.telemetry_call("isla_mean", "isla_mean", kw, shards, mesh, None,
                         None, "cpu")


def test_grad_telemetry_on_the_cpu(monkeypatch):
    """``grad_abs_stats`` over a reduced olmo-1b tree, the device route and
    the mesh (leaves cut on dim 0): one fold a shard, sums 3 and 8."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM

    count_folds(monkeypatch)
    params = TM.init_params(get_config("olmo-1b", reduced=True),
                            torch.Generator().manual_seed(0))
    dev, mesh = S.grad_telemetry(params, device="cpu",
                                 mesh_devices=["cpu"] * 4)
    assert (dev["fold_launches"], dev["footprint"]) == (1, [])
    assert (mesh["fold_launches"], mesh["footprint"]) == (4, [3, 8])
    assert dev["gaps"]["grad_absmean_isla"]["cpu"] == 0.0


def test_telemetry_fold_bound():
    t_bytes, t_ops = S.telemetry_fold_bound_ms(335544)
    assert t_bytes == pytest.approx((4 * 335544 + 80) / 3.35e12 * 1e3)
    assert t_bytes > t_ops


# The MoE phase rehearsed on the CPU: reduced configs (4 experts, groups
# of 64, d_model 128), prompts of 40-130 tokens.
MOE_SMALL = dict(reduced=True, device="cpu", prompt_lens=(40, 130),
                 max_seq=160)


@pytest.mark.parametrize("arch", [a for a, _ in S.MOE_RUNS])
def test_moe_path_on_the_cpu(arch):
    """The phase's checks pass on a reduced config on the CPU: every
    request served, no ISLA kernel, every decode step routing all four
    slots, the routing equal to itself run on the CPU (no near-tie), and
    ``apply_moe`` within the tolerance of the gather oracle."""
    r = S.moe_path(arch, 2, **MOE_SMALL)
    assert len(r["finish_order"]) == S.MOE_REQUESTS
    assert r["launches"]["flash_attention"] == 0  # the CPU: plain version
    assert len(r["calls"]) == S.MOE_REQUESTS * 2
    assert {o["call"] for o in r["oracle"]} == {
        "grouped prefill", "fallback prefill", "decode step"}
    for o in r["oracle"]:
        assert o["experts"]["max_abs_err"] <= S.MOE_TOL * o["experts"][
            "scale"]
    assert len(r["routes"]) == (S.MOE_REQUESTS + 1) * 2
    assert all(x["near_ties"] == x["moved"] == 0 for x in r["routes"])
    assert {x["groups"] > 1 for x in r["routes"]} == {True, False}
    assert r["profiled_tick"]["active"] == S.MOE_SLOTS


def test_moe_prompt_lens_take_both_routing_paths():
    import numpy as np

    lens = S.moe_prompt_lens(np.random.default_rng(3), 256, 384, 2048)
    assert len(lens) == S.MOE_REQUESTS
    assert all(384 <= n <= 2048 for n in lens)
    assert any(n % 256 == 0 for n in lens) and any(n % 256 for n in lens)


def test_moe_oracle_finds_a_wrong_expert_weight():
    """The gather oracle is independent of the dispatch and combine
    products: a main path that applied the wrong virtual expert's weights
    fails the check."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    cfg = get_config("grok-1-314b", reduced=True).replace(
        param_dtype="float32")
    params = M.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((1, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    S.check_moe_oracle(cfg, params, x)
    real = M._expert_ffn

    def swapped(cfg_, p, xe):
        return real(cfg_, {k: v.roll(1, 0) for k, v in p.items()}, xe)

    M._expert_ffn = swapped
    try:
        with pytest.raises(S.SmokeFailure, match="gather oracle"):
            S.check_moe_oracle(cfg, params, x)
    finally:
        M._expert_ffn = real


@pytest.mark.parametrize("spoil, match", [
    ("dispatch", "every token took the same experts"),
    ("combine", "combine off the CPU's")])
def test_check_route_fails_on_a_wrong_route(spoil, match):
    """``check_route`` refuses a CPU routing whose one token moved to
    another expert's slot though no gate is near a tie, or whose one gate
    is off by rel 1e-5."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    cfg = get_config("arctic-480b", reduced=True)
    logits = torch.randn((2, 64, cfg.moe.n_experts),
                         generator=torch.Generator().manual_seed(2))
    assert S.check_route(cfg, logits)["near_ties"] == 0
    real = M._route

    def spoiled(cfg_, lg):
        d, c, aux = real(cfg_, lg)
        if lg is not logits:  # the CPU's call
            d, c = d.clone(), c.clone()
            if spoil == "dispatch":
                d[0, 3] = d[0, 3].roll(1, 0)
                c[0, 3] = c[0, 3].roll(1, 0)
            else:
                c[0, 3] *= 1 + 1e-5
        return d, c, aux

    M._route = spoiled
    try:
        with pytest.raises(S.SmokeFailure, match=match):
            S.check_route(cfg, logits)
    finally:
        M._route = real


# The Mamba phase rehearsed on the CPU: reduced configs (chunk 32), prompts
# of two to four chunks and shorter than one.
MAMBA_SMALL = dict(reduced=True, device="cpu", prompt_hi=128)


@pytest.mark.parametrize("arch, dtype, checks", [
    ("mamba2-130m", None, ("cpu", "parity")),
    ("jamba-1.5-large-398b", "bfloat16", ()),
    ("jamba-1.5-large-398b", "float32", ("cpu",))])
def test_mamba_path_on_the_cpu(arch, dtype, checks):
    """The phase's checks pass on a reduced config on the CPU: every
    request served, no flash launch (the CPU: plain version) but one flash
    call per prefill of jamba's one attention layer, no ISLA kernel, every
    prefill's layer-0 SSD within the tolerance of the oracle, and the
    checks asked for."""
    r = S.mamba_path(arch, dtype=dtype, checks=checks, **MAMBA_SMALL)
    assert len(r["finish_order"]) == S.MAMBA_REQUESTS
    assert r["launches"] == dict(flash_attention=0, isla_fold=0,
                                 pilot_stats=0, isla_sketch=0)
    assert len(r["calls"]) == S.MAMBA_REQUESTS * r["attention_layers"]
    assert r["attention_layers"] == (1 if arch.startswith("jamba") else 0)
    assert [c["tokens"] for c in r["ssd"]] == r["prompt_lens"]
    assert all(c["y_rel"] <= S.MAMBA_TOL and c["h_rel"] <= S.MAMBA_TOL
               for c in r["ssd"])
    assert {c["chunks"] > 1 for c in r["ssd"]} == {True, False}
    assert r["profiled_tick"]["active"] == S.MAMBA_SLOTS
    if "parity" in checks:
        assert r["parity"]["float32"]["within_contract"]
    if "cpu" in checks and arch.startswith("jamba"):
        assert {p["on_group"] for p in r["cpu"]["prompts"]} == {True, False}
        assert all(e <= S.JAMBA_TOL for p in r["cpu"]["prompts"]
                   for e in p["rel_err"])
    elif "cpu" in checks:
        assert r["cpu"]["mamba_calls"] == 2 * r["mamba_layers"]
        assert max(r["cpu"]["layerwise_rel"].values()) <= S.MAMBA_TOL
        assert max(r["cpu"]["f32_rel"].values()) <= S.MAMBA_F32_TOL


def _ssd_case(seed=0, S_=64, G=2):
    """SSD inputs of the reduced mamba2-130m's width at ``G`` groups."""
    g = torch.Generator().manual_seed(seed)
    H, P, N = 4, 32, 16
    x = torch.randn((1, S_, H, P), generator=g)
    dt = torch.rand((1, S_, H), generator=g) * 0.2 + 0.01
    A = -(torch.rand((H,), generator=g) * 1.5 + 0.5)
    Bm, Cm = (torch.randn((1, S_, G, N), generator=g) for _ in range(2))
    return x, dt * A, dt, Bm, Cm


def _ssd_call(args, chunk=32, h0=None):
    from repro_torch.models import mamba2 as M

    y, h = M.ssd_chunked(*args, chunk, h0=h0)
    return dict(zip(("x", "da", "dt", "Bm", "Cm"), args), chunk=chunk,
                h0=h0, y=y, h=h)


def test_check_ssd_holds_the_scan_and_finds_a_wrong_state():
    """``check_ssd`` passes the scan (from zero and from a state) and fails
    on a final state 5% off."""
    args = _ssd_case()
    S.check_ssd("t", _ssd_call(args), 1e-5)
    h0 = torch.randn((1, 4, 16, 32), generator=torch.Generator()
                     .manual_seed(3))
    call = _ssd_call(args, h0=h0)
    S.check_ssd("t", call, 1e-5)
    call["h"] = call["h"] * 1.05
    with pytest.raises(S.SmokeFailure, match="final state rel"):
        S.check_ssd("t", call, S.MAMBA_TOL)


def test_check_ssd_finds_a_repeat_head_map(monkeypatch):
    """At two B/C groups a ``.repeat`` head map (head h on group h % G,
    where the reference's ``jnp.repeat`` takes h // rep) fails the check:
    the oracle maps heads on its own."""
    from repro_torch.models import mamba2 as M

    def tiled(t, rep, dim):
        reps = [1] * t.dim()
        reps[dim] = rep
        return t.repeat(*reps)

    monkeypatch.setattr(M, "_repeat_heads", tiled)
    with pytest.raises(S.SmokeFailure, match="off the oracle"):
        S.check_ssd("t", _ssd_call(_ssd_case()), S.MAMBA_TOL)


def test_mamba_path_finds_a_wrong_ssd_state(monkeypatch):
    """A main path whose scan returned a final state 5% off fails the
    phase at the first prefill's layer-0 check."""
    from repro_torch.models import mamba2 as M

    real = M.ssd_chunked

    def spoiled(*args, **kw):
        y, h = real(*args, **kw)
        return y, h * 1.05

    monkeypatch.setattr(M, "ssd_chunked", spoiled)
    with pytest.raises(S.SmokeFailure, match="final state rel"):
        S.mamba_path("mamba2-130m", **MAMBA_SMALL)


def test_mamba_path_finds_a_repeat_head_map(monkeypatch):
    """The phase on a reduced mamba2-130m with two B/C groups: a
    ``.repeat`` head map in the scan fails it."""
    import dataclasses

    import repro_torch.configs as C
    from repro_torch.models import mamba2 as M

    real_get = C.get_config

    def two_groups(name, reduced=False):
        cfg = real_get(name, reduced=reduced)
        return cfg.replace(mamba=dataclasses.replace(cfg.mamba, n_groups=2))

    def tiled(t, rep, dim):
        reps = [1] * t.dim()
        reps[dim] = rep
        return t.repeat(*reps)

    monkeypatch.setattr(C, "get_config", two_groups)
    r = S.mamba_path("mamba2-130m", **MAMBA_SMALL)
    assert len(r["finish_order"]) == S.MAMBA_REQUESTS
    monkeypatch.setattr(M, "_repeat_heads", tiled)
    with pytest.raises(S.SmokeFailure, match="off the oracle"):
        S.mamba_path("mamba2-130m", **MAMBA_SMALL)


@pytest.mark.parametrize("lens, group, match", [
    ([512, 100], None, None),
    ([300, 100], None, "off the chunk contract"),
    ([512, 2], None, "off the chunk contract"),
    ([512, 1024], None, "one short chunk"),
    ([256, 100], None, "more than one chunk"),
    ([512, 100], 64, None),
    ([512, 192, 100], 256, None),
    ([768, 100], 512, "routing paths")])
def test_check_prompt_lens(lens, group, match):
    """Full-width mamba2-130m (chunk 256, d_conv 4): a length past the
    chunk and off it (300), one shorter than the conv tail (2), or a set
    without both kinds (more than one chunk, and one short chunk), or
    without both routing paths, fails."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-130m")
    if match is None:
        S.check_prompt_lens(cfg, lens, group)
        return
    with pytest.raises(S.SmokeFailure, match=match):
        S.check_prompt_lens(cfg, lens, group)


@pytest.mark.parametrize("arch, hi", [("mamba2-130m", 2048),
                                      ("jamba-1.5-large-398b", 256)])
def test_mamba_prompt_lens_meet_the_contract(arch, hi):
    import numpy as np
    from repro_torch.configs import get_config

    cfg = get_config(arch, reduced=arch.startswith("jamba"))
    chunk = cfg.mamba.chunk
    group = cfg.moe.group_size if cfg.moe is not None else None
    for seed in range(5, 9):
        lens = S.mamba_prompt_lens(np.random.default_rng(seed), cfg, hi,
                                   group)
        assert len(lens) == S.MAMBA_REQUESTS
        for n in lens:
            assert (n % chunk == 0 and 2 * chunk <= n <= hi) or 4 <= n < chunk


class _Row:
    def __init__(self, key, count):
        self.key, self.count = key, count


class _Prof:
    """A profiled window's stand-in: ``n_kernels`` device events and the
    host's matrix products."""

    def __init__(self, n_kernels, products):
        self._events = [type("E", (), dict(device_type="DeviceType.CUDA",
                                           name="kernel"))()
                        for _ in range(n_kernels)]
        self._rows = [_Row("aten::mm", products), _Row("aten::add", 99)]

    def events(self):
        return self._events

    def key_averages(self):
        return self._rows


@pytest.mark.parametrize("kernels, products, whole", [
    (3112, 193, True), (193, 193, True), (0, 193, False), (120, 193, False),
    (10, 0, False)])
def test_decode_trace_whole(kernels, products, whole):
    """A profiled tick's record, as ``drive`` makes it, is whole with a
    device event for every matrix product the host recorded."""
    prof = _Prof(kernels, products)
    r = dict(device_events=S.device_event_count(prof),
             products=S.matrix_products(prof))
    assert r["products"] == products
    assert S.decode_trace_whole(r) is whole


# The training phase ("lm train") rehearsed on the CPU: reduced configs,
# small shapes, the blocked attention's threshold lowered to 1024 tokens.
TRAIN_SMALL = dict(olmo=dict(shape=(2, 64), steps=3, long_shape=(1, 1024)),
                   cpu_pair=dict(shape=(1, 64)),
                   blocked=dict(shape=(1, 256, 4, 32), blocks=(128, 64)),
                   mamba=dict(spec=("mamba2-130m", (2, 64), 2)))


@pytest.fixture
def small_train(monkeypatch):
    from repro_torch.models import attention as A

    count_folds(monkeypatch)
    monkeypatch.setattr(A, "BLOCKED_THRESHOLD", 1024)


def test_train_path_on_the_cpu(small_train):
    """Every check of the phase passes on reduced configs: one fold launch
    a step in every run (the plain fold counted), no other kernel, finite
    steps, the long step through the blocked attention at block 1024, the
    pairs of steps within their tolerances, the descent and the replay."""
    r = S.train_path("cpu", reduced=True, **TRAIN_SMALL)
    o = r["olmo"]
    assert [s["step"] for s in o["steps"]] == [0, 1, 2]
    assert o["launches"] == dict(isla_fold=3, flash_attention=0,
                                 other_isla=0)
    assert o["long_blocked_calls"] == o["n_layers"]
    assert o["long_launches"]["isla_fold"] == 1
    assert r["cpu_pair"]["params"] <= S.TRAIN_TOL
    assert r["microbatch"]["launches"]["isla_fold"] == 2
    assert [b["block"] for b in r["blocked"]] == [128, 64]
    assert r["mamba"]["chunks"] == 2 and len(r["mamba"]["steps"]) == 2
    assert [m["moe_calls"] for m in r["moe"]] == [4, 2]
    d = r["descent"]
    assert d["drop"] > S.DESCENT["drop"] and d["replay_rel"] <= 1e-5
    assert len(d["losses"]) == S.DESCENT["steps"]
    assert r["fold_launches"] == 3 + 1 + 1 + 2 + 2 + 2 + 30 + 5
    for steps in (o["steps"], r["mamba"]["steps"]):
        assert all(s["plain_gap"] <= S.TELEMETRY_TOL for s in steps)
    assert d["plain_gap"] <= S.TELEMETRY_TOL
    # the loss telemetry's panes: 3 samples of 128 tokens (olmo-1b and
    # mamba2-130m at rate 0.02), 128 of the descent's 512 (rate 0.25)
    assert sorted(r["panes"]) == [3, 128]


def test_train_run_fails_on_a_step_without_a_fold(small_train):
    """With the telemetry off no fold runs: the phase's count of one
    launch a step fails."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state

    cfg = get_config("olmo-1b", reduced=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    stream = SyntheticStream(cfg, batch=2, seq=32, device="cpu")
    with pytest.raises(S.SmokeFailure, match="isla_fold launches"):
        S.train_run(cfg, S.train_config(telemetry_mode="off"), params,
                    init_opt_state(params), stream, 2, "cpu")
    # the olmo run itself, its config's telemetry turned off
    real = S.train_config
    S.train_config = lambda **kw: real(telemetry_mode="off", **kw)
    try:
        with pytest.raises(S.SmokeFailure, match="isla_fold launches"):
            S.train_olmo("cpu", reduced=True, **TRAIN_SMALL["olmo"])
    finally:
        S.train_config = real


def test_train_run_fails_on_a_fold_off_its_plain_version(small_train,
                                                        monkeypatch):
    """A fold whose moments part from its plain version's by 1% (standing
    in for a wrong kernel: the plain version, under ``PlainVersions``,
    stays right): the step's loss telemetry parts from its plain replay
    on the same per-token losses, and the run fails."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import isla_moments as K
    from repro_torch.kernels import ops
    from repro_torch.models import model as TM
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state

    real, on_gpu = ops.isla_moments, K.on_gpu

    def off(values, bounds, *a, **kw):
        out = real(values, bounds, *a, **kw)
        if K.on_gpu is not on_gpu:  # the plain version
            return out
        return torch.cat([out[:, :1], out[:, 1:] * 1.01], dim=1)

    monkeypatch.setattr(ops, "isla_moments", off)
    cfg = get_config("olmo-1b", reduced=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    stream = SyntheticStream(cfg, batch=8, seq=64, device="cpu")
    with pytest.raises(S.SmokeFailure, match="plain replay"):
        S.train_run(cfg, S.train_config(isla_rate=0.25), params,
                    init_opt_state(params), stream, 2, "cpu")


def test_train_descent_fails_on_a_checkpoint_that_drops_a_leaf(
        small_train, monkeypatch):
    """A save that leaves one leaf (the optimizer's first moment of the
    embedding) out of the checkpoint: the restore, and the phase, fail."""
    from repro_torch.train import checkpoint

    real = checkpoint.save

    def lossy(d, step, tree, *a, **kw):
        m = dict(tree["opt"].m)
        m.pop("embedding")
        return real(d, step, {"params": tree["params"],
                              "opt": tree["opt"]._replace(m=m)}, *a, **kw)

    monkeypatch.setattr(checkpoint, "save", lossy)
    with pytest.raises(S.SmokeFailure,
                       match=r"missing leaf \['opt'\]\.m\['embedding'\]"):
        S.train_descent("cpu")


def test_train_microbatch_fails_on_grads_summed_but_not_divided(
        small_train, monkeypatch):
    """A train step that sums its microbatches' grads and losses and does
    not divide them by the count: the grad norm, the moments and the loss
    part from the one-batch step's, and the phase's microbatch check
    fails."""
    from repro_torch.core.metrics import loss_stats
    from repro_torch.core.types import IslaParams
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.core.tree import tree_map

    real = TS.train_step

    def summed(cfg, tcfg, params, opt, batch, constraint=None):
        if tcfg.microbatches == 1:
            return real(cfg, tcfg, params, opt, batch, constraint)
        n = tcfg.microbatches
        mb = TS._split_microbatches(batch, n)
        grads, loss, per_tok = None, 0.0, []
        for i in range(n):
            l, aux, g = TS._value_and_grad(
                cfg, params, tree_map(lambda x: x[i], mb), constraint)
            g = tree_map(lambda x: x.float(), g)
            grads = g if grads is None else tree_map(
                lambda a, b: a + b, grads, g)
            loss = loss + l
            per_tok.append(aux["per_token_loss"])
        new_p, new_o, m = adamw_update(tcfg.opt, params, grads, opt)
        m["loss"] = loss
        m.update(loss_stats(torch.cat(per_tok), params=IslaParams(e=0.01),
                            rate=tcfg.isla_rate,
                            include_exact=tcfg.telemetry_exact))
        return new_p, new_o, m

    monkeypatch.setattr(TS, "train_step", summed)
    with pytest.raises(S.SmokeFailure, match="microbatches: (grad_norm|loss)"):
        S.train_microbatch("cpu")
    monkeypatch.setattr(TS, "train_step", real)
    assert S.train_microbatch("cpu")["params"] <= S.TRAIN_TOL


def test_check_step_pair_finds_a_wrong_moment():
    """The pair check reads every moment leaf: one element off by 1e-4 of
    its leaf's scale in ``v`` fails it."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import train_step

    cfg = get_config("olmo-1b", reduced=True).replace(param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    batch = SyntheticStream(cfg, batch=2, seq=32, device="cpu").batch_at(0)
    tcfg = S.train_config(lr=1e-3)
    want = train_step(cfg, tcfg, params, init_opt_state(params), batch)
    S.check_step_pair("same", 1e-3, 0.9, want, want, S.TRAIN_TOL)
    p, o, m = want
    v = dict(o.v)
    v["embedding"] = v["embedding"].clone()
    v["embedding"][3, 5] += 1e-4 * float(v["embedding"].abs().max())
    with pytest.raises(S.SmokeFailure, match=r"v\['embedding'\]"):
        S.check_step_pair("spoiled", 1e-3, 0.9, (p, o._replace(v=v), m),
                          want, S.TRAIN_TOL)


# The training CLI phase ("lm train cli") rehearsed on the CPU: reduced
# olmo-1b at 2 x 64 tokens, run A through the CLI in a child process.
CLI_SMALL = dict(reduced=True, shape=(2, 64))


def test_train_cli_path_on_the_cpu(small_train, tmp_path):
    """Run A commits steps 4 and 6; after the simulated crash run B
    resumes from step 4, removes the stray ``.tmp``, launches one fold a
    step (the plain fold counted) and repeats run A's steps 4 and 5 and
    its step-6 checkpoint bit for bit; the directory is removed."""
    r = S.train_cli_path("cpu", root=tmp_path / "cli", **CLI_SMALL)
    assert [s["step"] for s in r["a_steps"]] == list(range(S.CLI_STEPS))
    assert [s["step"] for s in r["b_steps"]] == [4, 5]
    assert r["launches"] == dict(isla_fold=2, flash_attention=0,
                                 other_isla=0)
    assert r["rows_max_rel_gap"] == 0 and r["checkpoint"]["max_rel_gap"] == 0
    assert r["checkpoint"]["step"] == S.CLI_STEPS
    assert len(r["restore_s"]) == len(r["submit_s"]) == 1
    assert r["tree_bytes"] >= r["checkpoint"]["bytes"]
    assert not (tmp_path / "cli").exists()
    S.print_train_cli(r)


@pytest.mark.parametrize("spoil, match", [
    ("latest", r"began \['step +0 loss .*'\], not \[resume\] from step 4"),
    ("clean", "stray .tmp was still there at its first step"),
    ("stale", "not \\[resume\\] from step 4")])
def test_train_cli_path_fails_on_a_wrong_resume(small_train, monkeypatch,
                                                tmp_path, spoil, match):
    """Run B that finds no checkpoint (and starts over from step 0), one
    that leaves the crash's ``.tmp`` behind, or one that resumes from
    another step than 4 (here 2: a checkpoint of step 2 slipped in): the
    phase fails, and still removes its directory."""
    from repro_torch.train import checkpoint as ckpt

    if spoil == "latest":
        monkeypatch.setattr(ckpt, "latest_step", lambda d: None)
    elif spoil == "clean":
        monkeypatch.setattr(ckpt, "clean_tmp", lambda d: 0)
    else:
        real = ckpt.latest_step
        monkeypatch.setattr(ckpt, "latest_step",
                            lambda d: min(real(d), 2) if real(d) else None)
        real_restore = ckpt.restore
        monkeypatch.setattr(ckpt, "restore", lambda d, step, *a, **kw:
                            real_restore(d, 4, *a, **kw))
    with pytest.raises(S.SmokeFailure, match=match):
        S.train_cli_path("cpu", root=tmp_path / "cli", **CLI_SMALL)
    assert not (tmp_path / "cli").exists()


def test_compare_ckpts_finds_one_changed_bit(tmp_path):
    """Two checkpoints that differ in one bf16 element: held bit for bit,
    the comparison fails on that leaf; held to a tolerance above the gap,
    it passes and reports the gap."""
    import numpy as np
    from repro_torch.train import checkpoint as ckpt

    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": torch.ones(4)}
    ckpt.save(str(tmp_path / "x"), 6, tree, fingerprint="f")
    tree["a"] = tree["a"].clone()
    tree["a"][1, 2] = 5.0 + 2 ** -5
    ckpt.save(str(tmp_path / "y"), 6, tree, fingerprint="f")
    x, y = tmp_path / "x" / "step_00000006", tmp_path / "y" / "step_00000006"
    assert S.compare_ckpts(x, x, 0.0)["max_rel_gap"] == 0
    with pytest.raises(S.SmokeFailure, match=r"leaf \['a'\]"):
        S.compare_ckpts(y, x, 0.0)
    gap = S.compare_ckpts(y, x, 1e-2)["max_rel_gap"]
    assert gap == pytest.approx(2 ** -5 / 5, rel=0.1)
    assert np.isfinite(gap)


# The sharded train step phase ("lm train mesh") rehearsed on the CPU:
# reduced olmo-1b at 2 x 64 tokens over a one-rank gloo mesh.
MESH_SMALL = dict(reduced=True, shape=(2, 64))


def test_train_mesh_path_on_the_cpu(small_train, monkeypatch, tmp_path):
    """Three meshless steps, then the same init and batches through
    ``build_step`` over a one-rank mesh (TP on, as olmo-1b's on the card):
    one fold a step (the plain fold counted), rows and final trees the
    meshless ones bit for bit; the step-2 checkpoint restored with
    ``shardings=`` steps to the same bits; the group is gone and the
    directory removed."""
    import torch.distributed as dist
    from repro_torch.sharding import specs as SP
    monkeypatch.setattr(SP, "TP_THRESHOLD", 0)
    r = S.train_mesh_path("cpu", root=tmp_path / "mesh", **MESH_SMALL)
    assert [s["step"] for s in r["steps"]] == list(range(S.MESH_STEPS))
    assert r["launches"] == dict(isla_fold=S.MESH_STEPS, flash_attention=0,
                                 other_isla=0)
    assert r["fold_launches"] == 2 * S.MESH_STEPS + 1
    # torch's CPU kernels may round one metric an ulp apart between two
    # runs in a process (``tests/test_torch_launch_train.py``): then the
    # phase has held the fp32 pair instead
    assert (r["rows_bit_equal"] and r["trees"]["differ"] == 0) or \
        r["fp32_pair"]["params"] <= S.TRAIN_TOL
    assert r["restored_step"]["loss"] == r["steps"][S.MESH_CKPT_STEP]["loss"]
    assert "(Replicate(), Shard(dim=2))" in r["placements"]
    assert not dist.is_initialized()
    assert not (tmp_path / "mesh").exists()
    r["folds"] = []
    S.print_train_mesh(r)


def test_train_mesh_fp32_pair_holds_on_the_cpu(small_train):
    """The fallback the phase takes when its bf16 steps are not bit for
    bit: a one-layer fp32 sharded step against the meshless one, held by
    ``check_step_pair``."""
    from repro_torch.launch.mesh import make_host_mesh
    with S.OneRankGroup("cpu"):
        mesh = make_host_mesh((1, 1), S.MESH_AXES)
        gaps = S.mesh_fp32_pair("cpu", True, (2, 64), mesh)
    assert gaps["params"] <= S.TRAIN_TOL


def test_train_mesh_fails_on_steps_that_part(small_train, monkeypatch,
                                             tmp_path):
    """A sharded step whose params part from the meshless ones (a spoiled
    update) is reported and sent to the fp32 pair, which then fails; the
    directory is still removed and the group destroyed."""
    import torch.distributed as dist
    from repro_torch.train import train_step as TS
    real = TS.make_jit_train_step

    def spoiled(*a, **kw):
        step = real(*a, **kw)

        def run(params, opt, batch):
            p, o, m = step(params, opt, batch)
            m["loss"] = m["loss"] * 1.01
            return p, o, m
        return run

    monkeypatch.setattr(TS, "make_jit_train_step", spoiled)
    import repro_torch.launch.train as TT
    monkeypatch.setattr(TT, "make_jit_train_step", spoiled)
    with pytest.raises(S.SmokeFailure, match="loss"):
        S.train_mesh_path("cpu", root=tmp_path / "mesh", **MESH_SMALL)
    assert not dist.is_initialized()
    assert not (tmp_path / "mesh").exists()


def test_train_mesh_cards_on_four_gloo_ranks(tmp_path):
    """The four-card part rehearsed on four gloo ranks of the CPU (reduced
    olmo-1b, TP off below its threshold): finite sharded steps (the
    plain fold launches nothing on the CPU), the collectives
    counted, the one-layer fp32 pair held, the drill from (2, 2) to
    (1, 2) at step 2 with its checkpoints; the directory removed."""
    r = S.train_mesh_cards(reduced=True, shape=(4, 64), root=tmp_path / "m",
                           device="cpu")
    assert r["grid"] == [2, 2] and len(r["steps"]) == S.MESH_STEPS
    assert r["fold_launches"] == [0] * S.MESH_CARDS     # the plain fold
    assert r["fp32_pair"]["params"] <= S.TRAIN_TOL
    assert any(v["count"] for st in r["steps"]
               for v in st["collectives"].values())
    assert [h["step"] for h in r["drill"]["history"]] == [0, 1, 2, 3]
    assert not (tmp_path / "m").exists()
    S.print_train_mesh(dict(
        shape=[4, 64], arch="olmo-1b", n_layers=2, d_model=128,
        dtype="float32", steps=[], meshless_steps=[], peak_bytes=None,
        meshless_peak_bytes=None, rows_bit_equal=True,
        trees=dict(differ=0, leaves=25), launches=dict(isla_fold=0),
        save_s=0.0, restore_s=0.0, placements=[], fp32_pair=None,
        cards=r))


DRY_SMALL = dict(reduced=True, cells=(("olmo-1b", "decode_32k", "single"),),
                 shape=(2, 64), prompt=30)


def test_dryrun_path_on_the_cpu(tmp_path):
    """The "dryrun" phase at reduced olmo-1b: a dry-run child (full
    olmo-1b decode on the fake (16, 16) mesh) exits 0 with its cell
    ``ok``; the real step and prefill count what their fake traces count
    (one ``isla_fold`` record, one ``flash_attention`` record a layer at
    row 8's operations); the one-rank sharded serving forward is the
    meshless one bit for bit."""
    import torch.distributed as dist
    r = S.dryrun_path("cpu", out_dir=tmp_path / "dry", **DRY_SMALL)
    cells = r["dry"]["cells"]
    assert list(cells) == ["olmo-1b/decode_32k/single"]
    c = cells["olmo-1b/decode_32k/single"]
    assert c["status"] == "ok" and c["devices"] == 256
    assert r["dry"]["card_bytes"] == []                 # no card here
    assert [k[0] for k in r["step"]["kernels"]] == ["isla_fold"]
    assert len(r["prefill"]["kernels"]) == 2            # reduced: 2 layers
    assert r["serve"]["bit_equal"] and r["serve"]["records"] == 2
    assert r["launches"] == dict(isla_fold=0, flash_attention=0)
    assert not dist.is_initialized()
    S.print_dryrun(r, 0.33)


def test_dryrun_yardstick_of_the_train_phase_step():
    """``model_flops`` of olmo-1b's 4 x 1024 step: 2.97e13, 0.030 s at
    989 TFLOP/s."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.roofline.analysis import model_flops
    mf = model_flops(get_config("olmo-1b"),
                     ShapeConfig("t", 1024, 4, "train"))
    assert mf == pytest.approx(2.97e13, rel=2e-3)
    assert mf / 989e12 == pytest.approx(0.030, rel=2e-2)


def test_dryrun_fails_on_a_count_that_parts(monkeypatch):
    """A real run whose kernel records part from the fake trace's (the
    fold's plain path records other bytes) fails ``count_pair``."""
    import torch
    from repro_torch.kernels import isla_moments as K
    real = K.fold_cost

    def spoiled(values, *a, **kw):
        flops, nbytes = real(values, *a, **kw)
        fake = type(values).__name__ == "FakeTensor"
        return flops, nbytes + (0 if fake else 4)

    monkeypatch.setattr(K, "fold_cost", spoiled)
    from repro_torch.kernels import ops
    with pytest.raises(S.SmokeFailure, match="parts from the fake"):
        S.count_pair("spoiled", lambda v: ops.isla_moments(
            v, [0.0, 1.0, 2.0, 3.0]), (torch.randn(2, 300),), "cpu")


def test_dryrun_cells_fail_on_a_failing_child(tmp_path, monkeypatch):
    """A child whose cell fails (an arch the configs do not have) exits 1,
    and the phase fails."""
    with pytest.raises(S.SmokeFailure, match="exit 1"):
        S.dryrun_cells((("no-such-arch", "train_4k", "single"),),
                       tmp_path / "dry", on_card=False)


def test_collective_counter_sees_dtensor_redistributions():
    """``CollectiveCounter`` counts the collectives DTensor issues inside
    an op's dispatch (the redistribution of an operand split another
    way), not only explicit ones; on a fake four-rank group."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        mesh = init_device_mesh("cpu", (4,))
        x = DTensor.from_local(torch.randn(8, 2), mesh, [Shard(1)],
                               run_check=False)
        w = DTensor.from_local(torch.randn(2, 8), mesh, [Shard(0)],
                               run_check=False)
        with S.CollectiveCounter() as cc:
            y = x + w
    assert y.shape == (8, 8)
    assert sum(v["count"] for v in cc.counts.values()) >= 1
