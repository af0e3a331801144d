"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same device inputs, and the slice on ``cuda`` against the
slice on the CPU.  Marked ``cuda``: they skip where there is no card (the
card is looked for inside the fixture, never at import).  Run on a GPU
machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.core as TC
from repro_torch.core import distributed as TD
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import isla_moments as K
from repro_torch.kernels import ref
from _torch_pilot_cases import CASES as PILOT_CASES
from _torch_pilot_cases import SIZES as PILOT_SIZES
from _torch_pilot_cases import run as pilot_run
from _torch_sketch_cases import SKETCH_CASES, sketch_case
from _torch_tagged_cases import CASES as TAGGED_CASES
from _torch_tagged_cases import (RUN_CASES, WRONG_TABLES, host_fold,
                                 run_case, tagged_case, wrong_table)
import _torch_mesh_cases as MC

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fold_case(case, dev, rng):
    # "sliced": compacted cells longer than FOLD_SLICE samples, summed
    # slice by slice and combined by the second kernel.
    n_b, q, g = (6, 3 * K.FOLD_SLICE + 100, 5) if case == "sliced" else \
        (37, 200, 5)
    vmask = np.arange(q)[None, :] < rng.integers(1, q, size=n_b)[:, None]
    v = np.where(vmask, rng.normal(1.0, 0.2, (n_b, q)), 0.0)
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa
        np.asarray(a), dtype=dt, device=dev).contiguous()
    kw = dict(pad=t(vmask))
    bounds = t([0.6, 0.9, 1.1, 1.4])
    n_out = n_b
    if case in ("grouped", "predicated", "compacted", "sliced"):
        kw.update(gid=t(np.where(vmask, rng.integers(0, g, (n_b, q)), 0),
                        torch.int32), n_groups=g)
        n_out = g * n_b
    if case in ("predicated", "compacted", "sliced"):
        kw["valid"] = t(np.where(vmask, rng.random((n_b, q)) < 0.6, 0.0))
    if case == "affine":
        kw["affine"] = (1.3, -0.07)
        bounds = t(np.asarray([0.6, 0.9, 1.1, 1.4])[None]
                   + rng.uniform(-0.05, 0.05, (n_b, 1)))
    if case in ("compacted", "sliced"):
        idx = rng.permutation(2 * n_out)[:n_out] - n_out // 2
        kw["cell_idx"] = t(idx, torch.int32)
        n_out = 2 * n_out
    values = t(v, torch.bfloat16 if case == "bf16" else torch.float32)
    return values, bounds, n_out, kw


@pytest.mark.parametrize("case", ["plain", "grouped", "predicated",
                                  "affine", "compacted", "bf16", "sliced"])
def test_fold_kernel_matches_plain_version(cuda, case):
    rng = np.random.default_rng(0)
    values, bounds, n_out, kw = _fold_case(case, cuda, rng)
    prior = torch.as_tensor(rng.uniform(0, 3, (n_out, 11)),
                            dtype=torch.float32, device=cuda)
    outs = []
    for launch in (K.isla_fold, K.isla_fold, ref.isla_fold_ref):
        st = prior.clone()
        launch(values, bounds, st[:, 0:4], st[:, 4:8], st[:, 8:11], **kw)
        torch.cuda.synchronize()
        outs.append(st)
    assert torch.equal(outs[0], outs[1])  # fixed order: identical bits
    np.testing.assert_allclose(outs[0].cpu().numpy(), outs[2].cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("stride", [1, 3])
def test_batched_wrapper_kernel_matches_plain_version(cuda, stride):
    rng = np.random.default_rng(1)
    x = rng.normal(100, 20, size=(9, 64 * 6, 128)).astype(np.float32)
    b = (np.asarray([60.0, 90.0, 110.0, 140.0])[None]
         + rng.uniform(-5, 5, (9, 1))).astype(np.float32)
    got = K.isla_moments_batched(torch.as_tensor(x, device=cuda),
                                 torch.as_tensor(b, device=cuda), tm=64,
                                 stride=stride)
    want = K.isla_moments_batched(torch.as_tensor(x), torch.as_tensor(b),
                                  tm=64, stride=stride)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5)


@pytest.mark.parametrize("entry", ["isla_moments", "ops.isla_moments"])
def test_million_sample_cell_matches_plain_version(cuda, entry):
    """One cell of 1,024,000 samples (the one-cell wrapper at the serving
    loop's widest pane): the kernel's two-level per-thread sums stay
    within rel 1e-5 of its plain version and of the float64 sums."""
    from repro_torch.kernels import ops

    x = np.random.default_rng(4).normal(100, 20, (8000, 128))
    x = x.astype(np.float32)
    call = K.isla_moments if entry == "isla_moments" else ops.isla_moments
    got = call(torch.as_tensor(x, device=cuda), (60.0, 90.0, 110.0, 140.0),
               tm=8).cpu().numpy()
    want = call(torch.as_tensor(x), (60.0, 90.0, 110.0, 140.0),
                tm=8).numpy()
    v = x.astype(np.float64).reshape(-1)
    exact = []
    for lo, hi in ((60.0, 90.0), (110.0, 140.0)):
        m = (v > lo) & (v < hi)
        exact.append([m.sum(), v[m].sum(), (v[m] ** 2).sum(),
                      (v[m] ** 3).sum()])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(exact), rtol=1e-5)


@pytest.mark.parametrize("n", [1, 255, 4097, 1 << 20])
def test_pilot_kernel_matches_plain_version(cuda, n):
    x = torch.as_tensor(np.random.default_rng(2).normal(-3, 2, n),
                        dtype=torch.float32, device=cuda)
    c = x[:1].clone()
    for center in (None, c):
        got = K.pilot_stats(x, center=center)
        want = ref.pilot_stats_ref(x, center)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n", PILOT_SIZES + (10_000_000,))
@pytest.mark.parametrize("case", PILOT_CASES)
def test_pilot_moments_kernel_matches_plain_version(cuda, case, n):
    """``pilot_moments`` on the card (one launch, each sample read once)
    against its float64 plain version on the same card tensor: count and
    min exact, mean, M2 and sigma within rel 1e-5; two runs give identical
    bits; ``pilot_stats`` (the same launch, the TPU kernel's form) within
    rel 1e-5 of the form derived from the plain moments."""
    x = torch.as_tensor(pilot_run(case, n), dtype=torch.float32,
                        device=cuda)
    got = K.pilot_moments(x)
    again = K.pilot_moments(x)
    want = ref.pilot_moments_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g[0] == w[0] == n and g[3] == w[3]
    np.testing.assert_allclose(g[[1, 2, 4]], w[[1, 2, 4]], rtol=1e-5,
                               atol=0)
    stats = K.pilot_stats(x).cpu().numpy()
    derived = ref.stats_from_moments(want).cpu().numpy()
    assert stats[0] == derived[0] and stats[3] == derived[3]
    np.testing.assert_allclose(stats, derived, rtol=1e-5)


def test_pilot_kernel_streams_do_not_mix(cuda):
    """Pilots in flight on two streams at once, each over a grid of many
    blocks (so each takes tickets), give the same bits as one at a time:
    each stream has its own workspace."""
    a = torch.as_tensor(pilot_run("far", 1_000_000), dtype=torch.float32,
                        device=cuda)
    b = torch.as_tensor(pilot_run("normal", 300_007), dtype=torch.float32,
                        device=cuda)
    want = (K.pilot_moments(a), K.pilot_moments(b))
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = ([], [])
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(20):
        for k, (s, x) in enumerate(zip(streams, (a, b))):
            with torch.cuda.stream(s):
                outs[k].append(K.pilot_moments(x))
    torch.cuda.synchronize()
    for w, got in zip(want, outs):
        assert all(torch.equal(g, w) for g in got)
    # The default stream's workspace and one for each of the two streams.
    assert len([k for k in K._pilot_workspaces if k[0] == a.device.index
                and k[1] in {s.cuda_stream for s in streams}]) == 2


PROFILE_TRIES = 3  # windows a launch check takes when records go astray


def _profiled_kernels(fn, launches):
    """The device kernels ``fn`` runs, by name, from the profiler (copies,
    fills and the spin left out), after ``K.reset_launch_counts()``.  On
    the card the profiler can leave out a window's first kernel, or all of
    them, and a trace that lost kernels cannot show which ran: the window
    opens with a short device spin, and is taken again, up to
    ``PROFILE_TRIES`` windows, while it holds fewer kernels than
    ``launches()`` (the wrappers' counts) says ran."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(200_000)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(e.device_type).endswith("CUDA")
                 and "spin_kernel" not in e.name
                 and "memcpy" not in e.name.lower()
                 and "memset" not in e.name.lower()]
        if len(names) >= launches():
            break
    return names


@pytest.mark.parametrize("n", [1, 1000, 1_000_000, 10_000_000])
def test_pilot_is_one_launch_a_call(cuda, n):
    """Every pilot call is one ``__global__`` launch at every run length:
    the counter and the profiler's device events agree, and the device
    pilot launches no other kernel (its upload and readback are copies)."""
    v = pilot_run("normal", n)
    x = torch.as_tensor(v, dtype=torch.float32, device=cuda)
    c = x[:1].clone()

    def calls():
        K.pilot_moments(x)
        K.pilot_stats(x, center=c)
        TD.pilot_stats_device(v, device="cuda")

    calls()
    kernels = _profiled_kernels(calls, lambda: K.pilot_stats.launches)
    assert K.pilot_stats.launches == 3
    assert len(kernels) == 3 and all("pilot_moments_kernel" in k
                                     for k in kernels), kernels


@pytest.mark.parametrize("n", [1, 1000, 100_000, 1_000_000])
@pytest.mark.parametrize("case", PILOT_CASES)
def test_device_pilot_on_cuda_matches_cpu(cuda, case, n):
    """``pilot_stats_device`` on the card against the same call on the
    CPU (the plain version): sketch0 and sigma within rel 1e-5, min
    equal."""
    v = pilot_run(case, n)
    mean, sigma, lo = TD.pilot_stats_device(v, device="cuda")
    c_mean, c_sigma, c_lo = TD.pilot_stats_device(v, device="cpu")
    assert mean == pytest.approx(c_mean, rel=1e-5)
    assert sigma == pytest.approx(c_sigma, rel=1e-5)
    assert lo == c_lo


def test_executor_on_cuda_matches_cpu(cuda):
    """The whole device route on the card against the same route on the
    CPU (the plain versions), and both kernels counted on the way."""
    rng = np.random.default_rng(3)
    tables = []
    for _ in range(6):
        g = rng.integers(0, 3, size=2000)
        tables.append({"value": rng.normal(90 + 3.0 * g, 15.0),
                       "region": g.astype(np.float64),
                       "flag": rng.integers(0, 2, 2000).astype(np.float64)})
    flag = TC.Predicate(column="flag", eq=1.0)
    qs = [TC.IslaQuery(e=0.5, agg="AVG"),
          TC.IslaQuery(e=0.5, agg="AVG", group_by="region", where=flag),
          TC.IslaQuery(e=0.5, agg="VAR")]
    answers = {}
    for dev in ("cpu", "cuda"):
        ex = TC.MultiQueryExecutor([TC.table_sampler(t) for t in tables],
                                   [10 ** 6] * 6, params=TC.IslaParams(e=0.5),
                                   group_domains={"region": 3}, device=dev)
        K.reset_launch_counts()
        answers[dev] = [ex.run(qs, np.random.default_rng(5 + k),
                               incremental=True, route="device")
                        for k in range(2)]
        if dev == "cuda":
            # One cold plan, one device pilot, one pilot kernel launch.
            assert K.isla_fold.launches > 0 and K.pilot_stats.launches == 1
    for c_run, g_run in zip(answers["cpu"], answers["cuda"]):
        for c, g in zip(c_run, g_run):
            assert g.value == pytest.approx(c.value, rel=2e-3)
            assert g.new_samples == c.new_samples


@pytest.mark.parametrize("case", SKETCH_CASES)
def test_sketch_kernel_matches_plain_version(cuda, case):
    """``isla_sketch`` on the card against its plain version on the same
    card tensors and the host twin: registers bit for bit (tolerance 0),
    and a repeat launch gives identical bits."""
    panes, kw, prior, want = sketch_case(case, np.random.default_rng(5),
                                         cuda)
    outs = []
    for launch in (K.isla_sketch, K.isla_sketch, ref.isla_sketch_ref):
        regs = prior.clone()
        launch(*panes, regs, **kw)
        torch.cuda.synchronize()
        outs.append(regs)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])
    assert np.array_equal(outs[0].cpu().numpy(), want)


def test_sketch_counter_counts_launches(cuda):
    """``isla_sketch.launches`` counts kernel launches on the card and
    nothing else: not the plain version, not a call on CPU tensors."""
    panes, kw, prior, _ = sketch_case("grouped", np.random.default_rng(6),
                                      cuda)
    K.reset_launch_counts()
    regs = prior.clone()
    for _ in range(3):
        K.isla_sketch(*panes, regs, **kw)
    ref.isla_sketch_ref(*panes, regs, **kw)
    cpu = [t.cpu() for t in panes]
    K.isla_sketch(*cpu, prior.cpu(), **{
        k: (v.cpu() if isinstance(v, torch.Tensor) else v)
        for k, v in kw.items()})
    torch.cuda.synchronize()
    assert K.isla_sketch.launches == 3


def test_fused_sketch_wrapper_on_cuda_matches_cpu(cuda):
    """The Pallas-signature ``isla_fused_sketch`` on the card against the
    same call on the CPU: registers bit for bit, moments and partials
    within rel 1e-5."""
    rng = np.random.default_rng(7)
    n, rows = 6, 128
    vals = np.round(rng.normal(100, 20, (n, rows, 128))).astype(np.float32)
    bits = np.round(rng.normal(0, 50, (n, rows, 128))).view(np.uint64)
    hi = (bits >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    valid = (rng.random((n, rows, 128)) < 0.9).astype(np.int32)
    prior = rng.uniform(0, 50, (n, 2, 4)).astype(np.float32)
    prior_regs = rng.integers(0, 10, (n, 32, 128)).astype(np.uint8)
    out = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(a.copy(), device=dev)  # noqa
        out[str(dev)] = K.isla_fused_sketch(
            t(vals), t(np.asarray([60.0, 90.0, 110.0, 140.0], np.float32)),
            t(prior), t(prior_regs), t(hi), t(lo), t(valid), 100.0,
            TC.IslaParams(e=0.5), tm=64)
    c, g = out["cpu"], out[str(cuda)]
    assert torch.equal(g[1].cpu(), c[1])
    np.testing.assert_allclose(g[0].cpu().numpy(), c[0].numpy(), rtol=1e-5)
    np.testing.assert_allclose(g[2].cpu().numpy(), c[2].numpy(), rtol=1e-5)


def test_distinct_executor_on_cuda_matches_cpu(cuda):
    """COUNT DISTINCT on the device route, on the card against the CPU:
    identical distinct answers and draw ledgers, launched through
    ``isla_sketch``."""
    rng = np.random.default_rng(8)
    tables = []
    for _ in range(6):
        g = rng.integers(0, 3, size=2000)
        tables.append({"value": 90.0 + 0.05 * (rng.integers(0, 600, 2000)
                                               % (200 * (g + 1))),
                       "region": g.astype(np.float64),
                       "flag": rng.integers(0, 2, 2000).astype(np.float64)})
    flag = TC.Predicate(column="flag", eq=1.0)
    qs = [TC.IslaQuery(e=0.5, agg="count_distinct"),
          TC.IslaQuery(e=0.5, agg="count_distinct", where=flag),
          TC.IslaQuery(e=0.5, agg="count_distinct", group_by="region"),
          TC.IslaQuery(e=0.5, agg="count_distinct", group_by="region",
                       where=flag)]
    answers = {}
    for dev in ("cpu", "cuda"):
        ex = TC.MultiQueryExecutor([TC.table_sampler(t) for t in tables],
                                   [10 ** 6] * 6, params=TC.IslaParams(e=0.5),
                                   group_domains={"region": 3}, device=dev)
        K.reset_launch_counts()
        answers[dev] = [ex.run(qs, np.random.default_rng(5 + k),
                               incremental=True, route="device")
                        for k in range(2)]
        if dev == "cuda":
            assert K.isla_sketch.launches == K.isla_fold.launches > 0
    for c_run, g_run in zip(answers["cpu"], answers["cuda"]):
        for c, g in zip(c_run, g_run):
            assert (g.value, g.new_samples, g.sample_size) == (
                c.value, c.new_samples, c.sample_size)
            if c.groups is not None:
                assert [x.value for x in g.groups] == [x.value
                                                       for x in c.groups]


# ---------------------------------------------------------------------------
# The stacked fold and merge: every key of a dense tick in one launch.
# ---------------------------------------------------------------------------

STACK_CASES = {
    "loop": dict(stack="loop", n_b=1000, q=1024),
    "loop_compacted": dict(stack="loop", n_b=1000, q=1024, compacted=True),
    "loop_bf16": dict(stack="loop", n_b=1000, q=1024, bf16=True),
    "groups_1_1_3_3": dict(n_b=37, q=300),
    "sliced": dict(n_b=4, q=2 * K.FOLD_SLICE + 100),
    # 520 cells a row: the fold takes its partial rows in batches, and the
    # 300-group pane is scanned, not bucketed; "wide_long" stages its rows
    # in two tiles per batch.
    "wide": dict(stack="wide", n_b=20, q=300),
    "wide_long": dict(stack="wide", n_b=4, q=2000),
}


def _rel_err(got, want) -> float:
    return float(((got.double() - want.double()).abs()
                  / want.double().abs().clamp_min(1.0)).max())


@pytest.mark.parametrize("case", list(STACK_CASES))
def test_fold_stack_kernel_matches_plain_version(cuda, case):
    """``fold_panes`` on the card (one ``isla_fold`` launch for every key)
    gives identical bits twice and comes within rel 1e-5 of the stacked
    plain version, run on the CPU on the same inputs: the CPU is the
    oracle (the card's plain version once contracted a 65,636-sample
    row's GROUP BY one-hot through cuBLAS and landed 1.2e-4 from the
    CPU's sum, where the kernel lands 8e-7 from it)."""
    from _torch_stack_cases import fold_stacked, stack_case

    c = stack_case(np.random.default_rng(9), cuda, **STACK_CASES[case])
    outs = [c["prior"].clone() for _ in range(2)]
    fold_stacked(outs[0], c["panes"], c["kw"])
    fold_stacked(outs[1], c["panes"], c["kw"])
    host = stack_case(np.random.default_rng(9), "cpu", **STACK_CASES[case])
    want = host["prior"].clone()
    fold_stacked(want, host["panes"], host["kw"])
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])  # fixed order: identical bits
    assert _rel_err(outs[0].cpu(), want) <= 1e-5
    assert not torch.equal(outs[0], c["prior"])


@pytest.mark.parametrize("case", ["cold", "warm", "compacted"])
def test_sketch_stack_kernel_matches_plain_version(cuda, case):
    """``sketch_panes`` on the card (one ``isla_sketch`` launch for every
    key) against the stacked plain version on the same card tensors, bit
    for bit: on a cold plane, on a warm one (most lanes take the skip
    path) and compacted; merging the same pane again changes nothing."""
    from _torch_stack_cases import sketch_stacked, stack_case

    c = stack_case(np.random.default_rng(10), cuda, stack="loop", n_b=1000,
                   q=1024, compacted=case == "compacted")
    regs0 = (torch.zeros_like(c["regs0"]) if case == "cold"
             else c["regs0"])
    _, pad, gids, valids, _ = c["panes"]
    kw = c["kw"]
    got, again, want = regs0.clone(), regs0.clone(), regs0.clone()
    sketch_stacked(got, c["bits"], c["panes"], kw)
    sketch_stacked(again, c["bits"], c["panes"], kw)
    ref.isla_sketch_stack_ref(
        c["bits"], want, keys=TC.distributed.stack_keys(
            c["bits"].shape[0], kw["n_groups_list"], kw["gid_slots"],
            kw["valid_slots"]),
        pad=pad, gid_panes=gids, valid_panes=valids,
        cell_idx=None if kw["active_cells"] is None
        else kw["active_cells"][0])
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    assert not torch.equal(got, regs0)
    sketch_stacked(again, c["bits"], c["panes"], kw)  # every lane skips
    torch.cuda.synchronize()
    assert torch.equal(again, want)


@pytest.mark.parametrize("n_keys", [4, K.MAX_KEYS + 4])
def test_panes_launch_each_kernel_once_per_call(cuda, n_keys):
    """A ``fold_panes`` / ``sketch_panes`` call of up to ``MAX_KEYS`` keys
    launches ``isla_fold`` / ``isla_sketch`` exactly once (a longer stack
    once per ``MAX_KEYS``)."""
    from _torch_stack_cases import fold_stacked, sketch_stacked, stack_case

    c = stack_case(np.random.default_rng(11), cuda, stack="loop", n_b=50,
                   q=256)
    kw = {f: (v * 6)[:n_keys] if isinstance(v, tuple) else v
          for f, v in c["kw"].items()}
    n_cells = sum(kw["n_groups_list"]) * c["n_b"]
    state = torch.zeros((n_cells, 11), dtype=torch.float32, device=cuda)
    regs = torch.zeros((n_cells, K.N_REGS), dtype=torch.uint8, device=cuda)
    K.reset_launch_counts()
    fold_stacked(state, c["panes"], kw)
    sketch_stacked(regs, c["bits"], c["panes"], kw)
    torch.cuda.synchronize()
    per = -(-n_keys // K.MAX_KEYS)
    assert (K.isla_fold.launches, K.isla_sketch.launches) == (per, per)


# ---------------------------------------------------------------------------
# flash_attention: the LM prefill's kernel, and the slice on the card.
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _to(tree, dev):
    """A params tree (dicts and lists of tensors) moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("groups", [1, 2, 3, 6, 7, 8])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 200, 256, 500,
                               1966])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, dtype, hd, s, groups):
    """The kernel against its plain version on the same card tensors: fp32
    at the reference sweep's 1e-4, bf16 output at 2e-2 (one to two bf16
    ulps on O(1) values).  S runs over the edges of the 64-row query unit
    and of the 128-key tile (1, 63-65, 127-129), ragged (200), a multiple
    of both (256), olmo-1b's longest prefill (1966) and 500, where the
    units pair long with short on the 132 SMs (up to 256 one unit a job,
    at 1966 pairs of one extent); groups 2, 6 and 7
    are jamba's, grok's and arctic's layouts (7: an odd number of q heads a
    KV head, 28 q heads), 8 paligemma's MQA at hd 256; a repeat launch
    gives identical bits."""
    rng = np.random.default_rng(hd + s + groups)
    bh = 24 if 24 % groups == 0 else 4 * groups

    def t(shape, scale):
        return torch.as_tensor(rng.normal(size=shape) * scale,
                               dtype=dtype, device=cuda)

    q = t((bh, s, hd), 0.3)
    k = t((bh // groups, s, hd), 0.3)
    v = t((bh // groups, s, hd), 1.0)
    got = FA.flash_attention(q, k, v, groups=groups)
    again = FA.flash_attention(q, k, v, groups=groups)
    want = ref.flash_attention_ref(q, k, v, groups=groups)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bh, s, hd)
    assert torch.equal(got, again)
    err = float((got.double() - want.double()).abs().max())
    assert err <= FLASH_TOL[dtype], err


def test_flash_kernel_refuses_unsupported_head_dim(cuda):
    """A CUDA tensor of a head_dim the kernel has no instantiation for
    raises; it never falls back to the plain version."""
    q = torch.zeros(2, 64, 48, dtype=torch.bfloat16, device=cuda)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention(q, q, q)
    assert FA.flash_attention.launches == 0


def test_flash_counter_counts_launches(cuda):
    """``flash_attention.launches`` counts kernel launches on the card and
    nothing else: not the plain version, not a call on CPU tensors."""
    q = torch.randn(4, 100, 64, device=cuda)
    K.reset_launch_counts()
    for _ in range(3):
        FA.flash_attention(q, q, q)
    ref.flash_attention_ref(q, q, q)
    FA.flash_attention(q.cpu(), q.cpu(), q.cpu())
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == 3


def test_lm_scheduler_on_cuda_launches_flash_and_matches_cpu(cuda):
    """Reduced olmo-1b (fp32 params, bf16 cache) through the slot
    scheduler on the card: one flash launch per admitted prefill per
    layer, and the same generated tokens as the same weights on the
    CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.serve import BatchScheduler, Request

    cfg = get_config("olmo-1b", reduced=True).replace(param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab, n)]
               for n in (5, 70, 9, 130, 64)]

    finished = {}
    for dev in ("cpu", "cuda"):
        sched = BatchScheduler(cfg, _to(params, dev), batch_slots=2,
                               max_seq=160, eos_id=-1)
        for rid, pr in enumerate(prompts):
            sched.submit(Request(rid=rid, prompt=pr, max_new=6))
        K.reset_launch_counts()
        sched.run_until_drained()
        torch.cuda.synchronize()
        if dev == "cuda":
            assert FA.flash_attention.launches == len(prompts) * cfg.n_layers
        else:
            assert FA.flash_attention.launches == 0
        finished[dev] = [(r.rid, r.generated) for r in sched.finished]
    assert finished["cuda"] == finished["cpu"]


@pytest.mark.parametrize("head_dim", [None, 256])
def test_paligemma_prefix_prefill_on_cuda_matches_cpu(cuda, head_dim):
    """Reduced paligemma-3b (MQA, rmsnorm_1p, tanh-GELU, tied embeddings;
    fp32 params, bf16 cache), once at its reduced head_dim 32 and once at
    paligemma's 256: a prefill of 16 prefix embeddings and 40 tokens
    through ``serve_prefill`` and 4 ``serve_decode`` steps on the card
    against the same weights on the CPU (prefill logits 1e-4; decode
    1e-3, as an entry of the bf16 cache may round one ulp apart), with one
    flash launch per layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.models.frontends import synth_frontend_embeds

    cfg = get_config("paligemma-3b", reduced=True).replace(
        param_dtype="float32")
    if head_dim is not None:
        cfg = cfg.replace(head_dim=head_dim)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    prefix = synth_frontend_embeds(cfg, 2, torch.Generator().manual_seed(1))
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 44))
    S = cfg.frontend_len + 40

    logits = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        t = torch.as_tensor(toks, device=dev)
        cache = TM.init_cache(cfg, 2, S + 4, device=dev)
        K.reset_launch_counts()
        out = [TM.serve_prefill(cfg, p, {"tokens": t[:, :40],
                                         "prefix_embeds": prefix.to(dev)},
                                cache)[0]]
        torch.cuda.synchronize()
        assert FA.flash_attention.launches == (
            cfg.n_layers if dev == "cuda" else 0)
        for i in range(4):
            pos = torch.full((2,), S + i, device=dev)
            out.append(TM.serve_decode(cfg, p, t[:, 40 + i:41 + i], pos,
                                       cache)[0])
        logits[dev] = [o.float().cpu() for o in out]
    for step, (c, g) in enumerate(zip(logits["cpu"], logits["cuda"])):
        tol = 1e-4 if step == 0 else 1e-3
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, c, rtol=tol, atol=tol)


def _moe_near_tie(probs, a, b) -> bool:
    """Two fp32 gates a router product summed in another order may swap:
    within rel 1e-5 of each other (the card's and the CPU's fp32 router
    logits lie ~1e-6 apart)."""
    pa, pb = float(probs[a]), float(probs[b])
    return abs(pa - pb) <= 1e-5 * max(pa, pb)


@pytest.mark.parametrize("arch", ["arctic-480b", "grok-1-314b"])
def test_moe_on_cuda_matches_cpu_without_sync(cuda, arch, monkeypatch):
    """Reduced arctic-480b and grok-1-314b, fp32 params, on the card
    against the same weights on the CPU, with no host sync anywhere in
    the model (``set_sync_debug_mode("error")``): ``apply_moe`` on three
    groups of 64 tokens, on 50 tokens (one group) and on a 4-slot decode
    batch, its dispatch the CPU's but for counted near-ties and its output
    within 1e-5 on every token routed alike; then ``serve_prefill`` of 70
    and 64 tokens and 3 ``serve_decode`` steps (logits 1e-4 prefill, 1e-3
    decode, as an entry of the bf16 cache may round one ulp apart), one
    flash launch per layer of a prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TT

    cfg = get_config(arch, reduced=True).replace(param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    layer0 = TT.group_params(params["blocks"][0], 0)["moe"]
    moe_p = {d: _to(layer0, d) for d in ("cpu", "cuda")}
    rng = np.random.default_rng(5)
    seen, routes = [], {}
    real = M._route

    def spy(cfg_, logits):
        out = real(cfg_, logits)
        seen.append((logits, out[0]))
        return out

    monkeypatch.setattr(M, "_route", spy)
    flipped = 0
    for shape in ((2, 96), (1, 50), (4, 1)):
        x = torch.as_tensor(rng.normal(size=shape + (cfg.d_model,)),
                            dtype=torch.float32)
        y = {}
        for dev in ("cpu", "cuda"):
            xd = x.to(dev)
            M.apply_moe(cfg, moe_p[dev], xd)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                y[dev] = M.apply_moe(cfg, moe_p[dev], xd)[0]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            y[dev], routes[dev] = y[dev].cpu(), seen[-1]
        (l_h, d_h), (_, d_c) = routes["cpu"], routes["cuda"]
        p_h, d_c = torch.softmax(l_h, -1), d_c.cpu()
        same = (d_h == d_c).all(-1).all(-1)                      # (G, Tg)
        for g, t in (~same).nonzero().tolist():
            kh = set(d_h[g, t].sum(-1).nonzero()[:, 0].tolist())
            kc = set(d_c[g, t].sum(-1).nonzero()[:, 0].tolist())
            if kh - kc and kc - kh:
                assert _moe_near_tie(p_h[g, t], min(kh - kc),
                                     min(kc - kh)), (shape, g, t)
                flipped += 1
        G, tg = same.shape
        ok = same.reshape(-1)
        torch.testing.assert_close(y["cuda"].reshape(G * tg, -1)[ok],
                                   y["cpu"].reshape(G * tg, -1)[ok],
                                   rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(M, "_route", real)
    print(f"{arch}: {flipped} near-tie tokens took another expert")

    toks = rng.integers(0, cfg.vocab, (2, 74))
    logits = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        out = []
        for b, n in ((0, 70), (1, 64)):
            t = torch.as_tensor(toks[b:b + 1], device=dev)
            cache = TM.init_cache(cfg, 1, n + 3, device=dev)
            K.reset_launch_counts()
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                out.append(TM.serve_prefill(cfg, p, {"tokens": t[:, :n]},
                                            cache)[0])
                for i in range(3):
                    pos = torch.full((1,), n + i, device=dev)
                    out.append(TM.serve_decode(cfg, p, t[:, n + i:n + i + 1],
                                               pos, cache)[0])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            assert FA.flash_attention.launches == (
                cfg.n_layers if dev == "cuda" else 0)
        logits[dev] = [o.float().cpu() for o in out]
    for step, (c, g) in enumerate(zip(logits["cpu"], logits["cuda"])):
        tol = 1e-4 if step % 4 == 0 else 1e-3
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, c, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_mamba_on_cuda_matches_cpu_without_sync(cuda, arch):
    """Reduced mamba2-130m and jamba, fp32 params and an fp32 cache, on
    the card against the same weights on the CPU, with no host sync
    anywhere in the model (``set_sync_debug_mode("error")``): a prefill
    of 2 prompts x 64 tokens (two SSD chunks of 32) and 3 decode steps,
    logits and every Mamba position's h and conv within 1e-4; jamba's
    prefill makes one flash launch (its one attention position),
    mamba2-130m none, and neither an ISLA launch."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM

    cfg = get_config(arch, reduced=True).replace(param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 67))
    n_attn = sum(cfg.block_is_attention(i) for i in range(cfg.n_layers))
    out, caches = {}, {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        t = torch.as_tensor(toks, device=dev)
        cache = TM.init_cache(cfg, 2, 67, dtype=torch.float32, device=dev)
        K.reset_launch_counts()
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            logits = [TM.serve_prefill(cfg, p, {"tokens": t[:, :64]},
                                       cache)[0]]
            for i in range(3):
                pos = torch.full((2,), 64 + i, device=dev)
                logits.append(TM.serve_decode(cfg, p, t[:, 64 + i:65 + i],
                                              pos, cache)[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert FA.flash_attention.launches == (
            n_attn if dev == "cuda" else 0)
        assert K.isla_fold.launches + K.pilot_stats.launches \
            + K.isla_sketch.launches == 0
        out[dev] = [o.float().cpu() for o in logits]
        caches[dev] = [{k: v.float().cpu() for k, v in c.items()}
                       for c in cache]
    for step, (c, g) in enumerate(zip(out["cpu"], out["cuda"])):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-4,
                                   msg=f"step {step}")
    for c, g in zip(caches["cpu"], caches["cuda"]):
        for name in ("h", "conv"):
            if name in c:
                torch.testing.assert_close(g[name], c[name], rtol=1e-4,
                                           atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", TAGGED_CASES)
def test_tagged_fold_kernel_matches_plain_version(cuda, case, dtype):
    """``isla_tagged_fold`` on the card against its plain version on CPU
    copies of the same tensors: bit for bit (tolerance 0) in both types,
    the host carry fold's bits in float64; two launches give identical
    bits and are the only two the counter sees."""
    values, seg, bounds, prior = tagged_case(
        case, np.random.default_rng(8), n_cells=3000, m=300_000)
    args = [torch.as_tensor(values, dtype=dtype), torch.as_tensor(seg),
            torch.as_tensor(bounds, dtype=dtype)]
    K.reset_launch_counts()
    outs = []
    for dev in ("cuda", "cuda", "cpu"):
        rows = torch.tensor(prior, dtype=dtype, device=dev)  # a copy
        K.isla_tagged_fold(*(a.to(dev) for a in args), rows[:, 0:4],
                           rows[:, 4:8], rows[:, 8:11])
        outs.append(rows.cpu())
    assert K.isla_tagged_fold.launches == 2
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])
    if dtype == torch.float64:
        assert np.array_equal(outs[0].numpy(),
                              host_fold(values, seg, bounds, prior))


def _runs(lengths, offsets, dev):
    table = torch.as_tensor(K.tagged_run_table(lengths, offsets), device=dev)
    return K.TaggedRuns(table, lengths.shape[0], lengths.shape[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", RUN_CASES)
def test_tagged_run_kernel_matches_plain_version(cuda, case, dtype,
                                                 monkeypatch):
    """The run-table instantiation on the block-major cases against the
    plain version run on CPU copies: bit for bit (tolerance 0) in both
    types, the host carry fold's bits in float64; two launches give
    identical bits, count two, and sort nothing."""
    values, seg, bounds, prior, lengths, offsets = run_case(
        case, np.random.default_rng(16))
    args = [torch.as_tensor(values, dtype=dtype), torch.as_tensor(seg),
            torch.as_tensor(bounds, dtype=dtype)]
    K.reset_launch_counts()
    outs = []
    for dev in ("cuda", "cuda", "cpu"):
        rows = torch.tensor(prior, dtype=dtype, device=dev)  # a copy
        with monkeypatch.context() as mp:
            mp.setattr(torch, "sort", None)  # the run path sorts nothing
            K.isla_tagged_fold(*(a.to(dev) for a in args), rows[:, 0:4],
                               rows[:, 4:8], rows[:, 8:11],
                               runs=_runs(lengths, offsets, dev))
        outs.append(rows.cpu())
    assert K.isla_tagged_fold.launches == 2
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])
    if dtype == torch.float64:
        assert np.array_equal(outs[0].numpy(),
                              host_fold(values, seg, bounds, prior))


@pytest.mark.parametrize("kind", WRONG_TABLES)
def test_wrong_run_table_raises_on_card(cuda, kind):
    """A run table that does not describe its stream raises on the card
    (the kernel counts what is out of place; the wrapper reads the count);
    a deferred table leaves the count for the caller to raise on."""
    values, seg, bounds, prior, lengths, offsets = run_case(
        "stacked", np.random.default_rng(13))
    bad_seg, bad_len, bad_off = wrong_table(kind, seg, lengths, offsets)
    rows = torch.tensor(prior, device="cuda")
    args = (torch.as_tensor(values, device="cuda"),
            torch.as_tensor(bad_seg, device="cuda"),
            torch.as_tensor(bounds, device="cuda"), rows[:, 0:4],
            rows[:, 4:8], rows[:, 8:11])
    with pytest.raises(ValueError, match="run table"):
        K.isla_tagged_fold(*args, runs=_runs(bad_len, bad_off, "cuda"))
    runs = _runs(bad_len, bad_off, "cuda")._replace(deferred=True)
    K.isla_tagged_fold(*args, runs=runs)
    assert int(runs.count) > 0
    with pytest.raises(ValueError, match="run table"):
        K.check_run_count(int(runs.count))


@pytest.mark.parametrize("thr", ["scalar", "per_cell"])
@pytest.mark.parametrize("mode", ["calibrated", "empirical", "faithful"])
def test_phase2_on_card_matches_cpu_bit_for_bit(cuda, mode, thr):
    """float64 Phase 2 on the card over a seeded 34,000-cell state is
    Phase 2 on the CPU bit for bit in every mode: its divisions by
    constants divide by a device scalar (torch would multiply a CUDA
    tensor by a host scalar's reciprocal)."""
    rng = np.random.default_rng(17)
    params = TC.IslaParams()
    b = TC.make_boundaries(100.0, 20.0, params).as_tuple()
    x = rng.normal(100.0, 20.0, (34_000, 40))
    mom = []
    for lo, hi in ((b[0], b[1]), (b[2], b[3])):
        w = ((x > lo) & (x < hi)).astype(np.float64)
        mom.append(np.stack([w.sum(1), (w * x).sum(1), (w * x * x).sum(1),
                             (w * x ** 3).sum(1)], axis=1))
    sketch0 = 100.0 + rng.normal(0.0, 2.0, 34_000)
    inv_scale = rng.uniform(0.5, 2.0, 34_000)
    geometry = (0.7, 0.3) if mode == "empirical" else None
    out = {}
    for dev in ("cpu", "cuda"):
        t = [torch.as_tensor(a, device=dev) for a in (*mom, sketch0)]
        kw = {} if thr == "scalar" else dict(
            thr=params.thr * torch.as_tensor(inv_scale, device=dev))
        out[dev] = TD.phase2(*t, params, mode=mode, geometry=geometry,
                             **kw).cpu()
    assert torch.isfinite(out["cpu"]).all()
    assert torch.equal(out["cuda"], out["cpu"])


def test_tagged_sketch_kernel_matches_plain_version(cuda):
    """``isla_sketch_tagged`` on the card against its plain version on CPU
    copies: registers bit for bit from a warm plane, out-of-range and
    drop-segment lanes dropped, two launches identical; its own counter
    counts them and ``isla_sketch``'s does not."""
    rng = np.random.default_rng(9)
    n, m = 3000, 400_000
    raw = rng.normal(100.0, 20.0, m)
    bits = torch.as_tensor(raw).view(torch.int64)
    seg = torch.as_tensor(rng.integers(-2, n + 3, m).astype(np.int32))
    warm = torch.as_tensor(rng.integers(0, 4, (n, K.N_REGS)),
                           dtype=torch.uint8)
    K.reset_launch_counts()
    outs = []
    for dev in ("cuda", "cuda", "cpu"):
        regs = warm.clone().to(dev)
        K.isla_sketch_tagged(bits.to(dev), seg.to(dev), regs)
        outs.append(regs.cpu())
    assert K.isla_sketch_tagged.launches == 2 and K.isla_sketch.launches == 0
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])


def test_float64_executor_on_cuda_matches_cpu(cuda):
    """The float64 device route (torch default dtype float64) on the card
    against the same route on the CPU, both planned from the card's pilot
    (the pilot kernel runs fp32 and sits within rel 1.1e-7 of its float64
    plain version, and sketch0 moves every partial): every key's moment
    state, totals and register plane bit for bit, tagged folds and merges
    and no dense launch; partials bit for bit (Phase 2 divides by device
    scalars) and answers within rel 1e-12."""
    import functools

    from repro_torch.core import multiquery as TMQ

    rng = np.random.default_rng(3)
    tables = []
    for _ in range(6):
        g = rng.integers(0, 3, size=2000)
        tables.append({"value": rng.normal(90 + 3.0 * g, 15.0),
                       "region": g.astype(np.float64),
                       "flag": rng.integers(0, 2, 2000).astype(np.float64)})
    flag = TC.Predicate(column="flag", eq=1.0)
    qs = [TC.IslaQuery(e=0.5, agg="AVG"),
          TC.IslaQuery(e=0.5, agg="AVG", group_by="region", where=flag),
          TC.IslaQuery(e=0.5, agg="count_distinct", group_by="region")]
    answers, states, partials = {}, {}, {}
    was = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for dev in ("cpu", "cuda"):
            ex = TC.MultiQueryExecutor(
                [TC.table_sampler(t) for t in tables], [10 ** 6] * 6,
                params=TC.IslaParams(e=0.5), group_domains={"region": 3},
                device=dev)
            ex._pilot_stats_fn = lambda route: functools.partial(
                TMQ.pilot_stats_device, device="cuda")
            K.reset_launch_counts()
            answers[dev] = ex.run(qs, np.random.default_rng(5),
                                  incremental=True, route="device")
            states[dev] = {k: st.to_host()
                           for k, st in ex._device_stores.items()}
            partials[dev] = {k: st.partials_host()
                             for k, st in ex._device_stores.items()}
            if dev == "cuda":
                assert K.isla_tagged_fold.launches > 0
                assert K.isla_sketch_tagged.launches > 0
                assert K.isla_fold.launches == K.isla_sketch.launches == 0
    finally:
        torch.set_default_dtype(was)
    for k, c in states["cpu"].items():
        g = states["cuda"][k]
        for f in ("mom_s", "mom_l", "totals", "n_sampled"):
            assert np.array_equal(getattr(g, f), getattr(c, f)), (k, f)
        if c.has_sketch:
            assert np.array_equal(g.regs, c.regs)
        assert np.array_equal(partials["cuda"][k], partials["cpu"][k]), k
    for c, g in zip(answers["cpu"], answers["cuda"]):
        assert g.new_samples == c.new_samples
        assert g.value == pytest.approx(c.value, rel=1e-12)


def test_float64_executor_tick_sorts_nothing(cuda):
    """The executor's float64 tick on the card folds each stream by its run
    table: the profiler's device events of a drawing run hold the run
    kernel, no ``isla_tagged_fold_kernel`` and no sort kernel."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(4)
    tables = [{"value": rng.normal(90.0, 15.0, 2000),
               "region": rng.integers(0, 3, 2000).astype(np.float64),
               "flag": rng.integers(0, 2, 2000).astype(np.float64)}
              for _ in range(6)]
    flag = TC.Predicate(column="flag", eq=1.0)
    qs = [TC.IslaQuery(e=0.5, agg="AVG"),
          TC.IslaQuery(e=0.5, agg="AVG", group_by="region", where=flag)]
    was = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        ex = TC.MultiQueryExecutor(
            [TC.table_sampler(t) for t in tables], [10 ** 6] * 6,
            params=TC.IslaParams(e=0.5), group_domains={"region": 3},
            device="cuda")
        K.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ex.run(qs, np.random.default_rng(5), incremental=True,
                   route="device")
            torch.cuda.synchronize()
    finally:
        torch.set_default_dtype(was)
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    assert K.isla_tagged_fold.launches > 0
    assert sum("isla_tagged_runs_kernel" in n for n in names) \
        == K.isla_tagged_fold.launches
    assert not any("isla_tagged_fold_kernel" in n for n in names)
    assert not any("sort" in n.lower() for n in names), names


def _mesh_pair(payload, kind_a, kind_b):
    """Two equal sketch stacks of the mesh cases (hetero anchors; COUNT
    DISTINCT on the last key), of ``payload``'s type, each a
    ``MeshDeviceStack`` over the devices ``kind_*`` or, for
    ``"device"``, a ``DeviceStack`` on the card."""
    from repro_torch.launch.mesh import make_cell_mesh

    dtype = torch.float64 if payload == "tagged" else torch.float32
    out = []
    for devices in (kind_a, kind_b):
        dev = "cuda" if devices == "device" else devices[0]
        stores = MC.make_stores(TC.DeviceMomentStore.fresh_device,
                                TC.Boundaries, hetero=True, sketch=(2,),
                                dtype=dtype, device=dev)
        stack = (TC.DeviceStack(stores) if devices == "device" else
                 TC.MeshDeviceStack(stores, make_cell_mesh(devices=devices)))
        out.append((stack, stores))
    return out


def _mesh_payload(payload, stack, stores, d):
    from repro_torch.core import sketch as TSK

    if payload == "dense":
        return MC.dense_payload(d)
    return MC.tagged_payload(stack, stores, d, limbs=TSK.value_limbs)


@pytest.mark.parametrize("payload", ["tagged", "dense"])
def test_mesh_tick_on_card_matches_plain_versions(cuda, payload):
    """The mesh tick at S = 4 on ``cuda:0`` (float64 tagged by the run
    tables, or fp32 dense; a sketch stack) against the same mesh on the
    CPU, where every shard runs the kernels' plain versions: one launch of
    each tick kernel a shard, a drawing tick; float64 state, partials and
    register planes bit for bit (rows within 1e-12), fp32 within 1e-5;
    one sum and one max of O(groups) rows a tick."""
    (card, c_st), (cpu, p_st) = _mesh_pair(payload, ["cuda:0"] * 4,
                                           ["cpu"] * 4)
    rng = np.random.default_rng(21)
    kernels = ((K.isla_tagged_fold, K.isla_sketch_tagged)
               if payload == "tagged" else (K.isla_fold, K.isla_sketch))
    for _ in range(2):
        d = MC.draw(rng)
        K.reset_launch_counts()
        with TD.collective_footprint() as rec:
            got = card.tick(TC.IslaParams(),
                            **_mesh_payload(payload, card, c_st, d))
        assert [k.launches for k in kernels] == [4, 4]
        assert [op for op, _ in rec] == ["sum", "max"]
        want = cpu.tick(TC.IslaParams(),
                        **_mesh_payload(payload, cpu, p_st, d))
        for a, b in zip(c_st, p_st):
            for f in ("mom_s", "mom_l", "totals", "_n_sampled_dev"):
                x, y = getattr(a, f).cpu(), getattr(b, f)
                if payload == "tagged":
                    assert torch.equal(x, y), f
                else:
                    torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
            if a.has_sketch:
                assert torch.equal(a.regs.cpu(), b.regs)
                assert np.array_equal(a.group_registers(),
                                      b.group_registers())
        for (pg, rg), (pc, rc) in zip(got, want):
            if payload == "tagged":
                assert torch.equal(pg.cpu(), pc.cpu())
                np.testing.assert_allclose(rg, rc, rtol=1e-12, atol=0)
            else:
                torch.testing.assert_close(pg.cpu(), pc.cpu(), rtol=1e-5,
                                           atol=1e-6)
                np.testing.assert_allclose(rg, rc, rtol=1e-5)


@pytest.mark.parametrize("stack_kind", ["device", "mesh"])
@pytest.mark.parametrize("kind", MC.WRONG_TABLES)
def test_wrong_run_table_leaves_stack_unusable_on_card(cuda, stack_kind,
                                                       kind):
    """On the card the run kernel skips what is out of place and folds the
    rest in place (the mesh checks what the host can see first): the tick
    raises, no store keeps valid stats, and every next tick raises,
    zero-draw ticks included — on ``DeviceStack`` and on a three-shard
    ``MeshDeviceStack`` on ``cuda:0``."""
    kind_a = "device" if stack_kind == "device" else ["cuda:0"] * 3
    (stack, stores), _ = _mesh_pair("tagged", kind_a, ["cpu"])
    rng = np.random.default_rng(22)
    stack.tick(TC.IslaParams(),
               **_mesh_payload("tagged", stack, stores, MC.draw(rng)))
    assert all(st._stats_valid for st in stores)
    kw = MC.spoil(kind, _mesh_payload("tagged", stack, stores, MC.draw(rng)))
    with pytest.raises(ValueError, match="run table"):
        stack.tick(TC.IslaParams(), **kw)
    assert not any(st._stats_valid for st in stores) and stack._released
    for again in (dict(), dict(mode="faithful"), kw):
        with pytest.raises(ValueError, match="unusable"):
            stack.tick(TC.IslaParams(), **again)


# ---------------------------------------------------------------------------
# The pipelined tick on the card: deferred readback, the run-table fault
# under it, and pipelined against serial.
# ---------------------------------------------------------------------------


def _f64_sketch_stack(kind="device"):
    from repro_torch.launch.mesh import make_cell_mesh

    stores = MC.make_stores(TC.DeviceMomentStore.fresh_device, TC.Boundaries,
                            hetero=True, sketch=(2,), dtype=torch.float64,
                            device="cuda")
    stack = (TC.DeviceStack(stores) if kind == "device" else
             TC.MeshDeviceStack(stores, make_cell_mesh(devices=kind)))
    return stack, stores


def test_deferred_readback_through_pinned_buffer(cuda, monkeypatch):
    """``d2h_async`` copies a card tensor into a pinned host buffer behind
    an event, and lands the bytes a blocking readback gives.  A deferred
    tick's rows and register rows, landed on their events with every
    device-wide sync refused, equal a serial tick's bit for bit."""
    from repro_torch.core import sketch as TSK

    x = torch.randn(34, 9, dtype=torch.float64, device=cuda)
    copy = TD.d2h_async(x)
    host = copy.wait()
    assert host.is_pinned() and torch.equal(host, x.cpu())
    rng = np.random.default_rng(24)
    draws = [MC.draw(rng) for _ in range(2)]
    outs = []
    for defer in (False, True):
        stack, stores = _f64_sketch_stack()
        for d in draws:
            out = stack.tick(TC.IslaParams(), defer_stats=defer,
                             **MC.tagged_payload(stack, stores, d,
                                                 limbs=TSK.value_limbs))

        def refused():
            raise AssertionError("a device-wide sync")

        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", refused)
            outs.append(([np.asarray(r) for _, r in out],
                         [st.group_registers() for st in stores
                          if st.has_sketch]))
    for a, b in zip(*outs):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("stack_kind", ["device", "mesh"])
@pytest.mark.parametrize("kind", MC.WRONG_TABLES)
def test_run_table_fault_under_deferred_stats_on_card(cuda, stack_kind,
                                                      kind):
    """A wrong table under deferred stats on the card: the kernel counts
    what is out of place into the table the deferred copy carries (the
    mesh's host checks raise at the tick), and the first read of the
    tick's rows raises, after every store's stats were cleared and the
    stack released; every next tick raises, zero-draw ticks included."""
    from repro_torch.core import sketch as TSK

    stack, stores = _f64_sketch_stack(
        "device" if stack_kind == "device" else ["cuda:0"] * 2)
    rng = np.random.default_rng(25)

    def payload():
        return MC.tagged_payload(stack, stores, MC.draw(rng),
                                 limbs=TSK.value_limbs)

    stack.tick(TC.IslaParams(), defer_stats=True, **payload())
    with pytest.raises(ValueError, match="run table"):
        out = stack.tick(TC.IslaParams(), defer_stats=True,
                         **MC.spoil(kind, payload()))
        [np.asarray(r) for _, r in out]
    assert not any(st._stats_valid for st in stores) and stack._released
    for again in (dict(), dict(mode="faithful"), payload()):
        with pytest.raises(ValueError, match="unusable"):
            stack.tick(TC.IslaParams(), defer_stats=True, **again)


@pytest.mark.parametrize("route", ["device", "mesh"])
def test_pipelined_executor_on_cuda_matches_serial(cuda, route):
    """``run(pipeline=True)`` on the card in float64, on the device route
    and on a two-shard mesh on ``cuda:0``, two mode groups of three chunks:
    every answer, draw ledger and store's state the serial run's bit for
    bit, with the same kernel launches tick by tick."""
    rng = np.random.default_rng(26)
    tables = []
    for _ in range(12):
        g = rng.integers(0, 4, size=500)
        tables.append({"value": rng.normal(100.0 + 3.0 * g, 12.0),
                       "region": g.astype(np.float64),
                       "flag": rng.integers(0, 2, 500).astype(np.float64)})
    flag = TC.Predicate(column="flag", eq=1.0)
    qs = [q for m in ("calibrated", "faithful_cf") for q in (
        TC.IslaQuery(e=0.05, agg="AVG", mode=m),
        TC.IslaQuery(e=0.05, agg="AVG", where=flag, mode=m),
        TC.IslaQuery(e=0.05, agg="count_distinct", group_by="region",
                     mode=m))]
    runs = []
    was = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for pipeline in (False, True):
            ex = TC.MultiQueryExecutor(
                [TC.table_sampler(t) for t in tables], [10 ** 5] * 12,
                group_domains={"region": 4}, device="cuda",
                mesh=["cuda:0"] * 2 if route == "mesh" else None)
            draw_rng = np.random.default_rng(7)
            answers, launches = [], []
            for i in range(3):
                K.reset_launch_counts()
                out = ex.run(qs, draw_rng, route=route, incremental=True,
                             deadline_samples=30 * (i + 1), chunk_blocks=4,
                             pipeline=pipeline)
                torch.cuda.synchronize()
                launches.append((K.isla_tagged_fold.launches,
                                 K.isla_sketch_tagged.launches,
                                 K.isla_fold.launches))
                answers.append([repr((a.value, a.error_bound, a.new_samples,
                                      a.sample_size,
                                      None if a.groups is None else
                                      [g.value for g in a.groups]))
                                for a in out])
            state = {}
            for k, dst in ex._device_stores.items():
                host = dst.to_host()
                for f in ("mom_s", "mom_l", "totals", "n_sampled"):
                    state[(k, f)] = getattr(host, f)
                if host.has_sketch:
                    state[(k, "regs")] = host.regs
                state[(k, "partials")] = dst.partials_host()
            runs.append((answers, launches, state))
    finally:
        torch.set_default_dtype(was)
    (s_ans, s_launch, s_state), (p_ans, p_launch, p_state) = runs
    assert p_ans == s_ans
    assert p_launch == s_launch and s_launch[0][0] > 0
    assert s_launch[0][2] == 0
    assert set(p_state) == set(s_state)
    for k, v in s_state.items():
        assert np.array_equal(p_state[k], v), k


# ---------------------------------------------------------------------------
# The float64 dense tick: the fold's float64 form on the card.
# ---------------------------------------------------------------------------


def _dense64_case(case, dev):
    import _torch_dense64_cases as DC

    # "sliced": rows longer than FOLD_SLICE samples, summed slice by slice
    # and combined by the second kernel.
    n_b, q = (5, 2 * K.FOLD_SLICE + 300) if case == "sliced" else (37, 200)
    return DC.fold_case(n_b, q, seed=31, device=dev)


@pytest.mark.parametrize("case", ["plain", "affine", "sliced"])
def test_fold64_kernel_matches_plain_version(cuda, case):
    """The fold's float64 form for the four stacked keys (plain, WHERE,
    GROUP BY, both) within rel 1e-12 of its plain version run on the CPU
    on the same inputs; two launches give identical bits; a compacted
    launch (some rows, mapped back by ``cell_idx``) gives those rows'
    cells the full launch's bits and leaves the others' rows as they
    were."""
    import _torch_dense64_cases as DC

    affine = (1.0, 0.25) if case == "affine" else None
    c = _dense64_case(case, cuda)
    host = _dense64_case(case, "cpu")
    got = DC.fold(c, affine=affine)
    again = DC.fold(c, affine=affine)
    want = DC.fold(host, affine=affine)
    rows = [1, 3, 4] if case == "sliced" else [0, 5, 6, 20, 36]
    part = DC.fold(c, rows=rows, affine=affine)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64
    assert torch.equal(got, again)  # fixed order: identical bits
    assert _rel_err(got.cpu(), want) <= 1e-12
    n = c["values"].shape[0]
    cells = torch.as_tensor(np.concatenate([
        key.offset + np.arange(g)[:, None] * n + np.asarray(rows)
        for key, (g, _) in zip(DC.stack_keys(n), DC.KEYS)], axis=None),
        device=cuda)
    assert torch.equal(part[cells], got[cells])
    keep = torch.ones(part.shape[0], dtype=torch.bool, device=cuda)
    keep[cells] = False
    assert torch.equal(part[keep], c["prior"][keep])


@pytest.mark.parametrize("n_keys", [4, K.MAX_KEYS, K.MAX_KEYS + 4])
def test_fold64_is_one_launch_a_tick(cuda, n_keys, monkeypatch):
    """A float64 ``fold_panes`` call of up to ``MAX_KEYS`` keys is one
    launch of the fold's float64 instantiation (a longer stack one per
    ``MAX_KEYS``), counted in ``isla_fold.launches_f64`` and not in
    ``isla_fold.launches``: the pane reaches the float64 kernel, never the
    plain version (which raises here once the CPU's sums are taken) and
    never an fp32 cast (its rows land within rel 1e-12 of the CPU's
    float64 sums, where fp32 would part by ~1e-7)."""
    from _torch_stack_cases import fold_stacked, stack_case

    def case(dev):
        c = stack_case(np.random.default_rng(12), dev, stack="loop", n_b=50,
                       q=256)
        kw = {f: (v * 6)[:n_keys] if isinstance(v, tuple) else v
              for f, v in c["kw"].items()}
        values, pad, gids, valids, bounds = c["panes"]
        panes = (values.double(), pad, gids, valids, bounds.double())
        n_cells = sum(kw["n_groups_list"]) * c["n_b"]
        return (torch.zeros((n_cells, 11), dtype=torch.float64, device=dev),
                panes, kw)

    want = case("cpu")
    fold_stacked(*want)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain fold ran for a card tensor")

    monkeypatch.setattr(ref, "isla_fold_stack_ref", no_plain)
    got = case(cuda)
    K.reset_launch_counts()
    fold_stacked(*got)
    torch.cuda.synchronize()
    per = -(-n_keys // K.MAX_KEYS)
    assert (K.isla_fold.launches_f64, K.isla_fold.launches) == (per, 0)
    assert _rel_err(got[0].cpu(), want[0]) <= 1e-12


@pytest.mark.parametrize("sketch", [(), (2,)], ids=["moments", "sketch"])
def test_dense64_stack_on_card_matches_cpu(cuda, sketch):
    """The float64 dense tick on the card (``DeviceStack``, zone-pruned and
    full ticks): compacted and full stacks bit for bit, a four-shard
    ``MeshDeviceStack`` on ``cuda:0`` bit for bit with the device route
    (rows within 1e-12), and the state, partials and register planes
    within 1e-12 (registers bit for bit) of the same ticks on the CPU; one
    float64 fold launch a drawing tick (a shard), no fp32 fold."""
    from repro_torch.launch.mesh import make_cell_mesh

    def stack(kind, compaction=True):
        dev = "cpu" if kind == "cpu" else "cuda"
        stores = MC.make_stores(TC.DeviceMomentStore.fresh_device,
                                TC.Boundaries, hetero=True, sketch=sketch,
                                dtype=torch.float64, device=dev)
        st = (TC.MeshDeviceStack(stores, make_cell_mesh(
            devices=["cuda:0"] * 4)) if kind == "mesh"
            else TC.DeviceStack(stores))
        st.block_compaction = compaction
        return st, stores

    runs = {"card": stack("card"), "full": stack("card", False),
            "mesh": stack("mesh"), "cpu": stack("cpu")}
    rng = np.random.default_rng(23)
    for q in (None, [0, 6, 0, 0, 0, 0, 0, 5, 0, 0], None):
        d = MC.draw(rng, q)
        outs = {}
        for name, (st, _) in runs.items():
            K.reset_launch_counts()
            outs[name] = st.tick(TC.IslaParams(), **MC.dense_payload(d))
            want = 4 if name == "mesh" else 1
            if name != "cpu":
                assert (K.isla_fold.launches_f64, K.isla_fold.launches,
                        K.isla_sketch.launches) == (
                            want, 0, want if sketch else 0), name
        base = runs["card"][1]
        for name in ("full", "mesh", "cpu"):
            for a, b in zip(base, runs[name][1]):
                for f in ("mom_s", "mom_l", "totals", "_n_sampled_dev"):
                    x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
                    if name == "cpu":
                        assert _rel_err(x, y) <= 1e-12, (name, f)
                    else:
                        assert torch.equal(x, y), (name, f)
                if a.has_sketch:
                    assert torch.equal(a.regs.cpu(), b.regs.cpu())
            for (pa, ra), (pb, rb) in zip(outs["card"], outs[name]):
                pa, pb = torch.as_tensor(np.asarray(pa.cpu())), \
                    torch.as_tensor(np.asarray(pb.cpu()))
                if name == "cpu":
                    assert _rel_err(pa, pb) <= 1e-12
                else:
                    assert torch.equal(pa, pb)
                np.testing.assert_allclose(ra, rb, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# The telemetry estimator: one fold launch a call (a shard), the kernel path
# against its plain path on the card at chip_smoke.py's sizes, no host sync.
# ---------------------------------------------------------------------------

TELEMETRY_SHAPES = ((512, 2048), (4096, 4096))


def _plain_fold(monkeypatch):
    """Every kernel wrapper takes its plain version for card tensors too
    (what chip_smoke.py's ``PlainVersions`` does)."""
    monkeypatch.setattr(K, "on_gpu", lambda t: False)


def _losses(shape, dev):
    x = np.random.default_rng(0).gamma(2.0, 2.0, size=shape)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _telemetry_runs(x, mesh):
    from repro_torch.core import metrics as TMX

    p = TMX.DEFAULT_PARAMS
    arg = x if mesh is None else list(x.tensor_split(len(mesh.devices)))
    for sem in ("blocks", "merged"):
        for mode in ("calibrated", "empirical"):
            yield (f"{sem} {mode}", lambda sem=sem, mode=mode: TD.isla_mean(
                arg, p, mesh=mesh, rate=0.02, semantics=sem, mode=mode))
    yield "loss_stats", lambda: TMX.loss_stats(arg, mesh=mesh)[
        "loss_mean_isla"]


@pytest.mark.parametrize("route", ["device", "mesh"])
def test_isla_mean_one_fold_launch_a_shard(cuda, route):
    from repro_torch.launch.mesh import make_cell_mesh

    mesh = None if route == "device" else make_cell_mesh(
        devices=["cuda:0"] * 4)
    x = _losses((512, 2048), cuda)
    for name, fn in _telemetry_runs(x, mesh):
        K.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        assert K.isla_fold.launches == (1 if mesh is None else 4), name
        assert K.pilot_stats.launches == K.isla_sketch.launches == 0
        assert K.isla_fold.launches_f64 == K.isla_tagged_fold.launches == 0
    K.reset_launch_counts()
    TD.exact_mean(x)
    assert K.isla_fold.launches == 0


@pytest.mark.parametrize("shape", TELEMETRY_SHAPES)
@pytest.mark.parametrize("route", ["device", "mesh"])
def test_isla_mean_kernel_path_matches_plain_path(cuda, route, shape,
                                                  monkeypatch):
    from repro_torch.launch.mesh import make_cell_mesh

    mesh = None if route == "device" else make_cell_mesh(
        devices=["cuda:0"] * 4)
    x = _losses(shape, cuda)
    got = {n: float(fn()) for n, fn in _telemetry_runs(x, mesh)}
    _plain_fold(monkeypatch)
    want = {n: float(fn()) for n, fn in _telemetry_runs(x, mesh)}
    for n in got:
        assert got[n] == pytest.approx(want[n], rel=1e-5), n


def test_isla_mean_does_not_sync(cuda):
    """The estimator runs whole on the card: no host sync inside
    ``isla_mean`` or ``exact_mean`` (the kernel library is loaded by a
    first call before the check)."""
    from repro_torch.launch.mesh import make_cell_mesh

    mesh = make_cell_mesh(devices=["cuda:0"] * 4)
    x = _losses((512, 2048), cuda)
    runs = list(_telemetry_runs(x, None)) + list(_telemetry_runs(x, mesh))
    gen = lambda: TD.isla_mean(  # noqa: E731
        x, TC.IslaParams(), generator=torch.Generator(
            device=cuda).manual_seed(0))
    runs += [("generator", gen), ("exact", lambda: TD.exact_mean(x))]
    for _, fn in runs:
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _, fn in runs:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_subsample_refuses_a_generator_on_another_device(cuda):
    with pytest.raises(ValueError, match="generator lives on"):
        TD.subsample(torch.ones(100, device=cuda), 0.1,
                     torch.Generator().manual_seed(0))


# The SSD's per-head leaves (H values a layer): each grad sums terms of
# every position that largely cancel, so fp32 leaves them further from
# the float64 step than any other leaf.  On an H100 (700 W) reduced
# jamba's A_log v stood 1.44e-4 of scale off the float64 step, the CPU's
# 5.2e-5 (the two 1.6e-4 apart); reduced mamba2-130m's per-head leaves
# 2.5e-5 and 1.6e-5.  SSD_TOL is the larger reading with twice the room.
SSD_LEAVES = ("['A_log']", "['D']", "['dt_bias']")
SSD_TOL = 3e-4
# Every module whose ``F32`` is the step's fp32 arithmetic: the float64
# step runs with each set to float64.
TRAIN_F32_MODULES = ("models.layers", "models.attention", "models.mamba2",
                     "models.moe", "models.transformer", "train.optimizer",
                     "train.train_step")


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-130m",
                                  "jamba-1.5-large-398b"])
def test_train_step_on_cuda_matches_cpu_without_sync(cuda, arch,
                                                     monkeypatch):
    """Reduced olmo-1b, mamba2-130m and jamba in fp32 with remat: one
    ``train_step`` on the card (after a warm-up step that loads the fold
    library) with no host sync anywhere in it
    (``set_sync_debug_mode("error")``), against the same step on the CPU
    from the same weights, optimizer state and batch (the batch drawn on
    the CPU: the same on both devices), and against the step in float64
    on the CPU (params, moments and every fp32 computation of the step in
    float64).  Every metric of the card within rel 1e-5 of the CPU's
    (jamba, an MoE config: 1e-4).  Each leaf of ``m``, ``v`` and the new
    params, on the card and on the CPU alike, within 1e-5 (MoE 1e-4) of
    its scale of the float64 step's, the params wherever |g| exceeds 1e-4
    of its leaf's largest (elsewhere the card's within 2 lr of the CPU's:
    Adam's first step is g / (|g| + eps) of two roundings of a near-zero
    g); the SSD's per-head leaves within ``SSD_TOL``.  The two fp32 steps
    are held against float64, not against each other, because each
    rounds on its own side of it: reduced mamba2-130m's ``wdt`` v stood
    3.9e-6 of scale off float64 on the card and 6.6e-6 on the CPU, 1.04e-5
    apart (H100, 700 W).  One ``isla_fold`` launch a step, no flash
    launch; jamba's routing on the card the CPU's but for counted
    near-ties."""
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.models import moe as M
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import TrainConfig, train_step
    from repro_torch.core.tree import tree_leaves, tree_map, tree_paths

    cfg = get_config(arch, reduced=True).replace(param_dtype="float32",
                                                 remat=True)
    tol = 1e-4 if cfg.moe is not None else 1e-5
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    opt = init_opt_state(params)
    batch = SyntheticStream(cfg, batch=2, seq=64, device="cpu").batch_at(0)
    on_card = SyntheticStream(cfg, batch=2, seq=64, device=cuda).batch_at(0)
    for k in batch:
        assert torch.equal(on_card[k].cpu(), batch[k])
    tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=2),
                       telemetry_exact=True)
    move = lambda t, d: tree_map(lambda x: x.to(d), t)  # noqa: E731
    wide = lambda t: tree_map(  # noqa: E731
        lambda x: x.double() if x.is_floating_point() else x, t)
    with monkeypatch.context() as mp:
        for name in TRAIN_F32_MODULES:
            mp.setattr(importlib.import_module(f"repro_torch.{name}"),
                       "F32", torch.float64)
        f64p, f64, _ = train_step(cfg.replace(param_dtype="float64"), tcfg,
                               wide(params), wide(opt), batch)
    logits = {}
    real = M._route

    def spy(cfg_, lg):  # kept where it lies: a copy to the host syncs
        logits.setdefault(lg.device.type, []).append(lg.detach().clone())
        return real(cfg_, lg)

    monkeypatch.setattr(M, "_route", spy)
    out = {}
    for dev in ("cpu", "cuda"):
        p, o, b = (move(t, dev) for t in (params, opt, batch))
        if dev == "cuda":
            train_step(cfg, tcfg, p, o, b)
            torch.cuda.synchronize()
            logits.pop("cuda", None)
            K.reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = train_step(cfg, tcfg, p, o, b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if dev == "cuda":
            assert K.isla_fold.launches == 1
            assert FA.flash_attention.launches == 0
        out[dev] = move(got, "cpu")
    (gp, go, gm), (wp, wo, wm) = out["cuda"], out["cpu"]
    assert sorted(gm) == sorted(wm)
    for k in wm:
        assert float(gm[k]) == pytest.approx(float(wm[k]), rel=tol), k
    flipped = 0
    assert len(logits.get("cuda", [])) == len(logits.get("cpu", []))
    for lg_c, lg_h in zip(logits.get("cuda", []), logits.get("cpu", [])):
        p_c, p_h = torch.softmax(lg_c.cpu(), -1), torch.softmax(lg_h, -1)
        top_c, top_h = p_c.topk(2, -1).indices, p_h.topk(2, -1).indices
        for g, t in (top_c.sort(-1).values != top_h.sort(-1).values
                     ).any(-1).nonzero().tolist():
            a = set(top_c[g, t].tolist()) - set(top_h[g, t].tolist())
            b = set(top_h[g, t].tolist()) - set(top_c[g, t].tolist())
            assert _moe_near_tie(p_h[g, t], min(a), min(b)), (g, t)
            flipped += 1
    # (part, path, card, cpu, float64, where the leaf is held)
    leaves = [(part, path, g, w, x, None)
              for part, g_tree, w_tree, x_tree in (
                  ("m", go.m, wo.m, f64.m), ("v", go.v, wo.v, f64.v))
              for (path, w), g, x in zip(tree_paths(w_tree),
                                         tree_leaves(g_tree),
                                         tree_leaves(x_tree))]
    for (path, w), g, x, m in zip(tree_paths(wp), tree_leaves(gp),
                                  tree_leaves(f64p),
                                  tree_leaves(wo.m)):
        gabs = m.abs() / (1 - tcfg.opt.b1)
        assert float((g - w).abs().max()) <= 2 * tcfg.opt.lr * 1.0001, path
        leaves.append(("params", path, g, w, x, gabs > 1e-4 * gabs.max()))
    worst, fails = {}, []
    for part, path, g, w, x, big in leaves:
        ssd = path.endswith(SSD_LEAVES)
        scale = float(x.abs().max())
        pick = (lambda t: t) if big is None else (lambda t: t[big])
        gaps = {pair: float(pick((a.double() - b.double()).abs()).max())
                / scale for pair, a, b in (("card-cpu", g, w),
                                           ("card-f64", g, x),
                                           ("cpu-f64", w, x))}
        for pair, e in gaps.items():
            key = ("ssd " if ssd else "") + f"{part} {pair}"
            worst[key] = max(worst.get(key, 0.0), e)
        lim = SSD_TOL if ssd else tol
        fails += [(part, path, pair, gaps[pair])
                  for pair in ("card-f64", "cpu-f64") if gaps[pair] > lim]
    print(f"{arch}: {flipped} near-tie tokens took another expert; worst "
          f"gaps of scale {json.dumps(worst)}")
    assert not fails, fails


def test_one_rank_mesh_step_on_cuda_is_the_meshless_step(cuda, monkeypatch):
    """Reduced olmo-1b in fp32 with remat and TP on (its threshold set to
    0, as olmo-1b's own size turns it on): two steps of
    ``launch.train.build_step`` over a one-rank ``("data", "model")``
    nccl mesh (a ``FileStore`` process group) equal the meshless
    ``train_step``'s from the same weights and batches bit for bit, rows
    and trees, with one ``isla_fold`` launch a step."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import train as TT
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.sharding import specs as SP
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import (TrainConfig, local_value,
                                              train_step)

    monkeypatch.setattr(SP, "TP_THRESHOLD", 0)
    cfg = get_config("olmo-1b", reduced=True).replace(param_dtype="float32",
                                                      remat=True)
    tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=2),
                       telemetry_exact=True)
    params = TM.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    stream = SyntheticStream(cfg, batch=4, seq=64, device=cuda)
    p, o = params, init_opt_state(params)
    want = []
    for st in range(2):
        p, o, m = train_step(cfg, tcfg, p, o, stream.batch_at(st))
        want.append({k: float(v) for k, v in m.items()})
    with tempfile.TemporaryDirectory() as d:
        store = dist.FileStore(f"{d}/store", 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            mesh = make_host_mesh((1, 1), ("data", "model"))
            step_fn, _ = TT.build_step(cfg, tcfg, mesh)
            q, r = params, init_opt_state(params)
            K.reset_launch_counts()
            got = []
            for st in range(2):
                q, r, m = step_fn(q, r, stream.batch_at(st))
                got.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            assert K.isla_fold.launches == 2
            assert got == want
            for a, b in zip(tree_leaves((q, r)), tree_leaves((p, o))):
                assert torch.equal(local_value(a), b)
        finally:
            dist.destroy_process_group()
