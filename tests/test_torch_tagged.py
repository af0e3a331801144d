"""The port's tagged tick on the CPU: the ``isla_tagged_fold`` plain
version against the host carry fold, the float64 ``DeviceMomentStore``
against the reference's host ``MomentStore``, fp32 tagged against fp32
dense, the tagged register merge against the host twin, the executor's
float64 device route against its host route, and a reference float64
store carried across by ``convert``.

Moment state, totals, draw ledgers and register planes are held bit for
bit (``np.array_equal``).  Partials are held to one ulp of the host solve:
the device Phase 2 (the reference's ``distributed.phase2``, which the port
mirrors) forms the calibrated answer as ``c + mu_move`` where the host
solve forms ``k * (mu_move / k) + c``, and the two roundings part in about
one cell in a thousand; the reference's own float64 device route parts from
its host the same way.  fp32 tagged against dense is held at the
reference's ``rtol=1e-5, atol=1e-4`` (``test_device_store.py``).
"""
import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

import repro.core as RC
from repro.core.moment_store import MomentStore as RHost
import repro_torch.core as TC
from repro_torch import convert
from repro_torch.core import multiquery as TMQ
from repro_torch.core import sketch as TSK
from repro_torch.core.moment_store import DeviceMomentStore as TDev
from repro_torch.core.moment_store import DeviceStack as TStack
from repro_torch.kernels import isla_moments as K
from _torch_tagged_cases import (CASES, RUN_CASES, WRONG_TABLES,
                                 host_fold, run_case, tagged_case,
                                 wrong_table)
from test_torch_executor import _executor, _queries, _tables

MU, SIGMA = 100.0, 20.0
N_BLOCKS, N_GROUPS = 30, 3
SIZES = [10 ** 6] * N_BLOCKS


@pytest.fixture
def float64_default():
    """The torch default dtype set to float64 (the exact mode) for the
    test, restored after it."""
    was = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(was)


def _ulps(got, want) -> float:
    return float(np.max(np.abs(got - want) / np.spacing(np.abs(want))))


@pytest.mark.parametrize("case", CASES)
def test_plain_fold_matches_host_carry_fold(case):
    """Three chunked passes folded by the plain version equal the host
    bincount carry fold bit for bit, and launch nothing."""
    rng = np.random.default_rng(0)
    _, _, bounds, prior = tagged_case(case, rng)
    want = prior.copy()
    rows = torch.as_tensor(prior).clone()
    for _ in range(3):
        values, seg, _, _ = tagged_case(case, rng)
        want = host_fold(values, seg, bounds, want)
        K.isla_tagged_fold(torch.as_tensor(values), torch.as_tensor(seg),
                           torch.as_tensor(bounds), rows[:, 0:4],
                           rows[:, 4:8], rows[:, 8:11])
    assert np.array_equal(rows.numpy(), want)
    assert K.isla_tagged_fold.launches == 0


def _runs(lengths, offsets, deferred=False):
    """A CPU ``TaggedRuns`` of a case's run lengths and key offsets."""
    table = torch.as_tensor(K.tagged_run_table(lengths, offsets))
    return K.TaggedRuns(table, lengths.shape[0], lengths.shape[1], deferred)


@pytest.mark.parametrize("table", [True, False])
@pytest.mark.parametrize("case", RUN_CASES)
def test_block_major_fold_matches_host_carry_fold(case, table):
    """The executor's block-major streams (stacked key slices, GROUP BY,
    WHERE, per-cell cuts, empty runs, missing blocks, a run of more than
    100,000 samples, a key of 300 groups) folded by the plain version,
    with the stream's run table and without, over two passes: the host
    bincount carry fold bit for bit."""
    rng = np.random.default_rng(11)
    want, rows = None, None
    for _ in range(2):
        values, seg, bounds, prior, lengths, offsets = run_case(case, rng)
        if rows is None:
            want, rows = prior.copy(), torch.as_tensor(prior).clone()
        want = host_fold(values, seg, bounds, want)
        K.isla_tagged_fold(torch.as_tensor(values), torch.as_tensor(seg),
                           torch.as_tensor(bounds), rows[:, 0:4],
                           rows[:, 4:8], rows[:, 8:11],
                           runs=_runs(lengths, offsets) if table else None)
    assert np.array_equal(rows.numpy(), want)
    assert K.isla_tagged_fold.launches == 0


@pytest.mark.parametrize("kind", WRONG_TABLES)
def test_wrong_run_table_raises(kind):
    """A table that does not describe its stream raises before the plain
    version folds anything; the right table does not."""
    values, seg, bounds, prior, lengths, offsets = run_case(
        "stacked", np.random.default_rng(13))
    bad_seg, bad_len, bad_off = wrong_table(kind, seg, lengths, offsets)
    rows = torch.as_tensor(prior).clone()
    args = (torch.as_tensor(values), torch.as_tensor(bad_seg),
            torch.as_tensor(bounds), rows[:, 0:4], rows[:, 4:8],
            rows[:, 8:11])
    with pytest.raises(ValueError, match="run table"):
        K.isla_tagged_fold(*args, runs=_runs(bad_len, bad_off))
    assert np.array_equal(rows.numpy(), prior)
    K.isla_tagged_fold(*args[:1], torch.as_tensor(seg), *args[2:],
                       runs=_runs(lengths, offsets))


def test_run_table_layout():
    """``tagged_run_table``: the run starts, the key offsets, a zero
    count; ``TaggedRuns.count`` is its last entry."""
    lengths = np.array([[3, 0, 2], [1, 1, 0]])
    table = K.tagged_run_table(lengths, [0, 3, 9])
    assert table.dtype == np.int32
    assert table.tolist() == [0, 3, 3, 5, 6, 7, 7, 0, 3, 9, 0]
    runs = K.TaggedRuns(torch.as_tensor(table), 2, 3)
    assert runs.count.tolist() == [0]
    with pytest.raises(ValueError, match="contiguous"):
        K.isla_tagged_fold(torch.zeros(7, dtype=torch.float64),
                           torch.zeros(7, dtype=torch.int32),
                           torch.zeros((1, 4), dtype=torch.float64),
                           *(torch.zeros((9, w), dtype=torch.float64)
                             for w in (4, 4, 3)),
                           runs=K.TaggedRuns(runs.table, 2, 4))


def test_key_runs_counts_each_blocks_samples():
    """``DeviceStack.key_runs``: a key's run lengths in a block-major draw
    are the quotas, or its WHERE mask's per-block counts; blocks with no
    draw hold 0."""
    rng = np.random.default_rng(14)
    b = TC.make_boundaries(MU, SIGMA, TC.IslaParams())
    stack = TStack([TDev.fresh_device(N_BLOCKS, b, MU, SIZES, device="cpu")])
    quotas = rng.integers(0, 30, N_BLOCKS)
    quotas[::4] = 0
    block = np.repeat(np.arange(N_BLOCKS), quotas)
    mask = rng.random(block.size) < 0.3
    assert np.array_equal(stack.key_runs(quotas), quotas)
    assert np.array_equal(stack.key_runs(quotas, mask),
                          np.bincount(block[mask], minlength=N_BLOCKS))


def test_stack_tick_raises_on_a_wrong_run_table(float64_default):
    """``DeviceStack.tick(runs=...)`` uploads the table with the stream and
    raises when it does not describe it (a run one sample short)."""
    b = TC.make_boundaries(MU, SIGMA, TC.IslaParams())
    stack = TStack([TDev.fresh_device(N_BLOCKS, b, MU, SIZES, device="cpu")])
    vals, bids, _, _, quotas = _tagged_pass(np.random.default_rng(15),
                                            shuffle=False)
    seg = stack.key_seg(0, stack.stores[0], bids)
    runs = stack.key_runs(quotas)[None]
    runs[0, 0] -= 1
    runs[0, 1] += 1
    with pytest.raises(ValueError, match="run table"):
        stack.tick(TC.IslaParams(), values=vals, seg=seg, quotas=quotas,
                   runs=runs)


def _tagged_pass(rng, quota=400, shuffle=True):
    vals = rng.normal(MU, SIGMA, N_BLOCKS * quota)
    bids = np.repeat(np.arange(N_BLOCKS), quota)
    if shuffle:
        order = rng.permutation(vals.size)
        vals, bids = vals[order], bids[order]
    gids = rng.integers(0, N_GROUPS, vals.size)
    mask = rng.random(vals.size) < 0.8
    return vals, bids, gids, mask, np.full(N_BLOCKS, quota, dtype=np.int64)


@pytest.mark.parametrize("sketch", [False, True])
def test_float64_store_matches_reference_host_store(sketch, float64_default):
    """Mirror of the reference's ``test_device_store_bit_exact_x64`` over
    three chunked, shuffled passes: the port's float64 store (scale 1.0,
    the tagged tick) against the reference's host ``MomentStore``."""
    rng = np.random.default_rng(1)
    b = RC.make_boundaries(MU, SIGMA, RC.IslaParams())
    host = RHost.fresh(N_BLOCKS, b, MU, n_groups=N_GROUPS, has_sketch=sketch)
    dev = TDev.fresh_device(
        N_BLOCKS, TC.make_boundaries(MU, SIGMA, TC.IslaParams()), MU, SIZES,
        n_groups=N_GROUPS, has_sketch=sketch, device="cpu")
    assert dev.dtype == torch.float64 and dev.scale == 1.0
    for _ in range(3):
        vals, bids, gids, mask, quotas = _tagged_pass(rng)
        host.ingest(vals, bids, quotas, group_ids=gids, mask=mask)
        dev.ingest_tick(vals, bids, quotas, TC.IslaParams(), group_ids=gids,
                        mask=mask)
    dh = dev.to_host()
    for f in ("mom_s", "mom_l", "totals", "n_sampled"):
        assert np.array_equal(getattr(dh, f), getattr(host, f)), f
    assert dh.rounds == host.rounds == 3
    if sketch:
        assert np.array_equal(dh.regs, host.regs)
    want = host.solve(RC.IslaParams(), mode="calibrated").avg
    assert _ulps(dev.partials_host(), want) <= 1.0


def test_fp32_tagged_matches_dense():
    """Mirror of the reference's ``test_dense_and_tagged_layouts_agree``:
    one pass folded by the fp32 dense pane and by the fp32 tagged tick."""
    rng = np.random.default_rng(2)
    b = TC.make_boundaries(MU, SIGMA, TC.IslaParams())
    dense, tagged = (TDev.fresh_device(N_BLOCKS, b, MU, SIZES,
                                       n_groups=N_GROUPS, device="cpu")
                     for _ in range(2))
    vals, bids, gids, mask, quotas = _tagged_pass(rng, shuffle=False)
    for st, layout in ((dense, "dense"), (tagged, "tagged")):
        st.ingest_tick(vals, bids, quotas, TC.IslaParams(), group_ids=gids,
                       mask=mask, layout=layout)
    assert tagged.dtype == torch.float32
    for f in ("mom_s", "mom_l", "totals"):
        np.testing.assert_allclose(getattr(tagged, f).numpy(),
                                   getattr(dense, f).numpy(), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tagged_sketch_planes_match_host(dtype):
    """The tagged tick's register merge: a stack of a sketch store and a
    moment-only store (its register rows ride along, never read) fed
    shuffled streams with drop-segment lanes gives the sketch store the
    host twin's plane bit for bit."""
    rng = np.random.default_rng(3)
    b = TC.make_boundaries(MU, SIGMA, TC.IslaParams())
    stores = [TDev.fresh_device(N_BLOCKS, b, MU, SIZES, n_groups=g,
                                has_sketch=sk, dtype=dtype, device="cpu")
              for g, sk in ((N_GROUPS, True), (1, False))]
    stack = TStack(stores)
    host = RHost.fresh(N_BLOCKS, RC.make_boundaries(MU, SIGMA,
                                                    RC.IslaParams()),
                       MU, n_groups=N_GROUPS, has_sketch=True)
    for _ in range(2):
        vals, bids, gids, mask, quotas = _tagged_pass(rng)
        host.ingest(vals, bids, quotas, group_ids=gids, mask=mask)
        seg = np.concatenate([stack.key_seg(0, stores[0], bids, gids, mask),
                              stack.key_seg(1, stores[1], bids)])
        raw = np.concatenate([vals[mask], vals])
        # Drop-segment lanes, spread through the stream, raise nothing.
        at = rng.integers(0, seg.size, 100)
        seg = np.insert(seg, at, stack.n_cells).astype(np.int32)
        raw = np.insert(raw, at, rng.normal(MU, SIGMA, at.size))
        stack.tick(TC.IslaParams(), values=raw / stores[0].scale, seg=seg,
                   quotas=quotas, hash_limbs=TSK.value_limbs(raw))
    assert np.array_equal(stores[0].to_host().regs, host.regs)
    assert np.array_equal(stores[0].group_registers(),
                          host.group_registers())


def test_tagged_sketch_entry_drops_out_of_range_lanes():
    """``isla_sketch_tagged`` on the CPU: lanes whose id is the drop
    segment or below 0 raise no register; the rest match the host
    ``scatter_max``."""
    rng = np.random.default_rng(4)
    n, m = 50, 4000
    raw = rng.normal(MU, SIGMA, m)
    seg = rng.integers(-3, n + 3, m).astype(np.int32)
    regs = torch.zeros((n, TSK.M), dtype=torch.uint8)
    K.isla_sketch_tagged(torch.as_tensor(TSK.value_bits(raw).view(np.int64)),
                         torch.as_tensor(seg), regs)
    want = np.zeros((n, TSK.M), dtype=np.uint8)
    ok = (seg >= 0) & (seg < n)
    TSK.scatter_max(want, seg[ok], *TSK.encode(TSK.hash_values(raw[ok])))
    assert np.array_equal(regs.numpy(), want)
    assert K.isla_sketch_tagged.launches == 0


def test_executor_float64_device_route_matches_host_route(float64_default):
    """The executor's float64 device route (tagged ticks on float64
    stores) against its host route over a cold tick, a warm repeat and a
    top-up: every key's state bit-identical, the draw ledgers equal and
    the answers within rel 1e-12 (a partial may sit one ulp off the host
    solve, and the device reduces the group rows in its own order).  Both
    routes take the device pilot here, so they share one anchor (the
    device pilot pre-scales to fp32, the host pilot does not)."""
    tables = _tables()
    dev_ex = _executor(TC, tables, device="cpu")
    host_ex = _executor(TC, tables, device="cpu")
    host_ex._pilot_stats_fn = lambda route: functools.partial(
        TMQ.pilot_stats_device, device="cpu")
    for seed, e in ((5, 1.0), (6, 1.0), (7, 0.5)):
        qs = _queries(TC, e) + [TC.IslaQuery(e=e, agg="count_distinct",
                                             group_by="region")]
        ad = dev_ex.run(qs, np.random.default_rng(seed), incremental=True,
                        route="device")
        ah = host_ex.run(qs, np.random.default_rng(seed), incremental=True,
                         route="host")
        for d, h in zip(ad, ah):
            assert d.new_samples == h.new_samples
            assert d.value == pytest.approx(h.value, rel=1e-12)
    assert ad[0].new_samples > 0  # the top-up drew
    assert dev_ex._device_stores
    for skey, dst in dev_ex._device_stores.items():
        assert dst.dtype == torch.float64
        got, want = dst.to_host(), host_ex._stores[skey]
        for f in ("mom_s", "mom_l", "totals", "n_sampled"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        if want.has_sketch:
            assert np.array_equal(got.regs, want.regs)


@pytest.mark.parametrize("zone", [False, True])
def test_executor_float64_ticks_fold_by_run_tables(zone, float64_default,
                                                   monkeypatch):
    """Every tagged fold of the executor's float64 device route carries
    its stream's run table, and the table describes the stream (the plain
    version checks it); with a zone map too, whose WHERE masks skip whole
    blocks."""
    from repro_torch.core import distributed as TDist

    seen = []
    real = TDist._segment_carry_sum

    def spy(*args, runs=None):
        seen.append((args[4].shape[0], runs))
        return real(*args, runs=runs)

    monkeypatch.setattr(TDist, "_segment_carry_sum", spy)
    ex = _executor(TC, _tables(), zone=zone, device="cpu")
    ex.run(_queries(TC, 1.0), np.random.default_rng(5), incremental=True,
           route="device")
    assert seen
    for m, runs in seen:
        assert runs is not None and runs.deferred
        assert runs.n_keys == len(_queries(TC)) - 1  # AVG and VAR share
        assert int(runs.table[runs.n_keys * runs.n_blocks]) == m
        assert int(runs.count) == 0


def test_store_from_continues_a_reference_float64_store():
    """A warm reference float64 store crosses as numbers
    (``convert.store_from``), goes on the device exactly
    (``from_host(dtype=torch.float64)``) and continues tick for tick as
    the reference's host store does, bit for bit."""
    rng = np.random.default_rng(6)
    b = RC.make_boundaries(MU, SIGMA, RC.IslaParams())
    ref_host = RHost.fresh(N_BLOCKS, b, MU, n_groups=N_GROUPS, shift=1.5)
    vals, bids, gids, mask, quotas = _tagged_pass(rng)
    ref_host.ingest(vals + 1.5, bids, quotas, group_ids=gids, mask=mask)
    fields = {f.name: getattr(ref_host, f.name)
              for f in dataclasses.fields(ref_host)
              if f.name not in ("boundaries", "anchor", "regs",
                                "has_sketch")}
    fields["boundaries"] = list(b.as_tuple())
    dev = TDev.from_host(convert.store_from(fields), SIZES,
                         dtype=torch.float64, device="cpu")
    assert np.array_equal(dev.to_host().mom_s, ref_host.mom_s)
    for _ in range(2):
        vals, bids, gids, mask, quotas = _tagged_pass(rng)
        ref_host.ingest(vals + 1.5, bids, quotas, group_ids=gids, mask=mask)
        dev.ingest_tick(vals + 1.5, bids, quotas, TC.IslaParams(),
                        group_ids=gids, mask=mask)
    got = dev.to_host()
    for f in ("mom_s", "mom_l", "totals", "n_sampled"):
        assert np.array_equal(getattr(got, f), getattr(ref_host, f)), f
    assert got.rounds == ref_host.rounds == 3


def test_default_dtype_follows_torch(float64_default):
    assert TDev.default_dtype() == torch.float64
    torch.set_default_dtype(torch.float32)
    assert TDev.default_dtype() == torch.float32


def test_params_from_defaults_to_the_card():
    assert inspect.signature(convert.params_from).parameters[
        "device"].default == "cuda"
