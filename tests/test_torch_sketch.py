"""The port's COUNT DISTINCT register plane against the reference: the
torch limb twin of splitmix64, the ``isla_sketch`` kernel's plain version
and its Pallas-signature wrappers, the dense sketch tick, the device
stores and stacks, the executor and the serve loop's query draw.

Every input is made from a numpy seed and crosses between JAX and torch
as numpy arrays.  Registers are compared bit for bit (tolerance 0: HLL
register planes are bit-exact, ``docs/ARCHITECTURE.md``); moments and
partials within rel 1e-5 (the reference's kernel tolerance), stat rows
within 1e-4, answers of the moment aggregates within the reference's
device-versus-host tolerances (values rel 2e-3, groups rel 5e-3).
"""
import hashlib
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core as RC
from repro.core import distributed as RD
from repro.core import sketch as RSK
from repro.core.moment_store import MomentStore as RHost
from repro.kernels import isla_moments as RK
from repro.launch import serve as RS
import repro_torch.core as TC
from repro_torch import convert
from repro_torch.core import distributed as TD
from repro_torch.core import sketch as TSK
from repro_torch.core.moment_store import DeviceMomentStore as TDev
from repro_torch.core.moment_store import DeviceStack as TStack
from repro_torch.kernels import isla_moments as TK
from repro_torch.launch import serve as TS
from _torch_sketch_cases import SKETCH_CASES, sketch_case
from test_torch_kernels import _dense_operands

ROOT = pathlib.Path(__file__).resolve().parents[1]
BOUNDS = (60.0, 90.0, 110.0, 140.0)
B, G = 5, 3
SIZES = [10 ** 6] * B
M64 = (1 << 64) - 1


def _unmix(h: int) -> int:
    """The input whose splitmix64 is ``h`` (the mix is a bijection)."""
    def unxorshift(z, s):
        x = z
        for _ in range(64 // s + 1):
            x = z ^ (x >> s)
        return x & M64

    z = unxorshift(h, 31)
    z = (z * pow(0x94D049BB133111EB, -1, 1 << 64)) & M64
    z = unxorshift(z, 27)
    z = (z * pow(0xBF58476D1CE4E5B9, -1, 1 << 64)) & M64
    z = unxorshift(z, 30)
    return (z - 0x9E3779B97F4A7C15) & M64


def _edge_values(rng):
    """±0, NaN, ±inf, denormals, integers, wide random bit patterns, and
    values whose hash has an all-zero (rho 53) or one-bit (rho 52) low
    52-bit remainder."""
    special = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324, -5e-324,
               2.2250738585072009e-308, 1e-310, np.finfo(np.float64).max,
               np.finfo(np.float64).tiny]
    ints = np.arange(-300, 300, dtype=np.float64)
    bits = rng.integers(0, 2 ** 63, 2000, dtype=np.int64).astype(np.uint64)
    crafted = np.array([_unmix((j << 52) | rem) for j in range(0, 4096, 37)
                        for rem in (0, 1)], dtype=np.uint64)
    return np.concatenate([special, ints, rng.normal(100, 20, 2000),
                           bits.view(np.float64), crafted.view(np.float64)])


def test_limb_twin_matches_reference_hash(rng):
    """(a) The port's torch limb mix and encode give the reference's
    numpy ``splitmix64``/``encode`` and its jnp ``splitmix64_graph``/
    ``encode_graph`` bit for bit, edge values included."""
    v = _edge_values(rng)
    r_hi, r_lo = RSK.value_limbs(v)
    b_hi, b_lo = TSK.bits_limbs(
        torch.as_tensor(TSK.value_bits(v).view(np.int64)))
    assert np.array_equal(b_hi.numpy(), r_hi)
    assert np.array_equal(b_lo.numpy(), r_lo)
    t_hi, t_lo = TSK.splitmix64_graph(b_hi, b_lo)
    h = RSK.hash_values(v)
    got = ((t_hi.numpy().astype(np.uint64) << np.uint64(32))
           | t_lo.numpy().astype(np.uint64))
    assert np.array_equal(got, h)
    j, rho = TSK.encode_graph(t_hi, t_lo)
    want_j, want_rho = RSK.encode(h)
    assert np.array_equal(j.numpy(), want_j)
    assert rho.dtype == torch.uint8 and np.array_equal(rho.numpy(), want_rho)
    assert (want_rho == 53).sum() >= 100 and (want_rho == 52).sum() >= 100
    g_j, g_rho = RSK.encode_graph(*RSK.splitmix64_graph(
        jnp.asarray(r_hi), jnp.asarray(r_lo)))
    assert np.array_equal(np.asarray(g_j, np.int64), j.numpy())
    assert np.array_equal(np.asarray(g_rho, np.uint8), rho.numpy())


@pytest.mark.parametrize("case", SKETCH_CASES)
def test_sketch_plain_version_matches_host_twin(case, rng):
    """(b) The kernel's plain version on the dense generalization (GROUP
    BY ids, predicates, a compacted map with pads, a prior plane) against
    the reference's host twin fold of the live lanes only."""
    panes, kw, prior, want = sketch_case(case, rng, "cpu")
    regs = prior.clone()
    TK.isla_sketch(*panes, regs, **kw)
    assert np.array_equal(regs.numpy(), want)
    # The same lanes through the reference's numpy hash give the same bits.
    bits = panes[0].numpy().view(np.uint64)
    assert np.array_equal(RSK.splitmix64(bits), TSK.splitmix64(bits))


def _tile_panes(rng, n_cells, rows):
    vals = np.round(rng.normal(0, 50, (n_cells, rows * 128)))
    valid = rng.random(vals.shape) < 0.9
    hi, lo = RSK.value_limbs(vals.reshape(-1))
    shape = (n_cells, rows, 128)
    return (hi.reshape(shape), lo.reshape(shape),
            valid.reshape(shape).astype(np.uint32))


def test_sketch_batched_matches_pallas_kernel(rng):
    """(b) ``isla_sketch_batched`` against ``isla_sketch_pallas``
    (interpret mode), one pass and a split stream merged through the
    prior (bit for bit)."""
    hi, lo, valid = _tile_panes(rng, 2, 128)
    half = 64
    want = RK.isla_sketch_pallas(jnp.asarray(hi), jnp.asarray(lo),
                                 jnp.asarray(valid), tm=64, interpret=True)
    r1 = RK.isla_sketch_pallas(jnp.asarray(hi[:, :half]),
                               jnp.asarray(lo[:, :half]),
                               jnp.asarray(valid[:, :half]), tm=64,
                               interpret=True)
    r2 = RK.isla_sketch_pallas(jnp.asarray(hi[:, half:]),
                               jnp.asarray(lo[:, half:]),
                               jnp.asarray(valid[:, half:]), tm=64,
                               interpret=True, prior=r1)
    t = torch.as_tensor
    got = TK.isla_sketch_batched(t(hi), t(lo), t(valid.view(np.int32)),
                                 tm=64)
    t1 = TK.isla_sketch_batched(t(hi[:, :half]), t(lo[:, :half]),
                                t(valid[:, :half].view(np.int32)), tm=64)
    t2 = TK.isla_sketch_batched(t(hi[:, half:]), t(lo[:, half:]),
                                t(valid[:, half:].view(np.int32)), tm=64,
                                prior=t1)
    assert got.shape == (2, 32, 128) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(t1.numpy(), np.asarray(r1))
    assert np.array_equal(t2.numpy(), np.asarray(r2))
    assert np.array_equal(t2.numpy(), got.numpy())


def test_fused_sketch_matches_pallas_kernel(rng):
    """(b) ``isla_fused_sketch`` against ``isla_fused_sketch_pallas``
    (interpret mode) on prior moments and a prior register plane:
    registers bit for bit, moments and partials within rel 1e-5."""
    n_cells, rows = 2, 128
    vals = np.round(rng.normal(100, 20, (n_cells, rows, 128)))
    prior = rng.uniform(0, 50, (n_cells, 2, 4)).astype(np.float32)
    prior_regs = rng.integers(0, 10, (n_cells, 32, 128)).astype(np.uint8)
    hi, lo, valid = _tile_panes(rng, n_cells, rows)
    bounds = np.asarray(BOUNDS, np.float32)
    mom, regs, partials = RK.isla_fused_sketch_pallas(
        jnp.asarray(vals, jnp.float32), jnp.asarray(bounds),
        jnp.asarray(prior), jnp.asarray(prior_regs), jnp.asarray(hi),
        jnp.asarray(lo), jnp.asarray(valid), jnp.float32(100.0),
        RC.IslaParams(e=0.5), tm=64, interpret=True)
    t = torch.as_tensor
    t_prior, t_regs = t(prior.copy()), t(prior_regs.copy())
    got = TK.isla_fused_sketch(
        t(vals, dtype=torch.float32), t(bounds), t_prior, t_regs, t(hi),
        t(lo), t(valid.view(np.int32)), 100.0, TC.IslaParams(e=0.5), tm=64)
    assert got[0] is t_prior and got[1] is t_regs  # updated in place
    assert np.array_equal(got[1].numpy(), np.asarray(regs))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(mom), rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(partials),
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["grouped", "predicated", "compacted"])
def test_dense_sketch_tick_matches_reference(case, rng):
    """(c) ``fused_tick_dense_sketch`` and ``fused_solve_sketch`` against
    the reference's on the same operands: the resident plane and the
    folded group rows bit for bit (pruned cells' registers untouched),
    moments rel 1e-5, partials 2e-4, stat rows 1e-4."""
    o = _dense_operands(case, rng)
    n_cells = len(o["prior"])
    raw = np.round(rng.normal(100.0, 25.0, o["v2d"].shape))
    hi, lo = RSK.value_limbs(raw)
    regs0 = rng.integers(0, 9, (n_cells, RSK.M)).astype(np.uint8)
    params = dict(mode="calibrated", geometry=None)
    f = np.float32
    j = lambda a, dt=jnp.float32: jnp.asarray(np.asarray(a), dt)  # noqa
    active = o["active_cells"]
    want = RD.fused_tick_dense_sketch(
        j(o["prior"][:, 0:4]), j(o["prior"][:, 4:8]), j(o["prior"][:, 8:]),
        j(o["ns"]), jnp.asarray(regs0), j(o["v2d"]), j(o["pad"]),
        jnp.asarray(hi), jnp.asarray(lo), j(o["quotas"]),
        (j(o["gid"], jnp.int32),), (j(o["valid"]),), j(o["bounds"]),
        j(o["sketch0"]), j(o["sizes"]), j(o["inv_scale"]),
        None if active is None else tuple(j(a, jnp.int32) for a in active),
        params=RC.IslaParams(), **params, **o["static"])
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa
        np.asarray(a).astype(f) if dt == torch.float32 else np.asarray(a),
        dtype=dt)
    state = [t(o["prior"][:, 0:4]), t(o["prior"][:, 4:8]),
             t(o["prior"][:, 8:]), t(o["ns"]), torch.as_tensor(regs0.copy())]
    got = TD.fused_tick_dense_sketch(
        *state, t(o["v2d"]), t(o["pad"]), t(raw.view(np.int64), torch.int64),
        t(o["quotas"]),
        (t(o["gid"], torch.int32),), (t(o["valid"]),), t(o["bounds"]),
        t(o["sketch0"]), t(o["sizes"]), t(o["inv_scale"]),
        None if active is None else tuple(t(a, torch.int32) for a in active),
        params=TC.IslaParams(), **params, **o["static"])
    for k in range(5):
        assert got[k] is state[k]  # resident state updated in place
    assert np.array_equal(got[4].numpy(), np.asarray(want[4]))
    assert np.array_equal(got[7].numpy(), np.asarray(want[7]))
    assert not np.array_equal(got[4].numpy(), regs0)
    for k in range(3):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                               rtol=2e-4)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]),
                               rtol=1e-4, atol=1e-4)
    if active is not None:
        touched = active[0][active[0] < n_cells]
        idle = np.setdiff1d(np.arange(n_cells), touched)
        assert idle.size and np.array_equal(got[4].numpy()[idle],
                                            regs0[idle])
    solve_r = RD.fused_solve_sketch(
        *want[:5], j(o["sketch0"]), j(o["sizes"]), j(o["inv_scale"]),
        params=RC.IslaParams(), mode="faithful",
        n_groups_list=o["static"]["n_groups_list"])
    solve_t = TD.fused_solve_sketch(
        *got[:5], t(o["sketch0"]), t(o["sizes"]), t(o["inv_scale"]),
        params=TC.IslaParams(), mode="faithful",
        n_groups_list=o["static"]["n_groups_list"])
    assert np.array_equal(solve_t[2].numpy(), np.asarray(solve_r[2]))
    np.testing.assert_allclose(solve_t[0].numpy(), np.asarray(solve_r[0]),
                               rtol=2e-4)


def _stream(rng, n):
    return np.round(rng.normal(100.0, 20.0, n))


def _host(n_blocks=B):
    return RHost.fresh(n_blocks, RC.Boundaries(*BOUNDS), 100.0, n_groups=G,
                       has_sketch=True)


def _dev(n_blocks=B, n_groups=G, has_sketch=True):
    return TDev.fresh_device(n_blocks, TC.Boundaries(*BOUNDS), 100.0,
                             [10 ** 6] * n_blocks, n_groups=n_groups,
                             has_sketch=has_sketch, device="cpu")


def test_dense_stack_tick_matches_host_plane(rng):
    """(d) The dense stack tick's register plane after three ticks is the
    reference host ``MomentStore`` plane bit for bit (the reference's
    ``test_sketch_plane.py`` dense case), and so are the folded group
    rows and the distinct estimates."""
    quota = 200
    bids = np.repeat(np.arange(B), quota)
    quotas = np.full(B, quota, np.int64)
    host, dev = _host(), _dev()
    stack = TStack([dev])
    for _ in range(3):
        vals = _stream(rng, B * quota)
        gids = rng.integers(0, G, vals.size)
        host.ingest(vals, bids, quotas, group_ids=gids)
        stack.tick(TC.IslaParams(), values=vals, quotas=quotas,
                   dense=([gids], [None]))
    assert dev.regs.dtype == torch.uint8
    assert np.array_equal(dev.regs.numpy(), host.regs)
    assert np.array_equal(dev.group_registers(), host.group_registers())
    assert np.array_equal(dev.distinct_counts(), host.distinct_counts())


def test_pruned_cells_keep_registers_and_reactivate_warm(rng):
    """(d) Compacted ticks over zone-pruned blocks never address the
    pruned cells' registers; the blocks re-activate warm and the plane
    stays the host fold of the same per-block history, bit for bit."""
    n_b, quota = 20, 60
    host, dev = _host(n_b), _dev(n_b)
    stack = TStack([dev])
    for r in range(4):
        active = (np.arange(n_b) % 3 == 0) if r % 2 else np.ones(n_b, bool)
        quotas = np.where(active, quota, 0).astype(np.int64)
        vals = _stream(rng, int(quotas.sum()))
        bids = np.repeat(np.arange(n_b), quotas)
        gids = rng.integers(0, G, vals.size)
        before = dev.regs.clone()
        host.ingest(vals, bids, quotas, group_ids=gids)
        stack.tick(TC.IslaParams(), values=vals, quotas=quotas,
                   dense=([gids], [None]))
        if r % 2:
            idle = [g * n_b + b for g in range(G) for b in range(n_b)
                    if not active[b]]
            assert torch.equal(dev.regs[idle], before[idle])
    assert stack._active_cache  # the compacted launch ran
    assert np.array_equal(dev.regs.numpy(), host.regs)
    assert np.array_equal(dev.distinct_counts(), host.distinct_counts())


def test_mixed_stack_and_round_trip(rng):
    """(d) A stack of a sketch GROUP BY key, a plain key without a sketch
    and a sketch WHERE key: each sketch store's plane is its host store's
    bit for bit, the plain key carries none; ``to_host`` / ``from_host``
    carry the plane across and the round-tripped store ticks on equal."""
    quota = 80
    quotas = np.full(B, quota, np.int64)
    bids = np.repeat(np.arange(B), quotas)
    grouped, plain, where = _dev(), _dev(n_groups=1, has_sketch=False), \
        _dev(n_groups=1)
    h_grouped = _host()
    h_where = RHost.fresh(B, RC.Boundaries(*BOUNDS), 100.0, has_sketch=True)
    stack = TStack([grouped, plain, where])
    assert stack.has_sketch and plain.regs is None
    for _ in range(2):
        vals = _stream(rng, int(quotas.sum()))
        gids = rng.integers(0, G, vals.size)
        mask = rng.random(vals.size) < 0.5
        h_grouped.ingest(vals, bids, quotas, group_ids=gids)
        h_where.ingest(vals, bids, quotas, mask=mask)
        stack.tick(TC.IslaParams(), values=vals, quotas=quotas,
                   dense=([gids, None, None], [None, None, mask]))
    assert np.array_equal(grouped.regs.numpy(), h_grouped.regs)
    assert np.array_equal(where.regs.numpy(), h_where.regs)
    assert np.array_equal(where.group_registers(), h_where.group_registers())
    with pytest.raises(ValueError, match="sketch"):
        plain.group_registers()
    back = grouped.to_host()
    assert back.has_sketch and np.array_equal(back.regs, h_grouped.regs)
    again = TDev.from_host(back, SIZES, device="cpu")
    assert np.array_equal(again.regs.numpy(), h_grouped.regs)
    stack.release()
    assert np.array_equal(grouped.regs.numpy(), h_grouped.regs)
    vals = _stream(rng, int(quotas.sum()))
    gids = rng.integers(0, G, vals.size)
    h_grouped.ingest(vals, bids, quotas, group_ids=gids)
    for d in (grouped, again):
        d.ingest_tick(vals, bids, quotas, TC.IslaParams(), group_ids=gids)
        assert np.array_equal(d.regs.numpy(), h_grouped.regs)
        assert np.array_equal(d.distinct_counts(),
                              h_grouped.distinct_counts())


def test_warm_repeat_reads_back_only_folded_rows(rng, monkeypatch):
    """(e) A tick reads back the O(groups) folded register rows with the
    stat rows and never the resident plane; its uploads are sample-sized;
    a warm zero-draw repeat uploads nothing and launches nothing."""
    n_blocks, n_groups, quota = 40, 8, 50
    dev = _dev(n_blocks, n_groups)
    quotas = np.full(n_blocks, quota, np.int64)
    bids = np.repeat(np.arange(n_blocks), quotas)

    def tick():
        vals = _stream(rng, int(quotas.sum()))
        gids = rng.integers(0, n_groups, vals.size)
        dev.ingest_tick(vals, bids, quotas, TC.IslaParams(), group_ids=gids)
        return vals.size

    tick()
    uploads, readbacks = [], []
    real_h2d, real_install = TD.h2d, TStack._install_stats

    def h2d(*args, **kwargs):
        uploads.append(np.asarray(args[0]).nbytes)
        return real_h2d(*args, **kwargs)

    def install(self, partials, rows, cfg, timings=None, group_regs=None,
                **kw):
        readbacks.append(None if group_regs is None
                         else tuple(group_regs.shape))
        return real_install(self, partials, rows, cfg, timings, group_regs,
                            **kw)

    def no_plane(self, store, idx):
        raise AssertionError("the resident plane was read")

    monkeypatch.setattr(TD, "h2d", h2d)
    monkeypatch.setattr(TStack, "_install_stats", install)
    n = tick()
    regs_bytes = n_blocks * n_groups * TSK.M
    assert uploads and max(uploads) <= 8 * 2 * n < regs_bytes
    assert readbacks == [(n_groups, TSK.M)]
    monkeypatch.setattr(TStack, "state_slice", no_plane)
    folded = dev.group_registers()
    assert folded.shape == (n_groups, TSK.M)
    uploads.clear()
    readbacks.clear()
    launches = TK.isla_sketch.launches, TK.isla_fold.launches
    dev.solve_device(TC.IslaParams())
    assert uploads == [] and readbacks == []
    assert (TK.isla_sketch.launches, TK.isla_fold.launches) == launches
    assert dev.group_registers() is folded
    # Another mode misses the cache: the zero-draw re-solve re-folds the
    # resident registers on the device and reads back the folded rows.
    dev.solve_device(TC.IslaParams(), mode="faithful")
    assert uploads == [] and readbacks == [(n_groups, TSK.M)]
    assert np.array_equal(dev.group_registers(), folded)


_SUBPROC = r"""
import hashlib
import numpy as np
from repro_torch.core.moment_store import DeviceMomentStore, DeviceStack
from repro_torch.core.types import Boundaries, IslaParams

rng = np.random.default_rng(123)
vals = np.round(rng.normal(100.0, 20.0, 4000) * 8.0) / 8.0
gids = rng.integers(0, 3, vals.size)
quotas = np.full(4, 1000, np.int64)
dev = DeviceMomentStore.fresh_device(
    4, Boundaries(60.0, 90.0, 110.0, 140.0), 100.0, [10 ** 6] * 4,
    n_groups=3, has_sketch=True, device="cpu")
DeviceStack([dev]).tick(IslaParams(), values=vals, quotas=quotas,
                        dense=([gids], [None]))
print(hashlib.sha256(dev.regs.numpy().tobytes()).hexdigest())
"""


def test_register_plane_is_deterministic_across_interpreters():
    """(f) Two fresh interpreters (different PYTHONHASHSEED) build the
    byte-identical device plane, which is the reference host plane of the
    same stream."""
    digests = []
    for seed in ("1", "2"):
        out = subprocess.run(
            [sys.executable, "-c", _SUBPROC], capture_output=True,
            text=True, check=True, timeout=300, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     PYTHONHASHSEED=seed))
        digests.append(out.stdout.strip())
    assert digests[0] == digests[1]
    rng = np.random.default_rng(123)
    vals = np.round(rng.normal(100.0, 20.0, 4000) * 8.0) / 8.0
    gids = rng.integers(0, 3, vals.size)
    host = RHost.fresh(4, RC.Boundaries(60.0, 90.0, 110.0, 140.0), 100.0,
                       n_groups=3, has_sketch=True)
    host.ingest(vals, np.repeat(np.arange(4), 1000),
                np.full(4, 1000, np.int64), group_ids=gids)
    assert hashlib.sha256(host.regs.tobytes()).hexdigest() == digests[0]


def _distinct_tables(seed=0, n_blocks=6, rows=2500):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_blocks):
        g = rng.integers(0, 3, size=rows)
        out.append({
            "value": 90.0 + 0.05 * (rng.integers(0, 600, rows)
                                    % (200 * (g + 1))),
            "region": g.astype(np.float64),
            "flag": rng.integers(0, 2, size=rows).astype(np.float64)})
    return out


def _distinct_queries(C, e):
    flag = C.Predicate(column="flag", eq=1.0)
    return [C.IslaQuery(e=e, agg="count_distinct"),
            C.IslaQuery(e=e, agg="count_distinct", where=flag),
            C.IslaQuery(e=e, agg="count_distinct", group_by="region"),
            C.IslaQuery(e=e, agg="count_distinct", group_by="region",
                        where=flag),
            C.IslaQuery(e=e, agg="AVG", group_by="region")]


def test_executor_distinct_device_route_matches_host_routes():
    """(g) ``count_distinct`` on the four serving keys over three
    incremental ticks (cold, top-up, warm repeat): the device route (CPU
    tensors) gives the port's host route's answers — distinct values and
    bounds exactly, the AVG within fp32 tolerance — with identical draw
    ledgers, and the host route gives the reference executor's."""
    tables = _distinct_tables()
    runs = {}
    for name, C, kw, route in (("ref", RC, {}, "host"),
                               ("host", TC, {"device": "cpu"}, "host"),
                               ("device", TC, {"device": "cpu"}, "device")):
        ex = C.MultiQueryExecutor(
            [C.table_sampler(t) for t in tables], [10 ** 6] * len(tables),
            params=C.IslaParams(e=0.5), group_domains={"region": 3}, **kw)
        runs[name] = [ex.run(_distinct_queries(C, e),
                             np.random.default_rng(seed), incremental=True,
                             route=route)
                      for seed, e in ((1, 0.5), (2, 0.25), (3, 0.25))]
        if name == "device":
            assert all(d.has_sketch for d in ex._device_stores.values())
    for tick, (ref, host, dev) in enumerate(zip(*runs.values())):
        for r, h, d in zip(ref, host, dev):
            assert (h.value, h.error_bound, h.new_samples, h.sample_size) \
                == (r.value, r.error_bound, r.new_samples, r.sample_size)
            assert (d.new_samples, d.sample_size) == (h.new_samples,
                                                      h.sample_size)
            if h.query.agg == "count_distinct":
                assert (d.value, d.error_bound) == (h.value, h.error_bound)
            else:
                assert d.value == pytest.approx(h.value, rel=2e-3)
            if h.groups is not None:
                for gd, gh in zip(d.groups, h.groups):
                    assert gd.n_samples == gh.n_samples
                    if h.query.agg == "count_distinct":
                        assert gd.value == gh.value
                    else:
                        assert gd.value == pytest.approx(gh.value, rel=5e-3)
    assert all(a.new_samples == 0 for a in runs["device"][2])
    assert runs["device"][1][0].new_samples > 0


def test_random_query_draws_the_reference_sequence():
    """(h) The serve loop's random query stream is the reference's, draw
    for draw, all five aggregates included."""
    r_rng, t_rng = np.random.default_rng(7), np.random.default_rng(7)
    seen = set()
    for _ in range(200):
        r = RS._random_query(r_rng, 0.5, n_days=4)
        t = TS._random_query(t_rng, 0.5, n_days=4)
        assert (t.agg, t.group_by, t.mode, t.e, t.beta) == (
            r.agg, r.group_by, r.mode, r.e, r.beta)
        assert (t.where is None) == (r.where is None)
        if r.where is not None:
            assert (t.where.column, t.where.eq) == (r.where.column,
                                                    r.where.eq)
        seen.add(t.agg)
    assert seen == set(TC.multiquery.AGGREGATES)


def test_convert_carries_the_register_plane(rng):
    """Repair: ``convert.store_from`` carries a reference store's sketch
    plane (uint8 ``(n_cells, 4096)``, checked), so the converted store's
    registers and folded group rows are the reference's."""
    ref = RHost.fresh(B, RC.Boundaries(*BOUNDS), 100.0, n_groups=G,
                      has_sketch=True)
    for _ in range(2):
        vals = _stream(rng, 600)
        ref.ingest(vals, rng.integers(0, B, vals.size),
                   np.full(B, 120, np.int64),
                   group_ids=rng.integers(0, G, vals.size))
    fields = dict(n_blocks=B, n_groups=G, boundaries=list(BOUNDS),
                  sketch0=ref.sketch0, shift=ref.shift, mom_s=ref.mom_s,
                  mom_l=ref.mom_l, totals=ref.totals,
                  n_sampled=ref.n_sampled, rounds=ref.rounds,
                  has_sketch=ref.has_sketch, regs=ref.regs)
    st = convert.store_from(fields)
    assert st.has_sketch and st.regs.dtype == np.uint8
    assert np.array_equal(st.regs, ref.regs)
    assert np.array_equal(st.group_registers(), ref.group_registers())
    with pytest.raises(ValueError, match="uint8"):
        convert.store_from(dict(fields, regs=ref.regs.astype(np.int16)))
    with pytest.raises(ValueError, match="regs must be"):
        convert.store_from(dict(fields, regs=ref.regs[:-1]))
    with pytest.raises(ValueError, match="has_sketch"):
        convert.store_from(dict(fields, regs=None))


def test_unported_sketch_paths_name_their_roadmap_item(monkeypatch,
                                                       capsys):
    """LM serving of a config with a Mamba2 mixer (jamba: Mamba,
    attention and MoE positions), which raised until its ROADMAP Queue A
    item landed, serves the CLI's six requests, and ROADMAP.md lists that
    item (9) and the MoE channel's (8), both landed.  The dense
    payload on a float64 sketch stack (item 1b, once refused here), the
    mesh route (item 4, its sketch families with it) and the pipelined
    tick (item 3) run, and ROADMAP.md still lists all three items: the
    float64 dense sketch tick merges the host's registers, and on a
    one-shard CPU mesh COUNT DISTINCT answers as on the device route, and
    pipelined as serially, register plane and all."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--workload", "lm", "--arch", "jamba-1.5-large-398b",
        "--reduced", "--device", "cpu"])
    roadmap = (ROOT / "ROADMAP.md").read_text()

    def executor():
        return TC.MultiQueryExecutor(
            [TC.table_sampler(t) for t in _distinct_tables(n_blocks=2)],
            [10 ** 6] * 2, device="cpu")

    q = [TC.IslaQuery(e=1.0, agg="count_distinct")]
    b = TC.make_boundaries(100.0, 20.0, TC.IslaParams())
    dev64 = TDev.fresh_device(
        2, b, 100.0, [10, 10], dtype=torch.float64, has_sketch=True,
        device="cpu")
    host64 = dev64.to_host()
    vals64 = np.array([97.5, 101.25, 0.0, -3.0])
    TStack([dev64]).tick(TC.IslaParams(), values=vals64,
                         quotas=np.array([3, 1]), dense=([None], [None]))
    host64.ingest(vals64 + host64.shift, np.array([0, 0, 0, 1]),
                  np.array([3, 1]), raw_values=vals64)
    assert np.array_equal(dev64.regs.numpy(), host64.regs)
    assert np.array_equal(dev64.n_sampled, host64.n_sampled)
    TS.main()
    assert "served 6 requests, 78 tokens" in capsys.readouterr().out
    for item in (("1b", "The float64 dense tick"), (8, "MoE channel"),
                 (9, "Mamba2 mixer")):
        assert re.search(rf"^{item[0]}\. \*\*{re.escape(item[1])}", roadmap,
                         re.M)
    for item in ("8. **MoE channel:** landed", "9. **Mamba2 mixer:** landed"):
        assert item in roadmap, item
    assert re.search(r"^4\. \*\*Mesh route", roadmap, re.M)
    assert re.search(r"^3\. \*\*Pipelined tick", roadmap, re.M)
    answers = {route: executor().run(q, np.random.default_rng(0),
                                     route=route, incremental=True)[0]
               for route in ("device", "mesh")}
    assert answers["mesh"].value == answers["device"].value > 0
    regs = []
    for pipeline in (False, True):
        ex = executor()
        (a,) = ex.run(q, np.random.default_rng(0), incremental=True,
                      pipeline=pipeline)
        assert a.value == answers["device"].value
        (dst,) = ex._device_stores.values()
        regs.append(dst.regs.numpy())
    assert np.array_equal(regs[1], regs[0])
