"""The port's device-resident tick (``DeviceStack`` / ``DeviceMomentStore``
on the CPU, i.e. the fold's plain version) against the reference's fp32
``DeviceStack`` on the same stores and panes, the carried-over state of
``repro_torch.convert``, and the sanctioned upload count.

Tolerances are the reference's: moments rtol 1e-5 / atol 1e-4
(``test_device_store.py``'s dense-vs-tagged check), partials rtol 2e-4,
stat rows allclose.
"""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core as RC
from repro.core import distributed as RD
from repro.core.moment_store import DeviceMomentStore as RDev
from repro.core.moment_store import DeviceStack as RStack
from repro.core.moment_store import MomentStore as RHost
import repro_torch.core as TC
from repro_torch import convert
from repro_torch.core import distributed as TD
from repro_torch.core.moment_store import DeviceMomentStore as TDev
from repro_torch.core.moment_store import DeviceStack as TStack
from repro_torch.core.moment_store import MomentStore as THost

MU, SIGMA = 100.0, 20.0
N_BLOCKS, N_GROUPS = 12, 3
SIZES = [10 ** 6] * N_BLOCKS


def _anchors(hetero):
    """Per-key (sketch0, sigma, shift) frames: one shared anchor, or three
    distinct ones (the per-key refined-anchor stack)."""
    if not hetero:
        return [(MU, SIGMA, 0.0)] * 3
    return [(MU, SIGMA, 0.0), (MU + 6.0, 0.7 * SIGMA, 3.0),
            (MU - 4.0, 1.3 * SIGMA, -2.0)]


def _stores(C, Dev, hetero, **kw):
    out = []
    for (sk, sig, shift), g in zip(_anchors(hetero), (1, N_GROUPS, 1)):
        b = C.make_boundaries(sk + shift, sig, C.IslaParams())
        out.append(Dev.fresh_device(N_BLOCKS, b, sk + shift, SIZES,
                                    shift=shift, n_groups=g, **kw))
    return out


def _pass(rng, quota, pruned=()):
    quotas = np.full(N_BLOCKS, quota, dtype=np.int64)
    quotas[list(pruned)] = 0
    n = int(quotas.sum())
    vals = rng.normal(MU, SIGMA, n)
    gids = rng.integers(0, N_GROUPS, n)
    mask = rng.random(n) < 0.7
    # keys: plain, GROUP BY, WHERE
    return vals, quotas, ([None, gids, None], [None, None, mask])


def _assert_store_close(t, r):
    th, rh = t.to_host(), r.to_host()
    for name in ("mom_s", "mom_l", "totals"):
        np.testing.assert_allclose(getattr(th, name), getattr(rh, name),
                                   rtol=1e-5, atol=1e-4 * t.scale ** 3)
    assert np.array_equal(th.n_sampled, rh.n_sampled)
    assert th.rounds == rh.rounds
    np.testing.assert_allclose(t.partials_host(), r.partials_host(),
                               rtol=2e-4)
    np.testing.assert_allclose(t._rows, np.asarray(r._rows), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["uniform", "hetero", "pruned"])
def test_stack_tick_matches_reference(case, rng):
    """Three keys (plain, GROUP BY, WHERE) stacked into one tick, three
    draws then a zero-draw re-solve in another mode; the pruned case
    zeroes half the blocks' quotas (the compacted fold) on alternate
    ticks."""
    hetero = case == "hetero"
    t_st = _stores(TC, TDev, hetero, device="cpu")
    r_st = _stores(RC, RDev, hetero, dtype=jnp.float32)
    t_stack, r_stack = TStack(t_st), RStack(r_st)
    params_t, params_r = TC.IslaParams(), RC.IslaParams()
    for tick in range(3):
        pruned = ((1, 3, 4, 6, 8, 10) if case == "pruned" and tick != 1
                  else ())
        vals, quotas, dense = _pass(rng, 40 + 10 * tick, pruned)
        t_stack.tick(params_t, values=vals, quotas=quotas, dense=dense)
        r_stack.tick(params_r, values=vals, quotas=quotas, dense=dense)
        for t, r in zip(t_st, r_st):
            _assert_store_close(t, r)
    assert bool(t_stack._active_cache) == (case == "pruned")
    # Zero-draw repeat in another mode: fused_solve over resident state.
    t_stack.tick(params_t, mode="faithful")
    r_stack.tick(params_r, mode="faithful")
    for t, r in zip(t_st, r_st):
        _assert_store_close(t, r)
    # A warm repeat under the same configuration is served from the cache.
    out = t_stack.tick(params_t, mode="faithful")
    assert out[1][0] is t_st[1]._partials


def test_ingest_tick_matches_host_store(rng):
    """Single-store convenience tick against the host float64 store."""
    b = TC.make_boundaries(MU, SIGMA, TC.IslaParams())
    host = THost.fresh(N_BLOCKS, b, MU, n_groups=N_GROUPS)
    dev = TDev.fresh_device(N_BLOCKS, b, MU, SIZES, n_groups=N_GROUPS,
                            device="cpu")
    for _ in range(2):
        quotas = np.full(N_BLOCKS, 3000, dtype=np.int64)
        vals = rng.normal(MU, SIGMA, quotas.sum())
        bids = np.repeat(np.arange(N_BLOCKS), quotas)
        gids = rng.integers(0, N_GROUPS, vals.size)
        mask = rng.random(vals.size) < 0.8
        host.ingest(vals, bids, quotas, group_ids=gids, mask=mask)
        dev.ingest_tick(vals, bids, quotas, TC.IslaParams(), group_ids=gids,
                        mask=mask)
    res = host.solve(TC.IslaParams(), mode="calibrated")
    dh = dev.to_host()
    np.testing.assert_allclose(dh.mom_s, host.mom_s, rtol=5e-6, atol=1e-3)
    np.testing.assert_allclose(dh.mom_l, host.mom_l, rtol=5e-6, atol=1e-3)
    np.testing.assert_allclose(dev.partials_host(), res.avg, rtol=2e-4)
    assert np.array_equal(dh.n_sampled, host.n_sampled)
    assert dev.sample_sigma() == pytest.approx(host.sample_sigma(),
                                               rel=1e-4)


def test_convert_continues_a_reference_store(rng):
    """A warm reference store, dumped as numbers and arrays, continues in
    the port tick for tick: the host layer bit-identically, the device
    layer within fp32 tolerance of the reference's device store."""
    params_r = RC.IslaParams(e=0.5, thr=2e-4)
    b = RC.make_boundaries(MU, SIGMA, params_r)
    anchor = RC.Anchor(boundaries=b, sketch0=MU, shift=1.5, sigma=SIGMA)
    ref_host = RHost.from_anchor(N_BLOCKS, anchor, n_groups=N_GROUPS)

    def tagged(quota):
        quotas = np.full(N_BLOCKS, quota, dtype=np.int64)
        vals = rng.normal(MU, SIGMA, quotas.sum())
        return (vals, np.repeat(np.arange(N_BLOCKS), quotas), quotas,
                rng.integers(0, N_GROUPS, vals.size))

    for _ in range(2):
        vals, bids, quotas, gids = tagged(500)
        ref_host.ingest(vals, bids, quotas, group_ids=gids)
    fields = {f.name: getattr(ref_host, f.name)
              for f in dataclasses.fields(ref_host)
              if f.name in ("n_blocks", "n_groups", "sketch0", "shift",
                            "mom_s", "mom_l", "totals", "n_sampled",
                            "rounds", "has_regions", "has_totals")}
    fields["boundaries"] = list(b.as_tuple())
    t_anchor = convert.anchor_from(b.as_tuple(), anchor.sketch0,
                                   anchor.shift, anchor.sigma)
    port_host = convert.store_from(fields, anchor=t_anchor)
    params_t = convert.params_from(dataclasses.asdict(params_r))
    assert dataclasses.asdict(params_t) == dataclasses.asdict(params_r)
    assert port_host.anchor.fingerprint == anchor.fingerprint

    r_dev = RDev.from_host(ref_host, SIZES, dtype=jnp.float32)
    t_dev = TDev.from_host(port_host, SIZES, device="cpu")
    for _ in range(2):
        vals, bids, quotas, gids = tagged(300)
        ref_host.ingest(vals, bids, quotas, group_ids=gids)
        port_host.ingest(vals, bids, quotas, group_ids=gids)
        r_dev.ingest_tick(vals - 1.5, bids, quotas, params_r,
                          group_ids=gids)
        t_dev.ingest_tick(vals - 1.5, bids, quotas, params_t,
                          group_ids=gids)
        for name in ("mom_s", "mom_l", "totals", "n_sampled"):
            assert np.array_equal(getattr(port_host, name),
                                  getattr(ref_host, name))
        _assert_store_close(t_dev, r_dev)
    assert np.array_equal(port_host.solve(params_t).avg,
                          ref_host.solve(params_r).avg)


def _count_h2d(monkeypatch, module, calls):
    real = module.h2d

    def h2d(*args, **kwargs):
        calls.append(np.asarray(args[0]).nbytes)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, "h2d", h2d)


@pytest.mark.parametrize("case,expected", [("one_grouped_store", 4),
                                           ("four_keys", 5)])
def test_steady_tick_upload_count_matches_reference(case, expected, rng,
                                                    monkeypatch):
    """A steady tick crosses host->device only through ``h2d``, as often
    as the reference and with the same bytes, and never ships moments:
    one grouped store (the reference's ``sanctioned_h2d_per_tick`` = 4:
    quotas, value pane, pad mask, GROUP BY pane), and the four serving
    keys (plain, WHERE, GROUP BY, WHERE + GROUP BY), which add the
    predicate pane."""
    groups = (N_GROUPS,) if case == "one_grouped_store" else (
        1, 1, N_GROUPS, N_GROUPS)

    def stores(C, Dev, **kw):
        b = C.make_boundaries(MU, SIGMA, C.IslaParams())
        return [Dev.fresh_device(N_BLOCKS, b, MU, SIZES, n_groups=g, **kw)
                for g in groups]

    t_stack = TStack(stores(TC, TDev, device="cpu"))
    r_stack = RStack(stores(RC, RDev, dtype=jnp.float32))
    passes = []
    for _ in range(2):
        vals, quotas, _ = _pass(rng, 30)
        gids = rng.integers(0, N_GROUPS, vals.size)
        mask = rng.random(vals.size) < 0.6
        dense = (([gids], [None]) if case == "one_grouped_store" else
                 ([None, None, gids, gids], [None, mask, None, mask]))
        passes.append((vals, quotas, dense))
    t_calls, r_calls = [], []
    for stack, module, calls, params in (
            (t_stack, TD, t_calls, TC.IslaParams()),
            (r_stack, RD, r_calls, RC.IslaParams())):
        vals, quotas, dense = passes[0]
        stack.tick(params, values=vals, quotas=quotas, dense=dense)  # warm
        _count_h2d(monkeypatch, module, calls)
        vals, quotas, dense = passes[1]
        stack.tick(params, values=vals, quotas=quotas, dense=dense)
    assert len(t_calls) == len(r_calls) == expected
    assert sum(t_calls) == sum(r_calls)  # sample-sized bytes only


def test_unported_paths_raise(rng):
    """Deferred stats (the pipelined tick, once refused here) return lazy
    rows that land equal to a serial tick's; the dense payload on a
    float64 store (once refused here, ROADMAP item 1b) runs: its float64
    fold sits within 1e-12 of the tagged layout's carry fold."""
    b = TC.make_boundaries(MU, SIGMA, TC.IslaParams())
    vals, quotas, dense = _pass(rng, 20)
    outs = []
    for defer in (False, True):
        stack = TStack(_stores(TC, TDev, False, device="cpu"))
        out = stack.tick(TC.IslaParams(), values=vals, quotas=quotas,
                         dense=dense, defer_stats=defer)
        out += stack.tick(TC.IslaParams(), mode="faithful",
                          defer_stats=defer)
        outs.append([(p.clone(), np.asarray(r)) for p, r in out])
        assert all(st._rows is not None for st in stack.stores)
    for (p0, r0), (p1, r1) in zip(*outs):
        assert torch.equal(p1, p0) and np.array_equal(r1, r0)
    stores64 = {lay: TDev.fresh_device(2, b, MU, [10, 10],
                                       dtype=torch.float64, device="cpu")
                for lay in ("dense", "tagged")}
    vals64 = rng.normal(MU, SIGMA, 4)
    for lay, dev64 in stores64.items():
        dev64.ingest_tick(vals64, np.array([0, 0, 1, 1]), np.array([2, 2]),
                          TC.IslaParams(), layout=lay)
    dense, tagged = (stores64[k].to_host() for k in ("dense", "tagged"))
    assert np.array_equal(dense.n_sampled, [2, 2])
    for name in ("mom_s", "mom_l", "totals"):
        np.testing.assert_allclose(getattr(dense, name),
                                   getattr(tagged, name), rtol=1e-12,
                                   atol=0)


def test_stack_release_keeps_state(rng):
    """Dissolving a stack hands every store its own copy of its rows."""
    t_st = _stores(TC, TDev, False, device="cpu")
    stack = TStack(t_st)
    vals, quotas, dense = _pass(rng, 20)
    stack.tick(TC.IslaParams(), values=vals, quotas=quotas, dense=dense)
    snap = [st.mom_s.clone() for st in t_st]
    stack2 = TStack([t_st[1], t_st[0]])
    assert stack._released and stack2.stores[0] is t_st[1]
    for st, s in zip(t_st, snap):
        assert torch.equal(st.mom_s, s)
    with pytest.raises(ValueError, match="released"):
        stack.tick(TC.IslaParams())


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    """Entry points default to the card and never drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = TC.make_boundaries(MU, SIGMA, TC.IslaParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDev.fresh_device(2, b, MU, [10, 10])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.pilot_stats_device(np.ones(8))
