"""The float64 dense tick of the port on the CPU (``DeviceStack.tick(
dense=...)`` on a float64 stack, compacted or full, on ``DeviceStack``
and ``MeshDeviceStack``, sketch stacks included; ``ingest_tick(layout=
"dense")`` on a float64 store) and the fold's plain version at float64.

Tolerances, as the reference's own float64 dense tick shows them:
- compacted against full launch, the mesh (S = 1-4 CPU shards) against
  ``DeviceStack``, register planes against the host's: bit for bit;
- moment state, totals and partials within a relative 1e-12 of the
  reference's float64 dense tick, of the host ``MomentStore`` carry fold
  and of the port's own float64 tagged tick (the dense fold sums each
  cell's delta, then adds it onto the row: not the carry fold's order);
- the plain fold within a relative 1e-12 of a float64 numpy loop.

The reference runs under ``jax.config.update("jax_enable_x64", True)``,
restored after each test.  Mirrors ``tests/test_zone_pruning.py``'s
``test_compacted_launch_bit_identical_x64`` and
``test_pruned_cells_stay_resident_and_reactivate_warm``.
"""
import numpy as np
import pytest
import torch

import jax
import repro.core as RC
from repro.core.moment_store import DeviceMomentStore as RDev
from repro.core.moment_store import DeviceStack as RStack
import repro_torch.core as TC
from repro_torch.core import sketch as TSK
from repro_torch.core.moment_store import DeviceMomentStore as TDev
from repro_torch.core.moment_store import DeviceStack as TStack
from repro_torch.core.moment_store import MeshDeviceStack as TMesh
from repro_torch.kernels import isla_moments as K
from repro_torch.launch.mesh import make_cell_mesh
import _torch_dense64_cases as DC
import _torch_mesh_cases as MC

F64 = torch.float64
PARAMS = TC.IslaParams()
MU, SIGMA = 100.0, 12.0
REL = 1e-12


@pytest.fixture
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=REL, atol=0, err_msg=what)


# ---------------------------------------------------------------------------
# The plain fold at float64.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("affine", [None, (1.0, 0.25)],
                         ids=["identity", "affine"])
def test_plain_fold_f64_matches_numpy_loop(affine):
    """The plain fold at float64 (the CPU path and the card tests' oracle)
    against a float64 numpy loop, for the four stacked keys."""
    case = DC.fold_case(9, 40, seed=3)
    got = DC.fold(case, affine=affine)
    assert got.dtype == F64
    _close(got.numpy(), DC.numpy_fold(case, affine), "plain fold")


@pytest.mark.parametrize("q", [40, 1000, 1024])
def test_plain_fold_f64_compacted_rows_bit_identical(q):
    """Folding a subset of the rows (the compacted launch, cells mapped
    back by ``cell_idx``) gives those rows' cells the full fold's bits,
    across row counts; rows left out keep their prior rows."""
    case = DC.fold_case(24, q, seed=1)
    full = DC.fold(case)
    for rows in ([3, 17], [5], list(range(0, 24, 3)), list(range(11))):
        got = DC.fold(case, rows=rows)
        n = case["values"].shape[0]
        cells = np.concatenate([
            key.offset + np.arange(g)[:, None] * n + np.asarray(rows)
            for key, (g, _) in zip(DC.stack_keys(n), DC.KEYS)], axis=None)
        assert torch.equal(got[cells], full[cells])
        rest = np.setdiff1d(np.arange(got.shape[0]), cells)
        assert torch.equal(got[rest], case["prior"][rest])


def test_fold_rejects_mixed_dtypes():
    """A float64 pane takes float64 cuts and rows: an fp32 one is refused,
    never cast."""
    case = DC.fold_case(3, 8)
    keys = DC.stack_keys(3)
    rows = case["prior"].float()
    with pytest.raises(ValueError, match="float64"):
        K.isla_fold_stack(case["values"], case["bounds"].float(),
                          rows[:, :4], rows[:, 4:8], rows[:, 8:], keys=keys,
                          pad=case["pad"], gid_panes=(case["gid"],),
                          valid_panes=(case["valid"],))
    with pytest.raises(ValueError, match="out_s"):
        K.isla_fold_stack(case["values"], case["bounds"], rows[:, :4],
                          rows[:, 4:8], rows[:, 8:], keys=keys,
                          pad=case["pad"], gid_panes=(case["gid"],),
                          valid_panes=(case["valid"],))


# ---------------------------------------------------------------------------
# The compacted launch (mirrors of tests/test_zone_pruning.py's x64 tests).
# ---------------------------------------------------------------------------


def _zone_stack(C, Dev, Stack, compaction, sketch=False, **kw):
    n_blocks, n_groups = 24, 3
    b = C.make_boundaries(MU, SIGMA, C.IslaParams())
    stack = Stack([Dev.fresh_device(n_blocks, b, MU, np.full(n_blocks, 1e6),
                                    n_groups=g, has_sketch=sketch, **kw)
                   for g in (1, n_groups)])
    stack.block_compaction = compaction
    return stack


def _pruned_draw(rng, active, n_blocks=24, n_groups=3, quota=32):
    quotas = np.zeros(n_blocks, dtype=np.int64)
    quotas[np.asarray(active)] = quota
    vals = rng.normal(MU, SIGMA, len(active) * quota)
    return vals, rng.integers(0, n_groups, vals.size), quotas


def _state(stack):
    out = [t.numpy().copy() for t in stack._state]
    if stack._regs_state is not None:
        out.append(stack._regs_state.numpy().copy())
    return out


@pytest.mark.parametrize("sketch", [False, True], ids=["moments", "sketch"])
def test_compacted_launch_bit_identical_f64(sketch, x64):
    """The compacted dense launch reproduces the full-axis launch bit for
    bit on the resident float64 state (register plane included), and both
    sit within 1e-12 of the reference's compacted float64 dense tick."""
    outs = []
    for compaction in (True, False):
        r = np.random.default_rng(5)
        stack = _zone_stack(TC, TDev, TStack, compaction, sketch,
                            dtype=F64, device="cpu")
        for active in ([3, 17], [3, 17], [5]):
            vals, gids, quotas = _pruned_draw(r, active)
            out = stack.tick(PARAMS, values=vals, quotas=quotas,
                             dense=([None, gids], [None, None]))
        assert bool(stack._active_cache) is compaction  # engaged
        outs.append((_state(stack), [p.numpy().copy() for p, _ in out]))
    for a, b in zip(outs[0][0] + outs[0][1], outs[1][0] + outs[1][1]):
        assert np.array_equal(a, b)
    r = np.random.default_rng(5)
    ref = _zone_stack(RC, RDev, RStack, True, sketch)
    for active in ([3, 17], [3, 17], [5]):
        vals, gids, quotas = _pruned_draw(r, active)
        ref_out = ref.tick(RC.IslaParams(), values=vals, quotas=quotas,
                           dense=([None, gids], [None, None]))
    assert ref._state[0].dtype == np.float64 and ref._active_cache
    for got, want in zip(outs[0][0], ref._state):
        if got.dtype == np.uint8:
            assert np.array_equal(got, np.asarray(want))
        else:
            _close(got, want, "state against the reference")
    for got, (want, _) in zip(outs[0][1], ref_out):
        _close(got, want, "partials against the reference")


def test_pruned_cells_stay_resident_and_reactivate_warm_f64(rng):
    """Pruned cells keep their float64 rows untouched through compacted
    ticks and re-activate warm: drawing block 5 after rounds that never
    touched it merges onto its ORIGINAL state, bit for bit as the
    never-compacted stack does."""
    stack = _zone_stack(TC, TDev, TStack, True, dtype=F64, device="cpu")
    full = _zone_stack(TC, TDev, TStack, False, dtype=F64, device="cpu")
    draws = [_pruned_draw(np.random.default_rng(1), [5])]
    draws += [_pruned_draw(rng, [3, 17]) for _ in range(3)]
    draws += [_pruned_draw(rng, [5])]
    for st in (stack, full):
        for i, (vals, gids, quotas) in enumerate(draws):
            st.tick(PARAMS, values=vals, quotas=quotas,
                    dense=([None, gids], [None, None]))
            if i == 0 and st is stack:
                baseline5 = _state(stack)
            if i == 3 and st is stack:
                mom, ns = _state(stack)[0], _state(stack)[3]
                for k, s_ in enumerate(stack.stores):
                    cells = (int(stack.offsets[k])
                             + np.arange(s_.n_groups) * 24 + 5)
                    assert np.array_equal(mom[cells], baseline5[0][cells])
                assert (ns.reshape(2, 24)[:, 5]
                        == baseline5[3].reshape(2, 24)[:, 5]).all()
    assert stack._active_cache and not full._active_cache
    for a, b in zip(_state(stack), _state(full)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Against the host fold, the port's tagged tick and the reference's dense
# tick (the mesh cases' three keys: GROUP BY, WHERE, both).
# ---------------------------------------------------------------------------


def _stores(C, Dev, hetero=False, sketch=(), **kw):
    return MC.make_stores(Dev.fresh_device, C.Boundaries, hetero=hetero,
                          sketch=sketch, **kw)


def _host_fold(stores, draws):
    """Each key's host ``MomentStore`` (the port's copy of the host layer)
    after the same draws: the carry fold of its shifted, masked slice."""
    hosts = [st.to_host() for st in stores]
    for d in draws:
        for h, st, (g, where) in zip(hosts, stores, MC.KEYS):
            mask = d["mask"] if where else None
            h.ingest(d["vals"] + st.shift, d["bids"], d["quotas"],
                     group_ids=d["gids"] if g > 1 else None, mask=mask,
                     raw_values=d["vals"])
    return hosts


@pytest.mark.parametrize("sketch", [(), (0, 2)], ids=["moments", "sketch"])
@pytest.mark.parametrize("hetero", [False, True], ids=["uniform", "hetero"])
def test_dense64_matches_host_tagged_and_reference(hetero, sketch, x64):
    """Three drawing ticks, then a zero-draw re-solve in another mode:
    every key's float64 moment rows, totals and partials within 1e-12 of
    the port's float64 tagged tick and of the reference's float64 dense
    tick on the same draws, and its state and calibrated partials within
    1e-12 of the host carry fold and its solve; draw ledgers and register
    planes equal to the host's bit for bit.  (The faithful re-solve is
    held to the device ticks only: the device's branchless faithful
    Phase 2 parts from the host's solve on the tagged tick too.)"""
    rng = np.random.default_rng(11)
    draws = [MC.draw(rng) for _ in range(3)]
    dense_st = _stores(TC, TDev, hetero, sketch, dtype=F64, device="cpu")
    tag_st = _stores(TC, TDev, hetero, sketch, dtype=F64, device="cpu")
    hosts = _host_fold(_stores(TC, TDev, hetero, sketch, dtype=F64,
                               device="cpu"), draws)
    ref_st = _stores(RC, RDev, hetero, sketch)
    dense, tag, ref = TStack(dense_st), TStack(tag_st), RStack(ref_st)
    limbs = TSK.value_limbs if sketch else None
    assert ref_st[0].dtype == np.float64

    def agree(ref_outs, host_mode=None):
        for k, (d_st, t_st, r_st) in enumerate(zip(dense_st, tag_st,
                                                   ref_st)):
            p = d_st.partials_host()
            _close(p, t_st.partials_host(), f"key {k} partials vs tagged")
            _close(p, np.asarray(ref_outs[k][0]) * r_st.scale,
                   f"key {k} partials vs reference")
            if host_mode is not None:
                _close(p, hosts[k].solve(PARAMS, mode=host_mode).avg,
                       f"key {k} partials vs the host solve")

    for d in draws:
        dense.tick(PARAMS, **MC.dense_payload(d))
        tag.tick(PARAMS, **MC.tagged_payload(tag, tag_st, d, limbs=limbs))
        ref_outs = ref.tick(RC.IslaParams(), **MC.dense_payload(d))
    agree(ref_outs, host_mode="calibrated")
    for k, (d_st, t_st, h, r_st) in enumerate(zip(dense_st, tag_st, hosts,
                                                  ref_st)):
        got, tagged = d_st.to_host(), t_st.to_host()
        for f in ("mom_s", "mom_l", "totals"):
            for want, who in ((getattr(h, f), "host"),
                              (getattr(tagged, f), "tagged"),
                              (np.asarray(getattr(r_st, f)), "reference")):
                _close(getattr(got, f), want, f"key {k} {f} vs {who}")
        assert np.array_equal(got.n_sampled, h.n_sampled)
        if d_st.has_sketch:
            assert np.array_equal(got.regs, h.regs)
            assert np.array_equal(d_st.group_registers(),
                                  h.group_registers())
    dense.tick(PARAMS, mode="faithful")
    tag.tick(PARAMS, mode="faithful")
    agree(ref.tick(RC.IslaParams(), mode="faithful"))


# ---------------------------------------------------------------------------
# The mesh route.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sketch", [(), (2,)], ids=["moments", "sketch"])
@pytest.mark.parametrize("compaction", [True, False],
                         ids=["compacted", "full"])
@pytest.mark.parametrize("n_shards", MC.SHARDS)
def test_mesh_dense64_matches_device_stack(n_shards, compaction, sketch):
    """``MeshDeviceStack`` on S CPU shards against ``DeviceStack``, both
    ticking the float64 dense payload: state, ledgers, register planes
    and partials bit for bit, the reduced stat rows within 1e-12 (summed
    in shard order), full ticks and zone-pruned ones (compacted, each
    shard its own active run) alike."""
    rng = np.random.default_rng(2)
    single_st = _stores(TC, TDev, sketch=sketch, dtype=F64, device="cpu")
    mesh_st = _stores(TC, TDev, sketch=sketch, dtype=F64, device="cpu")
    single = TStack(single_st)
    msh = TMesh(mesh_st, make_cell_mesh(devices=["cpu"] * n_shards))
    single.block_compaction = msh.block_compaction = compaction
    quotas = [None, [0, 6, 0, 0, 0, 0, 0, 5, 0, 0], None,
              [4, 0, 0, 0, 0, 0, 0, 0, 0, 7]]
    for q in quotas:
        d = MC.draw(rng, q)
        out_s = single.tick(PARAMS, **MC.dense_payload(d))
        out_m = msh.tick(PARAMS, **MC.dense_payload(d))
        for a, b in zip(single_st, mesh_st):
            for f in ("mom_s", "mom_l", "totals", "_n_sampled_dev"):
                assert torch.equal(getattr(b, f), getattr(a, f)), f
            assert np.array_equal(b.n_sampled, a.n_sampled)
            if a.has_sketch:
                assert torch.equal(b.regs, a.regs)
                assert np.array_equal(b.group_registers(),
                                      a.group_registers())
        for (ps, rs), (pm, rm) in zip(out_s, out_m):
            assert np.array_equal(np.asarray(pm), ps.numpy())
            np.testing.assert_allclose(rm, rs, rtol=REL, atol=0)
    assert bool(msh._active_cache) is compaction
    assert bool(single._active_cache) is compaction


# ---------------------------------------------------------------------------
# The single-store convenience tick.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sketch", [False, True], ids=["moments", "sketch"])
def test_ingest_tick_dense_f64(sketch, rng):
    """``ingest_tick(layout="dense")`` on a float64 store folds the
    un-shifted stream in float64 (its state within 1e-12 of the tagged
    layout's, registers equal); ``layout="auto"`` keeps choosing the
    tagged tick for a float64 store, bit for bit the tagged layout's."""
    b = TC.make_boundaries(MU, SIGMA, PARAMS)
    quotas = np.array([5, 0, 7, 3])
    bids = np.repeat(np.arange(4), quotas)
    stores = {lay: TDev.fresh_device(4, b, MU, [10 ** 6] * 4, shift=2.5,
                                     n_groups=2, dtype=F64, device="cpu",
                                     has_sketch=sketch)
              for lay in ("dense", "tagged", "auto")}
    for _ in range(2):
        vals = rng.normal(MU, SIGMA, bids.size) + 2.5
        gids = rng.integers(0, 2, bids.size)
        mask = rng.random(bids.size) < 0.7
        for lay, st in stores.items():
            st.ingest_tick(vals, bids, quotas, PARAMS, group_ids=gids,
                           mask=mask, layout=lay)
    dense, tagged, auto = (stores[k].to_host()
                           for k in ("dense", "tagged", "auto"))
    for f in ("mom_s", "mom_l", "totals"):
        _close(getattr(dense, f), getattr(tagged, f), f)
        assert np.array_equal(getattr(auto, f), getattr(tagged, f))
    _close(stores["dense"].partials_host(), stores["tagged"].partials_host(),
           "partials")
    assert np.array_equal(dense.n_sampled, tagged.n_sampled)
    if sketch:
        assert np.array_equal(dense.regs, tagged.regs)
