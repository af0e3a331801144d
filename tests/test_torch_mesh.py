"""The mesh route on the CPU: ``MeshDeviceStack`` at S = 1 to 4 shards
(``make_cell_mesh(devices=["cpu"] * S)``) against the port's
``DeviceStack``, the executor's ``route="mesh"`` against
``route="device"``, and the JAX package's ``MeshDeviceStack`` on the same
seeded inputs: at S = 1 in this process, at S = 4 in a subprocess that
forces four host devices.

Each test mirrors its counterpart in ``tests/test_mesh_stack.py``.
Tolerances: float64 resident state, draw ledgers, per-cell partials and
register planes bit for bit (``np.array_equal``), the reduced stat rows
within 1e-12 relative (the shards' rows are summed in shard order, the
one thing that differs from one device); fp32 partials and rows within
1e-5 relative; folded register rows bit for bit.  Against the JAX
package the partials are held within one ulp (see there).  The run-table
fault repair is tested here too, on ``DeviceStack`` and on the mesh.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.core as TC
from repro_torch.core import distributed as TD
from repro_torch.core import sketch as TSK
from repro_torch.core.moment_store import DeviceMomentStore as TDev
from repro_torch.core.moment_store import DeviceStack as TStack
from repro_torch.core.moment_store import MeshDeviceStack as TMesh
from repro_torch.launch.mesh import CellMesh, make_cell_mesh, mesh_devices
from repro_torch.sharding.specs import ISLA_CELL_AXIS, isla_cell_specs
from _torch_mesh_cases import (B, KEYS, SHARDS, WRONG_TABLES,
                               dense_payload, draw, make_stores, spoil,
                               tagged_payload)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PARAMS = TC.IslaParams()
F64, F32 = torch.float64, torch.float32
DTYPES = pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
PER_SHARDS = pytest.mark.parametrize("n_shards", SHARDS)


def _mesh(n_shards):
    return make_cell_mesh(devices=["cpu"] * n_shards)


def _stores(dtype, **kw):
    return make_stores(TDev.fresh_device, TC.Boundaries, dtype=dtype,
                       device="cpu", **kw)


def _pair(n_shards, dtype, **kw):
    """(DeviceStack, MeshDeviceStack, their stores) over two fresh, equal
    sets of the cases' three stores."""
    single, meshed = _stores(dtype, **kw), _stores(dtype, **kw)
    return (TStack(single), TMesh(meshed, _mesh(n_shards)), single,
            meshed)


def _tagged(stack, stores, d, **kw):
    limbs = TSK.value_limbs if stack.has_sketch else None
    return tagged_payload(stack, stores, d, limbs=limbs, **kw)


def _tick_both(single, msh, s_st, m_st, d, payload="tagged", shuffle=None,
               drop=False, **tick_kw):
    """The same pass through both stacks, each placed by its own
    ``key_seg``; a shuffled tagged pass is permuted alike; with ``drop``
    every seventh sample carries the stack's drop segment (``n_cells``,
    ``n_cells_mesh``) inside its run."""
    outs = []
    for stack, stores in ((single, s_st), (msh, m_st)):
        if payload == "dense":
            kw = dense_payload(d)
        else:
            kw = _tagged(stack, stores, d, shuffle=None if shuffle is None
                         else np.random.default_rng(shuffle))
        if drop:
            kw["seg"][::7] = getattr(stack, "n_cells_mesh", stack.n_cells)
        outs.append(stack.tick(PARAMS, **kw, **tick_kw))
    return outs


def _state(st):
    out = [st.mom_s, st.mom_l, st.totals, st._n_sampled_dev]
    if st.has_sketch:
        out.append(st.regs)
    return [t.numpy().copy() for t in out]


def _assert_stacks_agree(out_s, out_m, s_st, m_st, dtype):
    """State and partials of every store, and its rows: float64 bit for
    bit (rows 1e-12), fp32 within 1e-5."""
    exact = dtype == F64
    for a, b in zip(s_st, m_st):
        for x, y in zip(_state(a), _state(b)):
            if exact or x.dtype == np.uint8:
                assert np.array_equal(y, x)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-5)
        assert np.array_equal(b.n_sampled, a.n_sampled)
        if a.has_sketch:
            assert np.array_equal(b.group_registers(), a.group_registers())
    for (ps, rs), (pm, rm) in zip(out_s, out_m):
        if exact:
            assert np.array_equal(np.asarray(pm), ps.numpy())
            np.testing.assert_allclose(rm, rs, rtol=1e-12, atol=0)
        else:
            np.testing.assert_allclose(np.asarray(pm), ps.numpy(),
                                       rtol=1e-5)
            np.testing.assert_allclose(rm, rs, rtol=1e-5)


# ---------------------------------------------------------------------------
# The mesh and its placement table.
# ---------------------------------------------------------------------------


def test_make_cell_mesh_takes_devices_and_never_drops_to_the_cpu(
        monkeypatch):
    """``devices=`` gives a shard a device; without a card a default mesh
    raises, and a mesh never names a card that is not there."""
    mesh = make_cell_mesh(devices=["cpu"] * 3)
    assert isinstance(mesh, CellMesh) and mesh_devices(mesh) == 3
    assert mesh.axis_names == (ISLA_CELL_AXIS,)
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="n_shards"):
        make_cell_mesh(2, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_cell_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_cell_mesh(devices=["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no CUDA device 3"):
        make_cell_mesh(devices=["cuda:3"])
    with pytest.raises(ValueError, match="2 shards"):
        make_cell_mesh(2)


@PER_SHARDS
def test_isla_cell_specs_match_stack_placement(n_shards, rng):
    """``isla_cell_specs`` is the stack's placement: split operands are a
    tensor a shard on that shard's device, of 1/S of the rows; whole ones
    are every shard's full copy; the reduced stat rows come back whole."""
    _, msh, _, m_st = _pair(n_shards, F64, hetero=True, sketch=(0,))
    spec = isla_cell_specs(msh.mesh)
    assert TD.cell_axis(msh.mesh) == ISLA_CELL_AXIS
    assert spec["cells"].split and spec["cell_rows"].split
    assert spec["active_cells"].split
    assert not spec["replicated"].split and not spec["stat_rows"].split
    S, L = n_shards, msh.cells_local
    assert msh.n_cells_mesh == S * L and msh.blocks_local == -(-B // S)

    def placed(parts, rows):
        return (len(parts) == S and all(
            p.device == d and p.shape[0] == rows
            for p, d in zip(parts, msh.mesh.devices)))

    for i in range(3):
        assert placed([sh[i] for sh in msh._state], L)
    assert placed(msh._regs_state, L)
    for vec in ([sh[3] for sh in msh._state], msh._sizes):
        assert placed(vec, len(KEYS) * msh.blocks_local)
    assert placed(msh._sk_cells, L) and placed(msh._inv_scale, L)
    assert placed(msh._bounds, L + 1)  # per-cell cuts + the drop row
    assert placed(msh._bound_rows, msh._bound_rows[0].shape[0])
    assert all(torch.equal(p, msh._bound_rows[0]) for p in msh._bound_rows)
    out = msh.tick(PARAMS, **_tagged(msh, m_st, draw(rng)))
    assert [rows.shape for _, rows in out] == [(g, 9) for g, _ in KEYS]


# ---------------------------------------------------------------------------
# Tick parity: DeviceStack against MeshDeviceStack.
# ---------------------------------------------------------------------------


@PER_SHARDS
@DTYPES
@pytest.mark.parametrize("table", ["runs", "shuffled", "drop"])
def test_mesh_tagged_tick_matches_device_stack(n_shards, dtype, table, rng):
    """Two tagged ticks (the second warm on the resident shards): every
    store's state and partials the single-device stack's (float64 bit for
    bit), by the run table (each shard its own slices and table), with
    drop-segment samples inside the runs, or shuffled (a stable partition
    by shard)."""
    single, msh, s_st, m_st = _pair(n_shards, dtype)
    for t in range(2):
        outs = _tick_both(single, msh, s_st, m_st, draw(rng),
                          shuffle=t if table == "shuffled" else None,
                          drop=table == "drop")
        _assert_stacks_agree(*outs, s_st, m_st, dtype)


@PER_SHARDS
def test_mesh_dense_tick_matches_device_stack(n_shards, rng):
    """The fp32 dense tick: the block-major panes split by block run, each
    shard folding its own rows with ``_dense_core`` verbatim."""
    single, msh, s_st, m_st = _pair(n_shards, F32)
    for _ in range(2):
        outs = _tick_both(single, msh, s_st, m_st, draw(rng),
                          payload="dense")
        _assert_stacks_agree(*outs, s_st, m_st, F32)


@PER_SHARDS
@DTYPES
def test_mesh_zero_draw_solve_matches_device_stack(n_shards, dtype, rng):
    """A zero-draw re-solve in another mode runs ``mesh_solve`` on the
    resident shards and matches ``fused_solve``; repeating it serves the
    cache with no reduce at all."""
    single, msh, s_st, m_st = _pair(n_shards, dtype)
    payload = "tagged" if dtype == F64 else "dense"
    _tick_both(single, msh, s_st, m_st, draw(rng), payload=payload)
    outs = [stack.tick(PARAMS, mode="faithful") for stack in (single, msh)]
    _assert_stacks_agree(*outs, s_st, m_st, dtype)
    with TD.collective_footprint() as rec:
        again = msh.tick(PARAMS, mode="faithful")
    assert rec == [] and again[0][0] is outs[1][0][0]


@PER_SHARDS
@pytest.mark.parametrize("payload,dtype", [("tagged", F64), ("tagged", F32),
                                           ("dense", F32)],
                         ids=["tagged-f64", "tagged-f32", "dense-f32"])
def test_mesh_hetero_anchor_tick_matches_device_stack(n_shards, payload,
                                                      dtype, rng):
    """Per-key anchors (a per-cell cuts table split with the cells, each
    shard's own +inf drop row; the dense keys' affines) agree with the
    single-device hetero stack."""
    single, msh, s_st, m_st = _pair(n_shards, dtype, hetero=True)
    assert not msh._uniform
    for _ in range(2):
        outs = _tick_both(single, msh, s_st, m_st, draw(rng),
                          payload=payload)
        _assert_stacks_agree(*outs, s_st, m_st, dtype)


@PER_SHARDS
def test_mesh_pruned_compacted_tick_matches_device_stack(n_shards, rng):
    """Zone-pruned quotas: each shard compacts its own active blocks to
    one shared bucketed width and maps them back by its local targets;
    across active sets that change, the mesh matches the single-device
    stack's full launch, and pruned cells keep their rows."""
    single, msh, s_st, m_st = _pair(n_shards, F32)
    single.block_compaction = False  # the uncompacted reference
    for active in ([3, 8], [3, 8], [1, 2, 7]):
        quotas = np.zeros(B, dtype=np.int64)
        quotas[active] = 24
        outs = _tick_both(single, msh, s_st, m_st, draw(rng, quotas),
                          payload="dense")
        _assert_stacks_agree(*outs, s_st, m_st, F32)
    assert msh._active_cache, "the mesh's compaction should have engaged"
    assert not single._active_cache


@PER_SHARDS
@pytest.mark.parametrize("payload,dtype", [("tagged", F64),
                                           ("dense", F32)],
                         ids=["tagged-f64", "dense-f32"])
def test_mesh_sketch_stack_matches_device_stack(n_shards, payload, dtype,
                                                rng):
    """A sketch stack (one key with COUNT DISTINCT; the others ride inert
    register rows): every shard merges its own register rows, and the
    register planes and the folded rows (max-reduced across shards) are
    the single-device stack's bit for bit, ticking and re-solving."""
    single, msh, s_st, m_st = _pair(n_shards, dtype, sketch=(2,))
    assert msh.has_sketch
    for _ in range(2):
        outs = _tick_both(single, msh, s_st, m_st, draw(rng),
                          payload=payload)
        _assert_stacks_agree(*outs, s_st, m_st, dtype)
    outs = [stack.tick(PARAMS, mode="faithful") for stack in (single, msh)]
    _assert_stacks_agree(*outs, s_st, m_st, dtype)


@PER_SHARDS
def test_mesh_release_round_trip(n_shards, rng):
    """``release`` gathers every store's rows back from EVERY shard: the
    released stores equal their single-device twins bit for bit (float64),
    ledgers and register planes included, and the stack then refuses to
    tick."""
    single, msh, s_st, m_st = _pair(n_shards, F64, sketch=(0, 2))
    _tick_both(single, msh, s_st, m_st, draw(rng))
    msh.release()
    assert msh._released and all(st._owner is None for st in m_st)
    for a, b in zip(s_st, m_st):
        for x, y in zip(_state(a), _state(b)):
            assert np.array_equal(y, x)
    with pytest.raises(ValueError, match="released"):
        msh.tick(PARAMS)


# ---------------------------------------------------------------------------
# The collective audit.
# ---------------------------------------------------------------------------


@PER_SHARDS
@pytest.mark.parametrize("sketch", [False, True], ids=["moments", "sketch"])
def test_mesh_tick_collectives_are_stat_rows_only(n_shards, sketch, rng,
                                                  monkeypatch):
    """Each tick's only cross-device step is one sum of the O(groups) stat
    rows (n_rows x 9 elements), plus on a sketch stack one max of the
    folded register rows (n_rows x 4096 bytes): nothing of O(cells).  A
    steady tick's uploads are sample-sized, never state."""
    _, msh, _, m_st = _pair(n_shards, F64, sketch=(1,) if sketch else ())
    n_rows = msh.n_rows
    want = [("sum", n_rows * 9)] + ([("max", n_rows * TSK.M)]
                                    if sketch else [])
    msh.tick(PARAMS, **_tagged(msh, m_st, draw(rng)))
    uploads = []
    real = TD.h2d

    def h2d(*args, **kwargs):
        uploads.append(np.asarray(args[0]).size)
        return real(*args, **kwargs)

    monkeypatch.setattr(TD, "h2d", h2d)
    calls0 = TD.mesh_all_reduce.calls
    kw = _tagged(msh, m_st, draw(rng))
    for tick in (lambda: msh.tick(PARAMS, **kw),
                 lambda: msh.tick(PARAMS, mode="faithful")):
        with TD.collective_footprint() as rec:
            tick()
        assert rec == want
    assert TD.mesh_all_reduce.calls - calls0 == 2 * len(want)
    assert n_rows * 9 < msh.n_cells_mesh * 11  # rows, not cell state
    assert uploads and max(uploads) <= kw["values"].size


# ---------------------------------------------------------------------------
# The run-table fault: no valid stats after the raise, and the next tick
# raises too.
# ---------------------------------------------------------------------------


def _fault_pair(kind, dtype=F64):
    stores = _stores(dtype)
    stack = (TStack(stores) if kind == "device"
             else TMesh(stores, _mesh(int(kind[-1]))))
    return stack, stores


def _assert_unusable(stack, stores, d):
    assert all(not st._stats_valid and st._rows is None for st in stores)
    assert stack._released
    for tick in (lambda: stack.tick(PARAMS),
                 lambda: stack.tick(PARAMS, mode="faithful"),
                 lambda: stack.tick(PARAMS, **_tagged(stack, stores, d))):
        with pytest.raises(ValueError, match="unusable"):
            tick()


@pytest.mark.parametrize("kind", ["device", "mesh1", "mesh3"])
def test_run_table_fault_leaves_no_valid_stats(kind, rng, monkeypatch):
    """A fold that folds and then sets the run count, as the card does (the
    plain version raises first): the tick raises after its readback, no
    store keeps valid stats, and the next tick raises, zero-draw ticks
    included."""
    stack, stores = _fault_pair(kind)
    stack.tick(PARAMS, **_tagged(stack, stores, draw(rng)))
    assert all(st._stats_valid for st in stores)
    real = TD.isla_tagged_fold

    def card_like(values, seg, bounds, out_s, out_l, out_t, runs=None):
        real(values, seg, bounds, out_s, out_l, out_t)  # folds everything
        runs.table[-1] = 1  # ... and counts a run out of place

    monkeypatch.setattr(TD, "isla_tagged_fold", card_like)
    with pytest.raises(ValueError, match="run table"):
        stack.tick(PARAMS, **_tagged(stack, stores, draw(rng)))
    monkeypatch.setattr(TD, "isla_tagged_fold", real)
    _assert_unusable(stack, stores, draw(rng))


@pytest.mark.parametrize("kind", ["device", "mesh3"])
@pytest.mark.parametrize("table", WRONG_TABLES)
def test_wrong_run_table_leaves_the_stack_unusable(kind, table, rng):
    """Each wrong table raises — the plain fold's check, or the mesh's
    host checks before any shard folds — and leaves the stack as a
    card-side fault does: no valid stats, every next tick raising."""
    stack, stores = _fault_pair(kind)
    stack.tick(PARAMS, **_tagged(stack, stores, draw(rng)))
    with pytest.raises(ValueError, match="run table"):
        stack.tick(PARAMS, **spoil(table, _tagged(stack, stores,
                                                  draw(rng))))
    _assert_unusable(stack, stores, draw(rng))


# ---------------------------------------------------------------------------
# The executor's mesh route.
# ---------------------------------------------------------------------------


def _region_executor(seed, mesh=None, n_blocks=B, rows=400):
    rng = np.random.default_rng(seed)
    blocks = [{"value": rng.lognormal(1.0, 0.8, rows),
               "region": rng.integers(0, 4, rows)}
              for _ in range(n_blocks)]

    def sampler(blk):
        def draw_rows(n, rng2):
            idx = rng2.integers(0, rows, n)
            return {"value": blk["value"][idx],
                    "region": blk["region"][idx]}
        return draw_rows

    return TC.MultiQueryExecutor([sampler(b) for b in blocks],
                                 [rows] * n_blocks,
                                 group_domains={"region": 4}, device="cpu",
                                 mesh=mesh)


_REGION_QUERIES = [TC.IslaQuery(agg="AVG"),
                   TC.IslaQuery(agg="AVG", group_by="region"),
                   TC.IslaQuery(agg="SUM",
                                where=TC.Predicate(column="region", eq=1)),
                   TC.IslaQuery(agg="VAR"),
                   TC.IslaQuery(agg="count_distinct", group_by="region")]


@pytest.fixture
def default_dtype(request):
    was = torch.get_default_dtype()
    torch.set_default_dtype(request.param)
    yield request.param
    torch.set_default_dtype(was)


@PER_SHARDS
@pytest.mark.parametrize("default_dtype", [F64, F32], ids=["f64", "f32"],
                         indirect=True)
def test_executor_route_mesh_matches_device(n_shards, default_dtype):
    """End to end over two incremental runs (the same RNG stream; the warm
    run draws 0 on both routes): ``route="mesh"`` answers as
    ``route="device"`` within 1e-4, COUNT DISTINCT equal; in float64 every
    key's state is the device route's bit for bit."""
    outs, exs = {}, {}
    for route in ("device", "mesh"):
        ex = _region_executor(7, mesh=["cpu"] * n_shards)
        rng = np.random.default_rng(11)
        runs = [ex.run(_REGION_QUERIES, rng, route=route, incremental=True)
                for _ in range(2)]
        assert all(a.new_samples == 0 for a in runs[1])
        outs[route], exs[route] = runs, ex
    stack = next(iter(exs["mesh"]._device_stacks.values()))
    assert isinstance(stack, TMesh) and stack.n_shards == n_shards
    for dev_run, msh_run in zip(outs["device"], outs["mesh"]):
        for dev, msh in zip(dev_run, msh_run):
            assert np.isclose(msh.value, dev.value, rtol=1e-4)
            if dev.groups is not None:
                np.testing.assert_allclose([g.value for g in msh.groups],
                                           [g.value for g in dev.groups],
                                           rtol=1e-4)
        assert msh_run[-1].value == dev_run[-1].value  # COUNT DISTINCT
    if default_dtype == F64:
        for skey, dst in exs["device"]._device_stores.items():
            mst = exs["mesh"]._device_stores[skey]
            for x, y in zip(_state(dst), _state(mst)):
                assert np.array_equal(y, x)


@PER_SHARDS
def test_mesh_per_key_reset_is_shard_aware(n_shards):
    """Dropping ONE key's warm state on the mesh route releases its stack
    through ``MeshDeviceStack.release``: the surviving keys get their rows
    back from EVERY shard unchanged, and the next run rebuilds the stack,
    re-draws only for the dropped key and answers consistently (over the
    reference test's 40 blocks)."""
    ex = _region_executor(7, mesh=["cpu"] * n_shards, n_blocks=40)
    rng = np.random.default_rng(11)
    for _ in range(2):  # the second run converges: survivors fully warm
        pre = ex.run(_REGION_QUERIES[:4], rng, route="mesh",
                     incremental=True)
    keys = list(ex._device_stores)
    grouped = next(k for k in keys if k.group_by == "region")
    survivors = [k for k in keys if k is not grouped]
    snap = {k: [t.copy() for t in _state(ex._device_stores[k])]
            for k in survivors}
    ex._drop_key_state(grouped)
    assert grouped not in ex._device_stores
    for k in survivors:
        st = ex._device_stores[k]
        assert st._owner is None
        for x, y in zip(snap[k], _state(st)):
            assert np.array_equal(y, x)
    answers = ex.run(_REGION_QUERIES[:4], rng, route="mesh",
                     incremental=True)
    assert answers[1].new_samples > 0  # the dropped key re-accumulates
    np.testing.assert_allclose([g.value for g in answers[1].groups],
                               [g.value for g in pre[1].groups], rtol=0.05)
    for i in (0, 3):
        assert np.isclose(answers[i].value, pre[i].value, rtol=0.05)


# ---------------------------------------------------------------------------
# Against the JAX package's MeshDeviceStack.
# ---------------------------------------------------------------------------

REF_SEED = 29
REF_TICKS = 2
REF_SKETCH = (2,)

# The reference side of the parity check at S shards: its MeshDeviceStack
# in float64 on S host devices, ticked on the cases' seeded streams; it
# saves every tick's ids, partials and rows, then every store's state.
_REF_RUN = r"""
import sys
import numpy as np
sys.path.insert(0, {tests!r})
import jax
from repro.core import sketch
from repro.core.moment_store import DeviceMomentStore, MeshDeviceStack
from repro.core.types import Boundaries, IslaParams
from repro.launch.mesh import make_cell_mesh
from _torch_mesh_cases import draw, make_stores, tagged_payload

jax.config.update("jax_enable_x64", True)
assert jax.device_count() >= {n_shards}, jax.device_count()
stores = make_stores(DeviceMomentStore.fresh_device, Boundaries,
                     hetero=True, sketch={sketch!r})
msh = MeshDeviceStack(stores, make_cell_mesh({n_shards}))
rng = np.random.default_rng({seed})
out = {{}}
for t in range({ticks}):
    kw = tagged_payload(msh, stores, draw(rng), limbs=sketch.value_limbs,
                        runs=False)
    out["seg%d" % t] = kw["seg"]
    for k, (p, r) in enumerate(msh.tick(IslaParams(), **kw)):
        out["partials%d_%d" % (t, k)] = np.asarray(p)
        out["rows%d_%d" % (t, k)] = np.asarray(r)
for k, st in enumerate(stores):
    for f in ("mom_s", "mom_l", "totals", "_n_sampled_dev"):
        out["%s_%d" % (f, k)] = np.asarray(getattr(st, f))
    if st.has_sketch:
        out["regs_%d" % k] = np.asarray(st.regs)
np.savez({path!r}, **out)
"""


def _reference_run(n_shards, path, env=None):
    code = _REF_RUN.format(tests=str(ROOT / "tests"), n_shards=n_shards,
                           sketch=REF_SKETCH, seed=REF_SEED,
                           ticks=REF_TICKS, path=str(path))
    if env is None:
        exec(compile(code, "<reference mesh run>", "exec"), {})
    else:
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


def _assert_matches_reference(ref, n_shards):
    stores = _stores(F64, hetero=True, sketch=REF_SKETCH)
    msh = TMesh(stores, _mesh(n_shards))
    rng = np.random.default_rng(REF_SEED)
    for t in range(REF_TICKS):
        kw = _tagged(msh, stores, draw(rng))
        assert np.array_equal(kw["seg"], ref[f"seg{t}"])
        for k, (p, r) in enumerate(msh.tick(PARAMS, **kw)):
            want = ref[f"partials{t}_{k}"]
            gap = np.abs(np.asarray(p) - want) / np.spacing(np.abs(want))
            assert gap.max() <= 1.0, (t, k, gap.max())
            np.testing.assert_allclose(r, ref[f"rows{t}_{k}"], rtol=1e-12,
                                       atol=0)
    for k, st in enumerate(stores):
        for f, got in zip(("mom_s", "mom_l", "totals", "_n_sampled_dev",
                           "regs"), _state(st)):
            assert np.array_equal(got, ref[f"{f}_{k}"]), (k, f)


@pytest.fixture
def jax_x64():
    import jax

    was = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", was)


def test_mesh_matches_reference_mesh_one_shard(jax_x64, tmp_path):
    """At S = 1 in this process: ids, float64 state, draw ledgers and
    register planes equal the JAX package's ``MeshDeviceStack``'s bit for
    bit, rows within 1e-12, partials within one ulp.  (The reference's
    jitted tick fuses Phase 2, and in some cells its answer parts by an
    ulp from its own unfused ``phase2`` over the same state, whose bits
    the port's partials are.)"""
    _assert_matches_reference(_reference_run(1, tmp_path / "ref1.npz"), 1)


@pytest.fixture(scope="module")
def reference_four_shards(tmp_path_factory):
    """The reference's four-shard run, once for the module, in a
    subprocess that forces four host devices and x64 before jax
    imports."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return _reference_run(4, tmp_path_factory.mktemp("ref") / "ref4.npz",
                          env)


def test_mesh_matches_reference_mesh_four_shards(reference_four_shards):
    """At S = 4 (pad blocks: B = 10): the same, against the reference's
    four-shard mesh run in its own process."""
    _assert_matches_reference(reference_four_shards, 4)
