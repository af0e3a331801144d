"""The port's kernel wrappers (their plain PyTorch versions on the CPU)
against the reference's Pallas kernels run in interpret mode, and the
dense fold against the reference's ``fused_tick_dense``.

Inputs are made from a seed with numpy and cross between JAX and torch as
numpy arrays.  Tolerances are the reference's own: rtol 1e-5 for fp32,
5e-3 for bf16 (``tests/test_kernels.py``).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import distributed as RD
from repro.core.types import IslaParams as RParams
from repro.kernels import ops as rops
from repro.kernels.isla_moments import (isla_fused_pallas,
                                        isla_moments_batched_pallas,
                                        isla_moments_grouped_pallas,
                                        isla_moments_pallas,
                                        pilot_stats_pallas)
from repro_torch.core import distributed as TD
from repro_torch.core.types import IslaParams as TParams
from repro_torch.kernels import isla_moments as K
from repro_torch.kernels import ops as tops

BOUNDS = (60.0, 90.0, 110.0, 140.0)
TM = 64


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float64)


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("per_cell", [False, True])
def test_batched_matches_pallas(stride, per_cell, rng):
    """Row 1: strided tile reads, prior seed, shared or per-cell cuts."""
    n = 3
    x = rng.normal(100, 20, size=(n, TM * 8, 128)).astype(np.float32)
    prior = rng.uniform(0, 10, size=(n, 2, 4)).astype(np.float32)
    bounds = (np.asarray(BOUNDS, np.float32) if not per_cell else
              (np.asarray(BOUNDS, np.float32)[None]
               + rng.uniform(-5, 5, size=(n, 1))).astype(np.float32))
    want = isla_moments_batched_pallas(
        jnp.asarray(x), jnp.asarray(bounds), tm=TM, stride=stride,
        interpret=True, prior=jnp.asarray(prior))
    got = K.isla_moments_batched(_t(x), _t(bounds), tm=TM, stride=stride,
                                 prior=_t(prior))
    assert got.shape == (n, 2, 4)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
def test_one_cell_matches_pallas(dtype, stride, rng):
    """Row 2: the one-cell call, fp32 and bf16 input, with a prior."""
    x = rng.normal(100, 20, size=(TM * 4, 128)).astype(np.float32)
    prior = rng.uniform(0, 10, size=(2, 4)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = isla_moments_pallas(jx, jnp.asarray(BOUNDS, jnp.float32), tm=TM,
                               stride=stride, interpret=True,
                               prior=jnp.asarray(prior))
    tx = _t(np.asarray(jx.astype(jnp.float32)), getattr(torch, dtype))
    got = K.isla_moments(tx, BOUNDS, tm=TM, stride=stride, prior=_t(prior))
    np.testing.assert_allclose(_np(got), _np(want),
                               rtol=5e-3 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("entry", ["isla_moments", "ops.isla_moments"])
def test_million_sample_cell_matches_pallas(entry, rng):
    """Row 2 at about a million samples in one cell (8192 x 128), where
    a single fp32 chain per thread drifts: within rel 1e-5 of the
    reference kernel, through the wrapper and the public ``ops`` call."""
    x = rng.normal(100, 20, size=(8192, 128)).astype(np.float32)
    want = isla_moments_pallas(jnp.asarray(x),
                               jnp.asarray(BOUNDS, jnp.float32), tm=512,
                               interpret=True)
    call = K.isla_moments if entry == "isla_moments" else tops.isla_moments
    got = call(_t(x), BOUNDS, tm=512)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)


def test_grouped_matches_pallas(rng):
    """Row 3: (G, B) cells as a reshape of the batched axis, with a
    ragged prior (one all-zero cold cell)."""
    g, b = 3, 5
    x = rng.normal(100, 20, size=(g, b, TM * 2, 128)).astype(np.float32)
    prior = rng.uniform(0, 10, size=(g, b, 2, 4)).astype(np.float32)
    prior[1, 2] = 0.0
    want = isla_moments_grouped_pallas(
        jnp.asarray(x), jnp.asarray(BOUNDS, jnp.float32), tm=TM,
        interpret=True, prior=jnp.asarray(prior))
    got = K.isla_moments_grouped(_t(x), BOUNDS, tm=TM, prior=_t(prior))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)
    with pytest.raises(ValueError, match="prior"):
        K.isla_moments_grouped(_t(x), BOUNDS, tm=TM,
                               prior=torch.zeros((3, 2, 2, 4)))


@pytest.mark.parametrize("compacted", [False, True])
def test_fused_matches_pallas(compacted, rng):
    """Row 4: fold onto the prior + Phase 2, per-cell cuts and inverse
    scale; compacted with out-of-range pads that must drop."""
    cells = 7
    params_r, params_t = RParams(), TParams()
    prior = rng.uniform(0, 10, size=(cells, 2, 4)).astype(np.float32)
    bounds = (np.asarray(BOUNDS, np.float32)[None]
              + rng.uniform(-3, 3, size=(cells, 1))).astype(np.float32)
    inv_scale = rng.uniform(0.5, 2.0, size=cells).astype(np.float32)
    if compacted:
        active = np.array([1, 4, 6, cells, cells + 3], np.int32)
    else:
        active = None
    n_launch = cells if active is None else active.size
    x = rng.normal(100, 20, size=(n_launch, TM * 2, 128)).astype(np.float32)
    want_m, want_p = isla_fused_pallas(
        jnp.asarray(x), jnp.asarray(bounds), jnp.asarray(prior),
        jnp.float32(100.0), params_r, tm=TM, interpret=True,
        inv_scale=jnp.asarray(inv_scale),
        active_cells=None if active is None else jnp.asarray(active))
    t_prior = _t(prior)
    got_m, got_p = K.isla_fused(
        _t(x), _t(bounds), t_prior, 100.0, params_t, tm=TM,
        inv_scale=_t(inv_scale),
        active_cells=None if active is None else _t(active, torch.int32))
    assert got_m is t_prior  # the prior is updated in place
    np.testing.assert_allclose(_np(got_m), _np(want_m), rtol=1e-5)
    np.testing.assert_allclose(_np(got_p), _np(want_p), rtol=1e-5)
    if compacted:  # untouched rows stay bit-identical to the prior
        idle = [c for c in range(cells) if c not in active]
        assert np.array_equal(_np(got_m)[idle], prior[idle])


@pytest.mark.parametrize("n", [500, TM * 128 * 3 + 5, TM * 128 * 4])
def test_pilot_stats_matches_pallas(n, rng):
    """Row 7: (count, sum, sumsq, min) at ragged sizes; the port's kernel
    masks its own tail where the reference pads with the first element."""
    x = rng.normal(-5, 3, size=n).astype(np.float32)
    if n % (TM * 128) == 0:
        want = pilot_stats_pallas(jnp.asarray(x).reshape(-1, 128), tm=TM,
                                  interpret=True)
    else:
        want = rops.pilot_stats(jnp.asarray(x), tm=TM)
    got = tops.pilot_stats(_t(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-2)
    assert float(got[0]) == n and float(got[3]) == float(x.min())


def test_pilot_stats_center(rng):
    """The centered second launch: sum (x - c) and sum (x - c)^2."""
    x = rng.normal(40, 3, size=1000).astype(np.float32)
    c = np.float32(x.mean())
    got = K.pilot_stats(_t(x), center=_t([c]))
    d = x.astype(np.float64) - float(c)
    np.testing.assert_allclose(_np(got)[1:3], [d.sum(), (d * d).sum()],
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("n", [100, 8192, TM * 128 + 17])
@pytest.mark.parametrize("stride", [1, 2])
def test_ops_isla_moments_matches_reference(n, stride, rng):
    x = rng.normal(100, 20, size=n).astype(np.float32)
    want = rops.isla_moments(jnp.asarray(x), jnp.asarray(BOUNDS, jnp.float32),
                             tm=TM, stride=stride)
    got = tops.isla_moments(_t(x), BOUNDS, tm=TM, stride=stride)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4)


@pytest.mark.parametrize("mode", ["calibrated", "empirical", "faithful"])
def test_phase2_and_moments_match_reference(mode, rng):
    """The torch Phase 2 in all three modes (per-cell thr and b0, cells
    that fall back to sketch0) and the masked ``moments`` helper."""
    n = 64
    mom_s = rng.uniform(0, 50, size=(n, 4)).astype(np.float32)
    mom_l = rng.uniform(0, 50, size=(n, 4)).astype(np.float32)
    mom_s[:4, 0] = 0.0  # empty S region: the sketch0 fallback
    sk = rng.uniform(0.8, 1.2, size=n).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    geo = (0.21, 0.03) if mode == "empirical" else None
    thr, g = RD._scaled_solve_args(RParams(), geo, jnp.asarray(inv))
    want = RD.phase2(jnp.asarray(mom_s), jnp.asarray(mom_l),
                     jnp.asarray(sk), RParams(), mode=mode, geometry=g,
                     thr=thr)
    thr, g = TD._scaled_solve_args(TParams(), geo, _t(inv))
    got = TD.phase2(_t(mom_s), _t(mom_l), _t(sk), TParams(), mode=mode,
                    geometry=g, thr=thr)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    x = rng.normal(100, 20, size=5000).astype(np.float32)
    valid = rng.random(5000) < 0.5
    prior = (np.ones(4, np.float32), np.full(4, 2.0, np.float32))
    w = RD.moments(jnp.asarray(x), BOUNDS, valid=jnp.asarray(valid),
                   prior=prior)
    t = TD.moments(_t(x), BOUNDS, valid=_t(valid, torch.bool), prior=prior)
    for a, b in zip(t, w):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5)


def test_fold_wrapper_rejects_bad_operands():
    v = torch.zeros((2, 8))
    out = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="gid"):
        K.isla_fold(v, torch.zeros(4), out, out, n_groups=2)
    with pytest.raises(ValueError, match="bounds"):
        K.isla_fold(v, torch.zeros(3), out, out)
    with pytest.raises(ValueError, match="out rows"):
        K.isla_fold(v, torch.zeros(4), torch.zeros((3, 4)),
                    torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="fp32, bf16 or float64"):
        K.isla_fold(v.half(), torch.zeros(4), out, out)
    # A float64 pane folds in float64: fp32 cuts are refused, never cast.
    with pytest.raises(ValueError, match="bounds must be contiguous float64"):
        K.isla_fold(v.double(), torch.zeros(4), out, out)


# ---------------------------------------------------------------------------
# The dense fold against the reference's fused_tick_dense (CPU XLA).
# ---------------------------------------------------------------------------

# Each case: per-key (n_groups, gid slot, valid slot, affine, bound slot).
DENSE_CASES = {
    "ungrouped": [(1, -1, -1, (1.0, 0.0), 0)],
    "grouped": [(3, 0, -1, (1.0, 0.0), 0), (1, -1, -1, (1.0, 0.0), 0)],
    "predicated": [(1, -1, 0, (1.0, 0.0), 0), (3, 0, 0, (1.0, 0.0), 0),
                   (3, 0, -1, (1.0, 0.0), 0)],
    "hetero_affine": [(1, -1, -1, (1.25, 0.1), 0),
                      (3, 0, 0, (0.8, -0.05), 1),
                      (1, -1, 0, (1.0, 0.0), 1)],
    "compacted": [(1, -1, 0, (1.0, 0.0), 0), (3, 0, -1, (1.1, 0.02), 1)],
}


def _dense_operands(case, rng):
    keys = DENSE_CASES[case]
    n_b = 6
    quotas = rng.integers(3, 14, size=n_b)
    if case == "compacted":
        quotas[[1, 4]] = 0
    active = np.flatnonzero(quotas > 0)
    a_pad = 8 if case == "compacted" else n_b
    pane_q = np.zeros(a_pad, np.int64)
    pane_q[:active.size] = quotas[active]
    if case != "compacted":
        pane_q = quotas.astype(np.int64)
    qmax = 16
    vmask = np.arange(qmax)[None, :] < pane_q[:, None]
    v2d = np.where(vmask, rng.normal(1.0, 0.2, size=vmask.shape), 0.0)
    pad = vmask.astype(np.float64)
    gid = np.where(vmask, rng.integers(0, 3, size=vmask.shape), 0)
    valid = np.where(vmask, rng.random(vmask.shape) < 0.7, 0.0)
    n_cells = sum(g * n_b for g, *_ in keys)
    prior = rng.uniform(0, 5, size=(n_cells, 11))
    ns = rng.integers(10, 30, size=len(keys) * n_b).astype(np.float64)
    bounds = np.array([[0.6, 0.9, 1.1, 1.4], [0.7, 0.95, 1.05, 1.3]])
    sketch0 = rng.uniform(0.95, 1.05, size=n_cells)
    sizes = np.full(len(keys) * n_b, 1e6)
    inv_scale = rng.uniform(0.8, 1.2, size=n_cells)
    active_cells = None
    if case == "compacted":
        ext = np.full(a_pad, -1)
        ext[:active.size] = active
        cell_idx, o = [], 0
        for k, (g, *_rest) in enumerate(keys):
            idx = o + np.arange(g)[:, None] * n_b + ext[None, :]
            cell_idx.append(np.where(ext[None, :] < 0, n_cells, idx)
                            .reshape(-1))
            o += g * n_b
        ns_idx = np.arange(len(keys))[:, None] * n_b + ext[None, :]
        ns_idx = np.where(ext[None, :] < 0, len(keys) * n_b, ns_idx)
        active_cells = (np.concatenate(cell_idx).astype(np.int32),
                        ns_idx.reshape(-1).astype(np.int32))
    static = dict(n_groups_list=tuple(k[0] for k in keys),
                  gid_slots=tuple(k[1] for k in keys),
                  valid_slots=tuple(k[2] for k in keys),
                  key_affine=tuple(k[3] for k in keys),
                  bound_slots=tuple(k[4] for k in keys))
    return dict(prior=prior, ns=ns, v2d=v2d, pad=pad, quotas=pane_q,
                gid=gid, valid=valid, bounds=bounds, sketch0=sketch0,
                sizes=sizes, inv_scale=inv_scale,
                active_cells=active_cells, static=static)


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_fold_matches_reference_tick(case, rng):
    o = _dense_operands(case, rng)
    params = dict(mode="calibrated", geometry=None)
    f = np.float32
    j = lambda a, dt=jnp.float32: jnp.asarray(np.asarray(a), dt)  # noqa
    want = RD.fused_tick_dense(
        j(o["prior"][:, 0:4]), j(o["prior"][:, 4:8]), j(o["prior"][:, 8:]),
        j(o["ns"]), j(o["v2d"]), j(o["pad"]), j(o["quotas"]),
        (j(o["gid"], jnp.int32),), (j(o["valid"]),), j(o["bounds"]),
        j(o["sketch0"]), j(o["sizes"]), j(o["inv_scale"]),
        None if o["active_cells"] is None
        else tuple(j(a, jnp.int32) for a in o["active_cells"]),
        params=RParams(), **params, **o["static"])
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa
        np.asarray(a).astype(f) if dt == torch.float32 else np.asarray(a),
        dtype=dt)
    state = [t(o["prior"][:, 0:4]), t(o["prior"][:, 4:8]),
             t(o["prior"][:, 8:]), t(o["ns"])]
    got = TD.fused_tick_dense(
        *state, t(o["v2d"]), t(o["pad"]), t(o["quotas"]),
        (t(o["gid"], torch.int32),), (t(o["valid"]),), t(o["bounds"]),
        t(o["sketch0"]), t(o["sizes"]), t(o["inv_scale"]),
        None if o["active_cells"] is None
        else tuple(t(a, torch.int32) for a in o["active_cells"]),
        params=TParams(), **params, **o["static"])
    for k in range(4):
        assert got[k] is state[k]  # resident state updated in place
    for k in range(3):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-5,
                                   atol=1e-5)
    assert np.array_equal(_np(got[3]), _np(want[3]))
    np.testing.assert_allclose(_np(got[4]), _np(want[4]), rtol=2e-4)
    np.testing.assert_allclose(_np(got[5]), _np(want[5]), rtol=1e-4,
                               atol=1e-4)
    if o["active_cells"] is not None:
        # Pruned cells' rows are never addressed: bit-identical prior.
        touched = o["active_cells"][0]
        touched = touched[touched < len(o["prior"])]
        idle = np.setdiff1d(np.arange(len(o["prior"])), touched)
        assert idle.size
        assert np.array_equal(_np(got[0])[idle],
                              o["prior"][idle, 0:4].astype(f))
