"""The port's host extensions on the CPU: ``online`` (``OnlineBlockState``,
``continue_block`` with and without ``reanchor``), ``noniid``
(``block_leverages``, ``aggregate_noniid``) and ``extremes``
(``block_rate_leverages``, ``aggregate_extreme``) against the JAX
package's on the same seeded samplers, bit for bit: both are float64
numpy code over the same draws.  The cases mirror
``tests/test_baselines_online_noniid.py``, ``tests/test_extremes.py`` and
``tests/test_moment_store.py``'s ``test_continue_block_reanchor``.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as RC
import repro_torch.core as TC
from repro.core import extremes as RX
from repro.core import noniid as RN
from repro.core import online as RO
from repro_torch.core import extremes as TX
from repro_torch.core import noniid as TN
from repro_torch.core import online as TO

MU, SIGMA = 100.0, 20.0
MODES = ("calibrated", "faithful")


def _normal(n, rng):
    return rng.normal(MU, SIGMA, size=n)


def _fields(x):
    """A result's fields as plain values (nested dataclasses flattened)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _fields(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _rounds(pkg, reanchor, mode, sketch, n_rounds=4, n_new=3000, seed=0):
    params = pkg.IslaParams(e=0.1)
    b = pkg.make_boundaries(sketch, SIGMA, params)
    state = pkg.OnlineBlockState.fresh(0, b, sketch, shift=0.0)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_rounds):
        state, mod = pkg.continue_block(state, _normal, n_new, params, rng,
                                        mode=mode, reanchor=reanchor)
        out.append((_fields(state), _fields(mod)))
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("reanchor", [False, True])
@pytest.mark.parametrize("sketch", [MU + 0.3, MU + 0.6 * SIGMA])
def test_continue_block_bit_for_bit(reanchor, mode, sketch):
    want = _rounds(RC, reanchor, mode, sketch)
    got = _rounds(TC, reanchor, mode, sketch)
    assert got == want
    state = got[-1][0]
    assert state["rounds"] == 4 and state["n_sampled"] == 12000
    assert (state["sketch0"] != sketch) == reanchor


def test_online_state_store_view():
    """``as_store`` of a seeded state: a regions-only 1-cell store
    holding the state's moments, as the reference builds it."""
    for pkg, mod in ((RC, RO), (TC, TO)):
        b = pkg.make_boundaries(100.3, 20.0, pkg.IslaParams(e=0.1))
        st = mod.OnlineBlockState(
            block_id=3, boundaries=b, sketch0=100.3, shift=0.5,
            param_s=pkg.RegionMoments(5.0, 400.0, 32000.0, 2.6e6),
            param_l=pkg.RegionMoments(7.0, 800.0, 92000.0, 1.1e7),
            rounds=2, n_sampled=40)
        s = st.as_store()
        assert not s.has_totals and s.rounds == 2
        assert s.mom_s[0].tolist() == [5.0, 400.0, 32000.0, 2.6e6]
        assert s.mom_l[0].tolist() == [7.0, 800.0, 92000.0, 1.1e7]
        assert s.n_sampled.tolist() == [40]


@pytest.mark.parametrize("sigmas", [[10.0, 20.0, 30.0, 60.0, 40.0],
                                    [1.0], [0.0, 5.0, 5.0]])
def test_block_leverages_bit_for_bit(sigmas):
    got, want = TN.block_leverages(sigmas), RN.block_leverages(sigmas)
    assert np.array_equal(got, want)
    assert np.sum(got) == pytest.approx(1.0)


NONIID_DISTS = [(100, 20), (50, 10), (80, 30), (150, 60), (120, 40)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rate", [None, 0.002])
def test_aggregate_noniid_bit_for_bit(seed, mode, rate):
    """The §VIII-D setup (5 blocks, answer 100), plus a block that needs a
    shift (its values reach below 0)."""
    dists = NONIID_DISTS + [(5, 10)]
    samplers = [(lambda n, rng, m=m, s=s: rng.normal(m, s, size=n))
                for m, s in dists]
    sizes = [10 ** 6] * len(dists)
    out = []
    for pkg in (RC, TC):
        r = pkg.aggregate_noniid(samplers, sizes, pkg.IslaParams(e=0.5),
                                 np.random.default_rng(seed),
                                 rate_override=rate, mode=mode)
        out.append(_fields(r))
    assert out[1] == out[0]


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("zeta", [0.0, 1.0, 3.0])
def test_block_rate_leverages_bit_for_bit(mode, zeta):
    mus, sigmas = [100, 50, 150, 120], [20, 5, 10, 30]
    got = TX.block_rate_leverages(mus, sigmas, zeta=zeta, mode=mode)
    want = RX.block_rate_leverages(mus, sigmas, zeta=zeta, mode=mode)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("seed", [0, 7])
def test_aggregate_extreme_bit_for_bit(mode, seed):
    """``test_extremes``' four finite blocks (array samplers), both
    directions."""
    rng = np.random.default_rng(seed)
    blocks = [rng.normal(100, 20, 50_000), rng.normal(50, 10, 50_000),
              rng.normal(150, 30, 50_000), rng.normal(120, 5, 50_000)]
    out = []
    for pkg in (RC, TC):
        samplers = [pkg.array_sampler(b) for b in blocks]
        r = pkg.aggregate_extreme(samplers, [b.size for b in blocks],
                                  pkg.IslaParams(),
                                  np.random.default_rng(seed + 1),
                                  mode=mode, total_samples=20_000)
        out.append(_fields(r))
    assert out[1] == out[0]
    assert isinstance(out[1]["answer"], float)
