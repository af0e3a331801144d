"""The device pilot of the port on the CPU: the pilot kernel's plain version
(``ref.pilot_moments_ref``, what ``K.pilot_moments`` runs for CPU tensors)
against numpy float64, the port's ``pilot_stats_device(device="cpu")``
against the reference's ``pilot_stats_device`` and the host reduction,
and the ``pilot_stats`` / ``ops.pilot_stats`` results derived from the
new entry against the reference's Pallas ``pilot_stats_pallas`` in
interpret mode.

Inputs come from numpy seeds at n = 1 to 10^6: a normal run, a constant
run, an all-negative run and a run centred far from 0 (mean 1234.5, sigma
17).  Tolerances: count and min exact, mean and M2 within rel 1e-5 of
float64 (the plain version accumulates in float64); the device pilot
within rel 1e-5 of the reference's (which sums the pre-scaled fp32 run in
fp32); the TPU kernel's (count, sum, sumsq, min) within rel 1e-4 of the
Pallas kernel's fp32 tile sums, as ``tests/test_torch_kernels.py`` holds
them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as RD
from repro.kernels import ops as rops
from repro.kernels.isla_moments import pilot_stats_pallas
from repro_torch.core import distributed as TD
from repro_torch.kernels import isla_moments as K
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from _torch_pilot_cases import CASES, SIZES, run

TM = 64  # the Pallas kernel's tile rows here: tiles of 8192 samples


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_plain_moments_match_float64(case, n):
    """``pilot_moments`` on the CPU: count and min exact, mean and M2
    within rel 1e-5 of numpy float64 on the same fp32 run, sigma with
    ddof = 1 (0 for one sample)."""
    x = run(case, n).astype(np.float32)
    got = K.pilot_moments(torch.from_numpy(x))
    assert got.dtype == torch.float64 and got.shape == (5,)
    assert torch.equal(got, ref.pilot_moments_ref(torch.from_numpy(x)))
    cnt, mean, m2, mn, sigma = got.tolist()
    xd = x.astype(np.float64)
    want_m2 = float(((xd - xd.mean()) ** 2).sum())
    assert cnt == n and mn == float(x.min())
    assert mean == pytest.approx(float(xd.mean()), rel=1e-5)
    assert m2 == pytest.approx(want_m2, rel=1e-5)
    want_sigma = float(np.std(xd, ddof=1)) if n > 1 else 0.0
    assert sigma == pytest.approx(want_sigma, rel=1e-5)
    if case == "constant":
        assert m2 == 0.0 and sigma == 0.0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_device_pilot_matches_reference_and_host(case, n):
    """The port's device pilot on the CPU against the reference's device
    pilot (sketch0 and sigma within rel 1e-5, min equal: both take the
    min of the same pre-scaled fp32 run) and against the host's
    ``np.mean`` / ``np.std(ddof=1)`` / ``np.min``."""
    v = run(case, n)
    mean, sigma, lo = TD.pilot_stats_device(v, device="cpu")
    r_mean, r_sigma, r_lo = RD.pilot_stats_device(v)
    assert mean == pytest.approx(r_mean, rel=1e-5)
    assert sigma == pytest.approx(r_sigma, rel=1e-5)
    assert lo == r_lo
    assert mean == pytest.approx(float(np.mean(v)), rel=1e-5)
    assert lo == pytest.approx(float(np.min(v)), rel=1e-6)
    if n > 1:
        assert sigma == pytest.approx(float(np.std(v, ddof=1)), rel=1e-5)
    else:
        assert sigma == 0.0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("entry", ["pilot_stats", "ops.pilot_stats"])
def test_stats_from_moments_match_pallas(entry, case, n):
    """(count, sum, sumsq, min) derived from the run's moments against the
    reference's Pallas kernel in interpret mode (through its padding
    wrapper where n is not a whole number of tiles; below one tile the
    wrapper takes the reference's plain sums)."""
    x = run(case, n).astype(np.float32)
    if n % (TM * 128) == 0:
        want = pilot_stats_pallas(jnp.asarray(x).reshape(-1, 128), tm=TM,
                                  interpret=True)
    else:
        want = rops.pilot_stats(jnp.asarray(x), tm=TM)
    call = K.pilot_stats if entry == "pilot_stats" else tops.pilot_stats
    got = call(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4,)
    assert float(got[0]) == n and float(got[3]) == float(x.min())
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-4)


@pytest.mark.parametrize("n", [1, 1000, 65_537])
def test_centred_stats_match_float64(n):
    """With a centre c on the device: sum (x - c) and sum (x - c)^2 of the
    fp32 run within rel 1e-5 of float64, the first with an absolute floor
    of n ulps of c (c is the run's fp32 mean, so the sum is ~0)."""
    x = run("far", n).astype(np.float32)
    c = np.float32(x.astype(np.float64).mean())
    got = K.pilot_stats(torch.from_numpy(x), center=torch.tensor([c]))
    d = x.astype(np.float64) - float(c)
    assert float(got[0]) == n and float(got[3]) == float(x.min())
    assert float(got[1]) == pytest.approx(
        d.sum(), rel=1e-5, abs=n * float(np.spacing(c)))
    assert float(got[2]) == pytest.approx(float((d * d).sum()), rel=1e-5)


def test_pilot_entries_check_their_input():
    """Both entries take a non-empty contiguous 1-D fp32 run; the device
    pilot refuses an empty pilot, as the reference does."""
    for bad in (torch.zeros(0), torch.zeros(4, dtype=torch.float64),
                torch.zeros((2, 2)), torch.zeros(8)[::2]):
        with pytest.raises(ValueError):
            K.pilot_moments(bad)
        with pytest.raises(ValueError):
            K.pilot_stats(bad)
    with pytest.raises(ValueError, match="center"):
        K.pilot_stats(torch.ones(4), center=torch.ones(2))
    with pytest.raises(ValueError, match="non-empty"):
        TD.pilot_stats_device(np.zeros(0), device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        RD.pilot_stats_device(np.zeros(0))


def test_cpu_calls_launch_nothing():
    """A call on CPU tensors runs the plain version and counts no launch."""
    K.reset_launch_counts()
    K.pilot_moments(torch.ones(10))
    K.pilot_stats(torch.ones(10))
    TD.pilot_stats_device(np.ones(10), device="cpu")
    assert K.pilot_stats.launches == 0


@pytest.mark.parametrize("case", CASES + ("zeros",))
def test_prescale_matches_reference_cast(case):
    """The host pre-scale is the reference's: scale = max(max |v|, 1e-12)
    and ``v / scale`` in float64 rounded to fp32, bit for bit."""
    v = np.zeros(4097) if case == "zeros" else run(case, 4097)
    v32, scale = TD.prescale_pilot(v)
    want = float(max(np.max(np.abs(v)), 1e-12))
    assert scale == want and v32.dtype == np.float32
    assert np.array_equal(v32, np.asarray(jnp.asarray(v / want,
                                                      jnp.float32)))
