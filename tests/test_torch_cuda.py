"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same device inputs, and the slice on ``cuda`` against the
slice on the CPU.  Marked ``cuda``: they skip where there is no card (the
card is looked for inside the fixture, never at import).  Run on a GPU
machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as TC
from repro_torch.kernels import isla_moments as K
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fold_case(case, dev, rng):
    n_b, q, g = 37, 200, 5
    vmask = np.arange(q)[None, :] < rng.integers(1, q, size=n_b)[:, None]
    v = np.where(vmask, rng.normal(1.0, 0.2, (n_b, q)), 0.0)
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa
        np.asarray(a), dtype=dt, device=dev).contiguous()
    kw = dict(pad=t(vmask))
    bounds = t([0.6, 0.9, 1.1, 1.4])
    n_out = n_b
    if case in ("grouped", "predicated", "compacted"):
        kw.update(gid=t(np.where(vmask, rng.integers(0, g, (n_b, q)), 0),
                        torch.int32), n_groups=g)
        n_out = g * n_b
    if case in ("predicated", "compacted"):
        kw["valid"] = t(np.where(vmask, rng.random((n_b, q)) < 0.6, 0.0))
    if case == "affine":
        kw["affine"] = (1.3, -0.07)
        bounds = t(np.asarray([0.6, 0.9, 1.1, 1.4])[None]
                   + rng.uniform(-0.05, 0.05, (n_b, 1)))
    if case == "compacted":
        idx = rng.permutation(2 * n_out)[:n_out] - n_out // 2
        kw["cell_idx"] = t(idx, torch.int32)
        n_out = 2 * n_out
    values = t(v, torch.bfloat16 if case == "bf16" else torch.float32)
    return values, bounds, n_out, kw


@pytest.mark.parametrize("case", ["plain", "grouped", "predicated",
                                  "affine", "compacted", "bf16"])
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
            assert K.isla_fold.launches > 0 and K.pilot_stats.launches == 2
    for c_run, g_run in zip(answers["cpu"], answers["cuda"]):
        for c, g in zip(c_run, g_run):
            assert g.value == pytest.approx(c.value, rel=2e-3)
            assert g.new_samples == c.new_samples
