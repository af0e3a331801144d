"""The telemetry estimator of the port on the CPU: ``distributed``'s
``local_pilot``, ``subsample``, ``pilot_band_geometry``, ``isla_mean`` and
``exact_mean`` and ``metrics``' ``loss_stats``, ``loss_stats_trimmed_exact``,
``grad_abs_stats`` and ``router_load_stats`` against the JAX package's on
the same seeded numpy inputs; on one device in this process, and on a
mesh of S = 1 to 4 CPU shards (``make_cell_mesh(devices=["cpu"] * S)``)
against the reference under ``shard_map`` over S of four host devices, in
a subprocess that forces them before jax imports.

Tolerances: the strided selections (the pilot slice and the subsample)
bit for bit, the pilot's count exact and its two fp32 sums within rel
1e-6 (both sum 256 or 2048 fp32 terms, in different orders); the band
geometry and every ISLA answer within rel 1e-5; ``exact_mean`` and the
trimmed mean within rel 1e-6.  The generator path draws other indices
than ``jax.random`` and is held statistically, as the reference's own
test holds it (normal(100, 20) within 0.5 of the mean).  On the mesh the
cross-shard sums are recorded by ``collective_footprint``: 3 (pilot), 6
(empirical geometry), then 8 (merged) or 2 (blocks), and 2 for
``exact_mean``; their total equals the elements of the all-reduces in the
reference's compiled HLO.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as RD
from repro.core import metrics as RM
from repro.core.types import IslaParams as RParams
from repro_torch.core import distributed as TD
from repro_torch.core import metrics as TM
from repro_torch.core.types import IslaParams as TParams
from repro_torch.kernels import isla_moments as K
from repro_torch.launch.mesh import make_cell_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
RP, TP = RParams(e=0.01, te=3.0), TParams(e=0.01, te=3.0)
SEMANTICS = ("blocks", "merged")
MODES = ("calibrated", "empirical")
DISTS = ("normal", "gamma")
MESH_SHAPE = (240, 512)   # rows divide into 1, 2, 3 and 4 shards
MESH_RATE = 0.05


def data(dist: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist == "normal":
        return rng.normal(100.0, 20.0, size=shape).astype(np.float32)
    return rng.gamma(2.0, 2.0, size=shape).astype(np.float32)


def f(x) -> float:
    return float(np.asarray(x))


@pytest.mark.parametrize("pilot_size", [256, 2048])
@pytest.mark.parametrize("n", [1, 100, 257, 5000, 70001])
def test_local_pilot(n, pilot_size):
    x = data("gamma", n, seed=n)
    r = [f(a) for a in RD.local_pilot(jnp.asarray(x), pilot_size)]
    t = TD.local_pilot(torch.from_numpy(x), pilot_size)
    assert all(a.dtype == torch.float32 and a.dim() == 0 for a in t)
    assert f(t[2]) == r[2]
    assert f(t[0]) == pytest.approx(r[0], rel=1e-6)
    assert f(t[1]) == pytest.approx(r[1], rel=1e-6)
    take = min(pilot_size, n)
    stride = max(n // take, 1)
    want = np.asarray(jax.lax.slice(jnp.asarray(x), (0,), (take * stride,),
                                    (stride,)))
    assert np.array_equal(TD._strided(torch.from_numpy(x), take,
                                      stride).numpy(), want)


@pytest.mark.parametrize("rate", [0.001, 0.02, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("n", [1, 999, 10000, 65537])
def test_subsample_strided_bit_for_bit(n, rate):
    x = data("normal", n, seed=1)
    want = np.asarray(RD.subsample(jnp.asarray(x), rate))
    got = TD.subsample(torch.from_numpy(x), rate).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def test_subsample_generator_draws_on_the_values_device():
    x = torch.arange(10000, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    s = TD.subsample(x, 0.05, g)
    assert s.shape == (500,) and bool(((s >= 0) & (s < 10000)).all())
    again = TD.subsample(x, 0.05, torch.Generator().manual_seed(0))
    assert torch.equal(s, again)


@pytest.mark.parametrize("dist", DISTS)
def test_pilot_band_geometry(dist):
    x = data(dist, 4096, seed=3)
    xs = x / np.float32(np.abs(x.mean()))
    sk, sg = np.float32(xs.mean()), np.float32(xs.std())
    r = RD.pilot_band_geometry(jnp.asarray(xs), jnp.float32(sk),
                               jnp.float32(sg), RP)
    t = TD.pilot_band_geometry(torch.from_numpy(xs), torch.tensor(sk),
                               torch.tensor(sg), TP)
    for a, b in zip(t, r):
        assert f(a) == pytest.approx(f(b), rel=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("rate", [0.02, 0.1])
def test_isla_mean_matches_reference(dist, semantics, mode, rate):
    x = data(dist, (512, 256), seed=4)
    want = f(RD.isla_mean(jnp.asarray(x), RP, rate=rate,
                          semantics=semantics, mode=mode))
    got = TD.isla_mean(torch.from_numpy(x), TP, rate=rate,
                       semantics=semantics, mode=mode)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert f(got) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("scale", [1e-3, 1000.0])
def test_isla_mean_scale_invariance(scale):
    """The reference's scale-invariance case, both packages: the answer
    moves with the tensor's scale, and the port holds the reference at
    each scale (also with a ``scale_hint``)."""
    x = data("normal", (64, 256), seed=5) / np.float32(5.0)
    xs = (x * np.float32(scale)).astype(np.float32)
    a = f(TD.isla_mean(torch.from_numpy(x), TP, rate=0.2))
    b = f(TD.isla_mean(torch.from_numpy(xs), TP, rate=0.2))
    assert b == pytest.approx(a * scale, rel=1e-3)
    for v, hint in ((x, None), (xs, None), (xs, 7.0 * scale)):
        want = f(RD.isla_mean(jnp.asarray(v), RP, rate=0.2,
                              scale_hint=hint))
        got = f(TD.isla_mean(torch.from_numpy(v), TP, rate=0.2,
                             scale_hint=hint))
        assert got == pytest.approx(want, rel=1e-5)


def test_isla_mean_generator_accuracy():
    """The generator path, as ``test_isla_mean_jit_accuracy`` holds the
    reference's: normal(100, 20) within 0.5 of the exact mean."""
    x = data("normal", (512, 512), seed=6)
    exact = float(x.astype(np.float64).mean())
    for sem in SEMANTICS:
        for seed in range(3):
            g = torch.Generator().manual_seed(seed)
            got = f(TD.isla_mean(torch.from_numpy(x), TP, rate=0.1,
                                 generator=g, semantics=sem))
            assert got == pytest.approx(exact, abs=0.5)
        want = f(RD.isla_mean(jnp.asarray(x), RP, rate=0.1,
                              key=jax.random.key(0), semantics=sem))
        assert want == pytest.approx(exact, abs=0.5)


def test_isla_mean_one_fold_and_no_upload(monkeypatch):
    """Phase 1 is one fold call a shard (the kernel's plain version on the
    CPU), and nothing is uploaded through ``h2d``."""
    folds = []
    real = K.isla_fold_stack

    def spy(values, *a, **kw):
        folds.append(tuple(values.shape))
        return real(values, *a, **kw)

    def no_upload(*a, **kw):
        raise AssertionError("isla_mean uploaded through h2d")

    monkeypatch.setattr(K, "isla_fold_stack", spy)
    monkeypatch.setattr(TD, "h2d", no_upload)
    x = torch.from_numpy(data("gamma", (256, 1024), seed=7))
    TD.isla_mean(x, TP, rate=0.02, mode="empirical")
    assert folds == [(1, 5243)]
    folds.clear()
    mesh = make_cell_mesh(devices=["cpu"] * 4)
    TD.isla_mean(list(x.chunk(4)), TP, mesh=mesh, rate=0.02,
                 semantics="merged")
    assert folds == [(1, 1311)] * 4
    TD.exact_mean(x)


@pytest.mark.parametrize("shape", [(3, 7), (100, 7), (128, 512)])
def test_exact_mean(shape):
    x = data("gamma", shape, seed=8)
    want = f(RD.exact_mean(jnp.asarray(x)))
    got = TD.exact_mean(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert f(got) == pytest.approx(want, rel=1e-6)


def test_loss_stats():
    x = data("gamma", (128, 512), seed=9)
    want = RM.loss_stats(jnp.asarray(x), include_exact=True)
    got = TM.loss_stats(torch.from_numpy(x), include_exact=True)
    assert set(got) == set(want) == {"loss_mean_isla", "loss_mean_exact"}
    for k in want:
        assert f(got[k]) == pytest.approx(f(want[k]), rel=1e-5)
    assert TM.DEFAULT_PARAMS == TP


@pytest.mark.parametrize("n", [1, 2, 1000, 4097, 2 ** 24 + 1])
def test_loss_stats_trimmed_exact(n):
    """Against ``jnp.quantile``'s linear rule, also above 2^24 elements
    (where ``torch.quantile`` refuses its input)."""
    x = data("gamma", n, seed=10)
    want = f(RM.loss_stats_trimmed_exact(jnp.asarray(x))["loss_mean_trimmed"])
    got = f(TM.loss_stats_trimmed_exact(torch.from_numpy(x))[
        "loss_mean_trimmed"])
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("q", [0.0, 0.023, 0.5, 0.977, 1.0])
@pytest.mark.parametrize("n", [1, 2, 10, 4097, 2 ** 24 + 1])
def test_trimmed_quantile_points(n, q):
    """The two quantile points equal ``jnp.quantile``'s bit for bit."""
    x = data("gamma", n, seed=11) if n < 2 ** 20 else \
        np.arange(n, dtype=np.float32) / np.float32(n)
    want = f(jnp.quantile(jnp.asarray(x), q))
    got = f(TM._quantile(torch.sort(torch.from_numpy(x)).values, q))
    assert got == want


def _grad_tree(rng):
    """A dict whose insertion order is not its sorted order, with leaves
    of tied size (two (64, 32) and two (2048,) leaves) and an empty
    one."""
    def g(*shape):
        return rng.normal(0.0, 1e-3, size=shape).astype(np.float32)
    return {"z_head": g(64, 32), "b": [g(2048), {"y": g(64, 32),
                                                 "a": g(0)}],
            "a_emb": g(2048), "m": (g(8, 16), g(300)), "c": None}


def _to(tree, conv):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, conv) for v in tree)
    return conv(tree)


def test_grad_abs_stats_leaf_order():
    tree = _grad_tree(np.random.default_rng(12))
    jtree, ttree = _to(tree, jnp.asarray), _to(tree, torch.from_numpy)
    order = [l.shape for l in jax.tree_util.tree_leaves(jtree)]
    assert [tuple(l.shape) for l in TM.tree_leaves(ttree)] == order
    for max_leaves in (1, 3, 8):
        want = RM.grad_abs_stats(jtree, rate=0.1, max_leaves=max_leaves)
        got = TM.grad_abs_stats(ttree, rate=0.1, max_leaves=max_leaves)
        assert f(got["grad_absmean_isla"]) == pytest.approx(
            f(want["grad_absmean_isla"]), rel=1e-5)


def test_router_load_stats():
    logits = np.random.default_rng(13).normal(size=(4, 256, 16))
    probs = torch.softmax(torch.from_numpy(logits), -1).float().numpy()
    want = RM.router_load_stats(jnp.asarray(probs))
    got = TM.router_load_stats(torch.from_numpy(probs))
    assert f(got["router_top1_isla"]) == pytest.approx(
        f(want["router_top1_isla"]), rel=1e-5)


# ---------------------------------------------------------------------------
# The mesh: S = 1 to 4 CPU shards against the reference under shard_map.
# ---------------------------------------------------------------------------

_REF_RUN = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core.distributed import collective_footprint, exact_mean, isla_mean
from repro.core.types import IslaParams
from test_torch_telemetry import DISTS, MESH_RATE, MESH_SHAPE, MODES, \\
    SEMANTICS, data

params = IslaParams(e=0.01, te=3.0)
out = {{}}


def run(fn, x, s):
    mesh = Mesh(np.array(jax.devices()[:s]), ("d",))
    try:
        sm = shard_map(fn, mesh=mesh, in_specs=P("d", None), out_specs=P(),
                       check_rep=False)
    except TypeError:
        sm = shard_map(fn, mesh=mesh, in_specs=P("d", None), out_specs=P())
    jf = jax.jit(sm)
    hlo = jf.lower(x).compile().as_text()
    return (np.asarray(jf(x)),
            sum(n for op, n in collective_footprint(hlo)))


for dist in DISTS:
    x = jnp.asarray(data(dist, MESH_SHAPE))
    for s in (1, 2, 3, 4):
        for sem in SEMANTICS:
            for mode in MODES:
                v, n = run(lambda v, sem=sem, mode=mode: isla_mean(
                    v, params, axis_names=("d",), rate=MESH_RATE,
                    semantics=sem, mode=mode), x, s)
                out[f"{{dist}}_{{s}}_{{sem}}_{{mode}}"] = v
                out[f"{{dist}}_{{s}}_{{sem}}_{{mode}}_elements"] = n
        v, n = run(lambda v: exact_mean(v, ("d",)), x, s)
        out[f"{{dist}}_{{s}}_exact"] = v
        out[f"{{dist}}_{{s}}_exact_elements"] = n
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def reference_mesh(tmp_path_factory):
    path = tmp_path_factory.mktemp("telemetry") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("JAX_ENABLE_X64", None)
    out = subprocess.run([sys.executable, "-c", _REF_RUN.format(
        path=str(path))], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


def _mesh_shards(dist, n_shards):
    mesh = make_cell_mesh(devices=["cpu"] * n_shards)
    x = torch.from_numpy(data(dist, MESH_SHAPE))
    return mesh, list(x.chunk(n_shards))


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("dist", DISTS)
def test_mesh_matches_reference(reference_mesh, dist, n_shards):
    mesh, shards = _mesh_shards(dist, n_shards)
    for sem in SEMANTICS:
        for mode in MODES:
            name = f"{dist}_{n_shards}_{sem}_{mode}"
            with TD.collective_footprint() as rec:
                got = TD.isla_mean(shards, TP, mesh=mesh, rate=MESH_RATE,
                                   semantics=sem, mode=mode)
            assert got.device == mesh.devices[0] and got.dim() == 0
            assert f(got) == pytest.approx(float(reference_mesh[name]),
                                           rel=1e-5), name
            want = [3] + ([6] if mode == "empirical" else []) \
                + [8 if sem == "merged" else 2]
            assert rec == [("sum", n) for n in want], name
            if n_shards > 1:
                assert sum(want) == int(reference_mesh[name + "_elements"])
    with TD.collective_footprint() as rec:
        got = TD.exact_mean(shards, mesh)
    assert rec == [("sum", 2)]
    assert f(got) == pytest.approx(
        float(reference_mesh[f"{dist}_{n_shards}_exact"]), rel=1e-6)


@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("mode", MODES)
def test_mesh_one_shard_is_the_device_route(semantics, mode):
    """At S = 1 the mesh runs the device route's steps: the same bits."""
    mesh, shards = _mesh_shards("gamma", 1)
    x = torch.from_numpy(data("gamma", MESH_SHAPE))
    a = TD.isla_mean(shards, TP, mesh=mesh, rate=MESH_RATE,
                     semantics=semantics, mode=mode)
    b = TD.isla_mean(x, TP, rate=MESH_RATE, semantics=semantics, mode=mode)
    assert torch.equal(a, b)


def test_mesh_metrics_and_generators():
    """``metrics`` with ``mesh=``: shard sequences in, one reduce a step;
    generators come one a shard."""
    mesh, shards = _mesh_shards("gamma", 3)
    with TD.collective_footprint() as rec:
        out = TM.loss_stats(shards, mesh=mesh, include_exact=True)
    assert rec == [("sum", 3), ("sum", 6), ("sum", 2), ("sum", 2)]
    assert f(out["loss_mean_exact"]) == pytest.approx(
        f(TD.exact_mean(torch.cat(shards))), rel=1e-6)
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    got = TD.isla_mean(shards, TP, mesh=mesh, rate=0.2, generator=gens)
    assert np.isfinite(f(got))
    with pytest.raises(ValueError, match="sequence of generators"):
        TD.isla_mean(shards, TP, mesh=mesh, generator=gens[0])
    with pytest.raises(ValueError, match="value shards"):
        TD.isla_mean(shards[:2], TP, mesh=mesh)
    with pytest.raises(ValueError, match="a tensor a shard"):
        TD.exact_mean(torch.cat(shards)[:3], mesh)
    with pytest.raises(ValueError, match="a tensor a shard"):
        TM.router_load_stats(torch.ones(3, 8, 4), mesh=mesh)
    with pytest.raises(ValueError, match="a tree a shard"):
        TM.grad_abs_stats({"w": torch.ones(4)}, mesh=mesh)
    probs = [torch.softmax(s.reshape(-1, 16), -1) for s in shards]
    r = TM.router_load_stats(probs, mesh=mesh)["router_top1_isla"]
    assert 0.0 < f(r) < 1.0
    tree = _grad_tree(np.random.default_rng(14))
    trees = [_to(tree, torch.from_numpy)] * 3
    g = TM.grad_abs_stats(trees, mesh=mesh, rate=0.1)["grad_absmean_isla"]
    assert np.isfinite(f(g))


def test_isla_mean_rejects_unknown_semantics():
    with pytest.raises(ValueError, match="unknown semantics"):
        TD.isla_mean(torch.ones(100), TP, semantics="tree")
