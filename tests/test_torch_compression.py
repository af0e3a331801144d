"""The port's elastic plans (``repro_torch.train.elastic``) and int8 gradient
compression (``repro_torch.train.compression``) on the CPU: the
reference's own cases on the port; ``quantize_int8``'s error bound and
its bits against the reference's; the EF-compressed all-reduce over 50
steps against the exact sum; with no mesh against the reference's
one-device ``shard_map`` within 1e-6; and on S = 2-4 CPU shards
(``make_cell_mesh(devices=["cpu"] * S)``) against the reference's
``shard_map`` over S of four host devices, run in a subprocess that
forces them before jax imports, within 1e-6, each cross-shard sum one
``mesh_all_reduce``.

"Within 1e-6" is of the scale of what is compared: the means' max |x|;
for the error feedback, the gradients' (the residual ``target - q *
scale`` is a difference of two numbers of the gradients' size, which XLA
computes as one fused multiply-subtract: ~1e-7 apart from the port's
two roundings on residuals of ~1e-2)."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import shard_map
from repro.train import compression as RCo
from repro.train import elastic as RE
from repro_torch.core import distributed as TD
from repro_torch.launch.mesh import make_cell_mesh
from repro_torch.train import compression as TCo
from repro_torch.train import elastic as TE

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-6
MESH_STEPS = 10
WIDTH = 256


# ---------------- elastic (the reference's cases on the port) ----------------

def test_remesh_plan():
    plan = TE.remesh_plan((2, 16, 16), ("pod", "data", "model"), 3)
    assert plan.shape == (2, 8, 16)            # 13 healthy -> 8 (pow2)
    assert plan.n_devices == 256
    plan2 = TE.remesh_plan((16, 16), ("data", "model"), 1)
    assert plan2.shape == (8, 16)
    want = RE.remesh_plan((2, 16, 16), ("pod", "data", "model"), 3)
    assert (plan.shape, plan.axis_names, plan.n_devices, plan.dropped_hosts,
            plan.note) == (want.shape, want.axis_names, want.n_devices,
                           want.dropped_hosts, want.note)
    with pytest.raises(RuntimeError):
        TE.remesh_plan((4, 16), ("data", "model"), 4)


@pytest.mark.parametrize("n", range(1, 40))
def test_largest_pow2_leq(n):
    assert TE.largest_pow2_leq(n) == RE.largest_pow2_leq(n)


def test_rescale_batch_keeps_global():
    gb, accum = TE.rescale_batch(256, old_data=16, new_data=8)
    assert gb == 256 and accum == 2
    assert TE.rescale_batch(256, 16, 8, keep_global=False) == (128, 1)
    with pytest.raises(ValueError):
        TE.rescale_batch(10, 4, 3)


def test_failure_injector_and_budget():
    fi = TE.FailureInjector([(10, 1), (20, 2)])
    assert fi.failures_at(10) == 1 and fi.failures_at(11) == 0
    assert fi.failures_at(10) == 0           # consumed
    sb = TE.StepBudget(seconds=10.0)
    q = sb.sample_quota(1000)
    assert 1 <= q <= 1000
    assert not sb.expired()
    assert TE.StepBudget(seconds=1e-9).sample_quota(1000) == 1


# ---------------- compression ----------------

def test_int8_quantization_error_bound():
    """The reference's bound on the port, and the same bits: q and the
    scale equal the reference's."""
    x = np.random.default_rng(0).normal(size=(1000,)).astype(np.float32)
    q, s = TCo.quantize_int8(torch.as_tensor(x))
    err = (TCo.dequantize_int8(q, s) - torch.as_tensor(x)).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    qr, sr = RCo.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    assert float(s) == float(sr)


def _grads(step, rng_seed=0, shards=1):
    base = np.random.default_rng(rng_seed).normal(
        size=(shards, WIDTH)).astype(np.float32)
    return base * np.float32(1.0 + 0.01 * step)


def test_compressed_allreduce_with_error_feedback():
    """The reference's case on the port: over 50 steps the EF-compressed
    sum tracks the exact accumulated sum within 1%."""
    ef = TCo.init_error_feedback({"w": torch.zeros(WIDTH)})
    acc_c = torch.zeros(WIDTH)
    acc_e = torch.zeros(WIDTH)
    for step in range(50):
        g = {"w": torch.as_tensor(_grads(step)[0])}
        out, ef = TCo.dp_allreduce_grads(g, ef, compress=True)
        acc_c += out["w"]
        acc_e += g["w"]
    rel = float(torch.linalg.norm(acc_c - acc_e) / torch.linalg.norm(acc_e))
    assert rel < 0.01


@pytest.mark.parametrize("compress", [True, False])
def test_one_device_matches_reference_shard_map(compress):
    """With no mesh, each of 50 steps (means and error feedback) within
    1e-6 of the reference's ``shard_map`` over one device (its identity
    psum), a tree of two leaves."""
    mesh = jax.make_mesh((1,), ("dp",))
    P = jax.sharding.PartitionSpec

    def run(g, e):
        return RCo.dp_allreduce_grads(g, e, "dp", compress=compress)

    ref = jax.jit(shard_map(run, mesh=mesh, in_specs=(P(), P()),
                            out_specs=(P(), P())))
    tree = lambda a: {"w": a[:200], "b": {"c": a[200:]}}
    ef_r = jax.tree_util.tree_map(jnp.asarray,
                                  tree(np.zeros(WIDTH, np.float32)))
    ef_t = TCo.init_error_feedback(tree(torch.zeros(WIDTH)))
    for step in range(50):
        g = tree(_grads(step)[0])
        out_r, ef_r = ref(jax.tree_util.tree_map(jnp.asarray, g), ef_r)
        out_t, ef_t = TCo.dp_allreduce_grads(
            {"w": torch.as_tensor(g["w"]),
             "b": {"c": torch.as_tensor(g["b"]["c"])}}, ef_t,
            compress=compress)
        g_scale = float(np.abs(_grads(step)).max())
        for a, b, scale in ((out_r, out_t, None), (ef_r, ef_t, g_scale)):
            for x, y in zip(jax.tree_util.tree_leaves(a),
                            [b["b"]["c"], b["w"]]):
                x = np.asarray(x)
                np.testing.assert_allclose(
                    y.numpy(), x, rtol=0,
                    atol=TOL * (scale or np.abs(x).max()))


_REF_RUN = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.train.compression import dp_allreduce_grads
from test_torch_compression import MESH_STEPS, _grads

out = {{}}
for s in (2, 3, 4):
    mesh = Mesh(np.array(jax.devices()[:s]), ("d",))
    for compress in (True, False):
        def run(g, e):
            o, e2 = dp_allreduce_grads({{"w": g[0]}}, {{"w": e[0]}}, "d",
                                       compress=compress)
            return o["w"][None], e2["w"][None]
        try:
            sm = shard_map(run, mesh=mesh, in_specs=(P("d"), P("d")),
                           out_specs=(P("d"), P("d")), check_rep=False)
        except TypeError:
            sm = shard_map(run, mesh=mesh, in_specs=(P("d"), P("d")),
                           out_specs=(P("d"), P("d")))
        f = jax.jit(sm)
        ef = jnp.zeros((s, {width}), jnp.float32)
        for step in range(MESH_STEPS):
            o, ef = f(jnp.asarray(_grads(step, 1, s)), ef)
            out[f"{{s}}_{{compress}}_{{step}}_out"] = np.asarray(o)
            out[f"{{s}}_{{compress}}_{{step}}_ef"] = np.asarray(ef)
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def reference_mesh(tmp_path_factory):
    path = tmp_path_factory.mktemp("compression") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _REF_RUN.format(
        path=str(path), width=WIDTH)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_mesh_matches_reference_shard_map(reference_mesh, n_shards,
                                          compress):
    """On S CPU shards, each of 10 steps: every shard's mean and error
    feedback within 1e-6 of the reference's; each leaf's cross-shard sums
    are ``mesh_all_reduce`` calls (compressed: the int32 payload, the
    count, the scale sum; uncompressed: the fp32 sum)."""
    mesh = make_cell_mesh(devices=["cpu"] * n_shards)
    ef = [TCo.init_error_feedback({"w": torch.zeros(WIDTH)})
          for _ in range(n_shards)]
    for step in range(MESH_STEPS):
        g = _grads(step, 1, n_shards)
        grads = [{"w": torch.as_tensor(g[k])} for k in range(n_shards)]
        with TD.collective_footprint() as rec:
            out, ef = TCo.dp_allreduce_grads(grads, ef, mesh=mesh,
                                             compress=compress)
        assert rec == ([("sum", WIDTH), ("sum", 1), ("sum", 1)] if compress
                       else [("sum", WIDTH)])
        want_o = reference_mesh[f"{n_shards}_{compress}_{step}_out"]
        want_e = reference_mesh[f"{n_shards}_{compress}_{step}_ef"]
        for k in range(n_shards):
            np.testing.assert_allclose(
                out[k]["w"].numpy(), want_o[k], rtol=0,
                atol=TOL * np.abs(want_o).max())
            np.testing.assert_allclose(
                ef[k]["w"].numpy(), want_e[k], rtol=0,
                atol=TOL * np.abs(g).max())
