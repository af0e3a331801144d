"""The sharded serving forward (``models.model.serve_prefill`` and
``serve_decode`` on DTensors) on four gloo ranks on the CPU, and the
``constraint`` argument of ``serve_prefill`` against the reference's.

Tolerances: on a (2, 2) mesh with TP, FSDP and the cache's sequence
split on, every call's logits and every cache leaf within 1e-5 of its
scale of the meshless calls from the same fp32 weights and tokens: the
TP partial sums, and a decode over a cache split on S (each shard's
partial softmax combined), add in another order, nothing more.  A
one-rank mesh runs each rank's region on the whole tensors, so it equals
the meshless run bit for bit, with the same ``flash_attention`` calls.
The constraint test holds the reference's prefill at the parity test's
fp32 1e-4 (``tests/test_torch_lm.py``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_lm_cases as M
import _torch_serve_mesh_cases as S
from repro.models import model as RM
from repro_torch.models import model as TM
from test_torch_lm import LOGIT_TOL, _check_cache, _f32, _pair

TOL = 1e-5


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    out = tmp_path_factory.mktemp("serving")
    res = {}
    for world in (4, 1):
        M.spawn(S.sharded_serving, world, out, str(out))
        with open(out / f"serving_{world}.json") as f:
            res[world] = json.load(f)
    return res


@pytest.mark.parametrize("arch", S.ARCHS)
def test_sharded_serving_matches_the_meshless_calls(serving, arch):
    """Prefill and three decode steps on (2, 2): logits and cache within
    1e-5 of scale; the cache stays in its ``cache_specs`` placements."""
    res = serving[4][arch]
    assert len(res["steps"]) == 1 + S.DECODE_STEPS
    for i, row in enumerate(res["steps"]):
        assert row["logits"] <= TOL, (i, row)
        assert max(row["cache"]) <= TOL, (i, row)
    assert len(res["flash"][0]) == len(res["flash"][1])
    # batch over "data" and the sequence (attention) or the heads/channels
    # (Mamba) over "model"
    assert all(p.count("Shard") == 2 for p in res["placements"])


@pytest.mark.parametrize("arch", S.ARCHS)
def test_one_rank_mesh_is_the_meshless_run_bit_for_bit(serving, arch):
    res = serving[1][arch]
    assert res["equal"]
    assert res["flash"][0] == res["flash"][1]


def test_constraint_is_applied_before_each_period_position():
    """An identity constraint changes nothing against the reference's
    prefill (also given one), and is called once a period position of
    each group, as the reference's scan body calls it."""
    (cr, pr), (ct, pt) = _pair("jamba-1.5-large-398b", "float32")
    B, S0 = 2, 32
    toks = np.random.default_rng(3).integers(0, cr.vocab, (B, S0))
    seen = []

    def constraint(x):
        seen.append(tuple(x.shape))
        return x

    cache_r = RM.init_cache(cr, B, S0, dtype=jnp.float32)
    cache_t = TM.init_cache(ct, B, S0, dtype=torch.float32, device="cpu")
    lr, cache_r = RM.serve_prefill(
        cr, pr, {"tokens": jnp.asarray(toks, jnp.int32)}, cache_r,
        constraint=lambda x: x)
    lt, cache_t = TM.serve_prefill(
        ct, pt, {"tokens": torch.as_tensor(toks)}, cache_t,
        constraint=constraint)
    tol = LOGIT_TOL["float32"]
    np.testing.assert_allclose(_f32(lt), _f32(lr), rtol=tol, atol=tol)
    attn = [i for i, c in enumerate(cache_t) if "k" in c]
    _check_cache([cache_r[i] for i in attn], [cache_t[i] for i in attn],
                 "float32", "prefill", cache_dtype=torch.float32)
    assert seen == [(B, S0, ct.d_model)] * ct.n_layers


def test_no_constraint_is_the_unconstrained_prefill_bit_for_bit():
    (_, _), (ct, pt) = _pair("olmo-1b", "float32")
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, ct.vocab, (2, 16)))
    a = TM.serve_prefill(ct, pt, {"tokens": toks},
                         TM.init_cache(ct, 2, 16, device="cpu"))
    b = TM.serve_prefill(ct, pt, {"tokens": toks},
                         TM.init_cache(ct, 2, 16, device="cpu"),
                         constraint=lambda x: x)
    assert torch.equal(a[0], b[0])
    for ca, cb in zip(a[1], b[1]):
        assert all(torch.equal(ca[n], cb[n]) for n in ca)
