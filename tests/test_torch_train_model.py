"""The port's training forward and its gradients against the reference on
the CPU: ``model.train_loss`` and the grads of every leaf (autograd against
``jax.grad``) for every config of ``list_archs()`` in fp32 (the bf16 cases
are ``test_torch_train_model_bf16.py``), and the pieces on their own:
``_blocked_attention`` and ``attention_train``'s switch to it,
``chunked_ce_loss``, ``grad_boundary``, remat (bit for bit against no
remat), ``apply_mamba_train``'s grads, the MoE aux losses' grads and
``abstract_params``.

Tolerances: fp32 losses within rel 1e-5 and per-token losses within 1e-5
of their scale (sums of the same terms in other orders); fp32 grads
within 1e-4 of each leaf's scale (its max |g|): the reference's fp32
grads reach a few 1e-6 of scale through the attention and MoE layers and
~5e-5 through the SSD's ``A_log`` (exp of cumulative sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import mamba2 as RMa
from repro.models import model as RM
from repro.models import moe as RMo
from repro_torch.configs import list_archs
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TMa
from repro_torch.models import model as TM
from repro_torch.models import moe as TMo
from repro_torch.models import transformer as TT
from repro_torch.core.tree import tree_leaves, tree_paths, tree_unflatten

import _torch_train_cases as C

ARCHS = list_archs()
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _grad_case(arch):
    return C.parity_case(arch, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(arch):
    """The mean loss, the per-token losses (0 on a frontend's prefix) and
    the MoE aux losses on the same weights and batch."""
    r = _grad_case(arch)
    (lr, ar, _), (lt, at, _) = r["ref"], r["port"]
    assert float(lt) == pytest.approx(float(lr), rel=LOSS_TOL)
    want, got = ar["per_token_loss"], C.f32(at["per_token_loss"])
    assert got.shape == want.shape == (C.B, C.S)
    assert np.abs(got - want).max() <= LOSS_TOL * np.abs(want).max()
    np.testing.assert_array_equal(C.f32(at["loss_mask"]), ar["loss_mask"])
    cfg = r["cfg"]
    if cfg.frontend is not None:
        assert not got[:, :cfg.frontend_len].any()
    if cfg.moe is not None:
        for k in ("moe_lb_loss", "moe_z_loss"):
            assert float(at[k]) == pytest.approx(float(ar[k]), rel=LOSS_TOL)
    else:
        assert not any(k.startswith("moe") for k in at)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax_grad(arch):
    """Every leaf's gradient, in the reference's leaf order, in fp32."""
    r = _grad_case(arch)
    ref_g, port_g = r["ref"][2], r["port"][2]
    assert [p for p, _ in tree_paths(ref_g)] == r["grad_paths"]
    for leaf in tree_leaves(port_g):
        assert leaf.dtype == torch.float32 and torch.isfinite(leaf).all()
    for path, err, _ in C.leaf_gaps(ref_g, port_g):
        assert err <= GRAD_TOL, (path, err)


def test_train_loss_refuses_off_the_chunk_contract():
    """A Mamba config trains at most the chunk or a multiple of it, as the
    reference asserts."""
    (cr, _), (ct, pt) = C.pair("mamba2-130m", "float32")
    _, bt = C.batch(ct, s=48)
    with pytest.raises(ValueError, match="chunk"):
        TM.train_loss(ct, pt, bt)


# ---------------------------------------------------------------------------
# Attention: the blocked online softmax and the dense path.
# ---------------------------------------------------------------------------


def _qkv(B, S, H, KV, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(B, S, n, hd)).astype(np.float32)
           for n in (H, KV, KV)]
    ct = rng.normal(size=(B, S, H * hd)).astype(np.float32)
    if dtype == "bfloat16":
        out = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in out]
    return out, ct


def _dense(q, k, v, positions):
    """The dense formula the training path takes below the threshold."""
    causal = positions[:, None, :, None] >= positions[:, None, None, :]
    probs = torch.softmax(TA._masked(TA._gqa_scores(q, k), causal), -1)
    return TA._gqa_out(probs, v, q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S, block", [(32, 8), (64, 16), (64, 8)])
@pytest.mark.parametrize("H, KV", [(4, 2), (4, 4), (4, 1)])
def test_blocked_attention_matches_reference_and_dense(S, block, H, KV,
                                                       dtype):
    """``_blocked_attention`` forward and its q/k/v grads against the
    reference's (fp32 1e-5 of scale, bf16 2e-2) and, in fp32, against the
    dense formula (1e-5)."""
    (q, k, v), ct = _qkv(2, S, H, KV, 16, dtype)
    pos = np.broadcast_to(np.arange(S), (2, S))
    fn = lambda q_, k_, v_: RA._blocked_attention(q_, k_, v_,
                                                  jnp.asarray(pos), block)
    out_r, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    grads_r = vjp(jnp.asarray(ct).astype(out_r.dtype))
    qt, kt, vt = (C.to_torch(a).requires_grad_() for a in (q, k, v))
    pos_t = torch.as_tensor(pos.copy())
    out_t = TA._blocked_attention(qt, kt, vt, pos_t, block)
    assert out_t.dtype == qt.dtype and out_t.shape == (2, S, H * 16)
    grads_t = torch.autograd.grad(out_t, (qt, kt, vt),
                                  C.to_torch(np.asarray(
                                      jnp.asarray(ct).astype(out_r.dtype))))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, got, want in [("out", out_t, out_r)] + list(
            zip("qkv", grads_t, grads_r)):
        want = C.f32(want)
        err = np.abs(C.f32(got) - want).max()
        assert err <= tol * np.abs(want).max(), (name, err)
    if dtype == "float32":
        q2, k2, v2 = (C.to_torch(a).requires_grad_() for a in (q, k, v))
        dense = _dense(q2, k2, v2, pos_t)
        g2 = torch.autograd.grad(dense, (q2, k2, v2), torch.as_tensor(ct))
        for got, want in zip((out_t,) + grads_t, (dense,) + g2):
            want = want.detach().numpy()
            assert np.abs(C.f32(got) - want).max() <= \
                1e-5 * np.abs(want).max()


def test_attention_train_takes_the_blocked_path_as_the_reference(
        monkeypatch):
    """At ``S >= BLOCKED_THRESHOLD`` with ``S % 1024 == 0`` (the threshold
    lowered to 1024 in both packages, at a narrow width) both take the
    blocked path at block 1024; off a multiple of 1024 both stay dense."""
    assert TA.BLOCKED_THRESHOLD == RA.BLOCKED_THRESHOLD == 8192
    (cr, pr), (ct, pt) = C.pair("olmo-1b", "float32", d_model=32, n_heads=2,
                                n_kv_heads=1, head_dim=16)
    ar, at = pr["blocks"][0]["attn"], TT.group_params(
        pt["blocks"][0], 0)["attn"]
    ar = jax.tree_util.tree_map(lambda a: a[0], ar)
    for mod in (RA, TA):
        monkeypatch.setattr(mod, "BLOCKED_THRESHOLD", 1024)
    seen = []
    real = TA._blocked_attention
    monkeypatch.setattr(TA, "_blocked_attention", lambda *a, **kw: (
        seen.append(kw.get("block")), real(*a, **kw))[1])
    for S, blocked in ((1024, True), (1040, False)):
        x = np.random.default_rng(S).normal(size=(1, S, 32)).astype(
            np.float32)
        pos = np.arange(S)[None]
        want = RA.attention_train(cr, ar, jnp.asarray(x), jnp.asarray(pos))
        seen.clear()
        got = TA.attention_train(ct, at, torch.as_tensor(x),
                                 torch.as_tensor(pos))
        assert seen == ([1024] if blocked else [])
        want = C.f32(want)
        assert np.abs(C.f32(got) - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The chunked CE loss.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S, chunk", [(48, 512), (64, 16), (48, 32)],
                         ids=["one-chunk", "four-chunks", "fallback"])
def test_chunked_ce_loss_matches_reference(S, chunk, dtype):
    """One chunk, several, and a chunk that does not divide S (one chunk of
    all S): the sum, the per-token losses (masked) and the grads of x and
    the head, against the reference's (fp32 1e-5 of scale; bf16 logits
    rounded to bf16 as the reference's: 2e-2)."""
    (cr, pr), (ct, pt) = C.pair("olmo-1b", dtype, loss_chunk=chunk)
    rng = np.random.default_rng(S + chunk)
    x = rng.normal(size=(2, S, cr.d_model)).astype(np.float32)
    labels = rng.integers(0, cr.vocab, (2, S))
    mask = (rng.random((2, S)) < 0.8).astype(np.float32)
    xr = jnp.asarray(x).astype(cr.param_dtype)
    fn = lambda x_, e_: RL.chunked_ce_loss(
        cr, {"embedding": e_}, x_, jnp.asarray(labels, jnp.int32),
        jnp.asarray(mask))
    (sum_r, tok_r), vjp = jax.vjp(fn, xr, pr["embedding"])
    g_r = vjp((jnp.float32(1.0), jnp.zeros_like(tok_r)))
    xt = C.to_torch(np.asarray(xr)).requires_grad_()
    et = pt["embedding"].clone().requires_grad_()
    sum_t, tok_t = TL.chunked_ce_loss(ct, {"embedding": et}, xt,
                                      torch.as_tensor(labels),
                                      torch.as_tensor(mask))
    assert sum_t.dtype == tok_t.dtype == torch.float32
    g_t = torch.autograd.grad(sum_t, (xt, et))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert float(sum_t.detach()) == pytest.approx(float(sum_r), rel=tol)
    tok_r = np.asarray(tok_r)
    assert np.abs(C.f32(tok_t) - tok_r).max() <= tol * np.abs(tok_r).max()
    assert not C.f32(tok_t)[mask == 0].any()
    for got, want in zip(g_t, g_r):
        want = C.f32(want)
        assert np.abs(C.f32(got) - want).max() <= tol * np.abs(want).max()


# ---------------------------------------------------------------------------
# grad_boundary and remat.
# ---------------------------------------------------------------------------


def test_grad_boundary_casts_the_cotangent_to_the_primal_dtype():
    """Identity forward (same values and dtype); the backward hands an fp32
    cotangent back in bf16, rounded once."""
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16).requires_grad_()
    y = TT.grad_boundary(x)
    assert y.dtype == torch.bfloat16 and torch.equal(y, x)
    g = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))

    class Ctx:
        dtype = torch.bfloat16

    back = TT._GradBoundary.backward(Ctx, g)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, g.to(torch.bfloat16))
    (y.float() * g).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert torch.equal(x.grad, g.to(torch.bfloat16))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["olmo-1b", "jamba-1.5-large-398b"])
def test_remat_changes_no_bit(arch, policy):
    """The loss, the aux losses and every grad with each group under
    ``torch.utils.checkpoint`` equal, bit for bit, those without remat."""
    _, (ct, pt) = C.pair(arch, "float32")
    _, bt = C.batch(ct)
    outs = [C.port_run(ct.replace(remat=remat, remat_policy=policy), pt, bt)
            for remat in (False, True)]
    (l0, a0, g0), (l1, a1, g1) = outs
    assert torch.equal(l0, l1)
    for k in a0:
        assert torch.equal(a0[k], a1[k]), k
    for (path, x), y in zip(tree_paths(g0), tree_leaves(g1)):
        assert torch.equal(x, y), path


# ---------------------------------------------------------------------------
# The Mamba mixer and the MoE channel on their own.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [24, 32, 64], ids=["short", "one-chunk",
                                                 "two-chunks"])
def test_apply_mamba_train_grads_match_reference(S):
    """The training mixer's output and the grads of its input and of every
    parameter, fp32, against ``jax.vjp`` of the reference's: finite (no
    NaN through the masked exp of ``_segsum_exp``) and within 1e-4 of each
    leaf's scale."""
    (cr, pr), (ct, pt) = C.pair("mamba2-130m", "float32")
    mr = jax.tree_util.tree_map(lambda a: a[0], pr["blocks"][0]["mamba"])
    mt = TT.group_params(pt["blocks"][0], 0)["mamba"]
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, cr.d_model)).astype(np.float32)
    ct_ = rng.normal(size=(2, S, cr.d_model)).astype(np.float32)
    @jax.jit
    def ref(p, x_, c):
        out, vjp = jax.vjp(lambda p_, y: RMa.apply_mamba_train(cr, p_, y),
                           p, x_)
        return out, vjp(c)

    out_r, (gp_r, gx_r) = ref(mr, jnp.asarray(x), jnp.asarray(ct_))
    names = sorted(mt)
    leaves = [mt[n].clone().requires_grad_() for n in names]
    xt = torch.as_tensor(x).requires_grad_()
    out_t = TMa.apply_mamba_train(ct, dict(zip(names, leaves)), xt)
    grads = torch.autograd.grad(out_t, leaves + [xt], torch.as_tensor(ct_))
    want = [np.asarray(out_r), np.asarray(gx_r)] + [
        np.asarray(gp_r[n]) for n in names]
    got = [out_t.detach().numpy(), grads[-1].numpy()] + [
        g.numpy() for g in grads[:-1]]
    for name, g, w in zip(["out", "x"] + names, got, want):
        assert np.isfinite(g).all(), name
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("arch", ["arctic-480b", "grok-1-314b",
                                  "jamba-1.5-large-398b"])
def test_moe_grads_reach_router_and_experts(arch):
    """Through ``combine`` the output's gradient reaches the router and
    every expert weight, and ``moe_lb_loss`` and ``moe_z_loss`` are
    differentiable (through the mean router probabilities and the
    logsumexp), each grad within 1e-4 of the reference's scale, fp32."""
    (cr, _), (ct, _) = C.pair(arch, "float32")
    pr = RMo.init_moe(cr, jax.random.key(2))
    pt = {k: C.to_torch(np.asarray(v)) for k, v in
          jax.tree_util.tree_map(np.asarray, pr).items()
          if not isinstance(v, dict)}
    if "residual" in pr:
        pt["residual"] = {k: C.to_torch(np.asarray(v))
                          for k, v in pr["residual"].items()}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, cr.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 64, cr.d_model)).astype(np.float32)

    def ref_obj(p):
        y, aux = RMo.apply_moe(cr, p, jnp.asarray(x))
        return (jnp.sum(y * w), aux["moe_lb_loss"], aux["moe_z_loss"])

    leaves, paths = tree_leaves(pt), [p for p, _ in tree_paths(pt)]
    for i, name in enumerate(("out", "moe_lb_loss", "moe_z_loss")):
        want = jax.jit(jax.grad(lambda p: ref_obj(p)[i]))(pr)
        lt = [l.clone().requires_grad_() for l in leaves]
        y, aux = TMo.apply_moe(ct, tree_unflatten(pt, lt),
                               torch.as_tensor(x))
        obj = {"out": (y * torch.as_tensor(w)).sum()}.get(name, aux.get(name))
        got = torch.autograd.grad(obj, lt, allow_unused=True)
        by = dict(zip(paths, got))
        for path, wv in tree_paths(want):
            wv = np.asarray(wv)
            g = by[path]
            if not np.abs(wv).max():
                assert g is None or not g.any(), (name, path)
                continue
            assert np.abs(g.numpy() - wv).max() <= \
                1e-4 * np.abs(wv).max(), (name, path)
        router = by["['router']"]
        assert router is not None and router.abs().max() > 0, name
        if name == "out":
            for k in ("w_gate", "w_in"):
                if f"['{k}']" in by:
                    assert (by[f"['{k}']"].abs().amax((1, 2)) > 0).all()


# ---------------------------------------------------------------------------
# abstract_params.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_allocate_nothing(arch):
    """At full width: every leaf of the reference's ``abstract_params`` at
    its shape and dtype, on ``meta``; the port's own reduced init has the
    same tree."""
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config

    got = TM.abstract_params(get_config(arch))
    want = RM.abstract_params(ref_config(arch))
    gp, wp = tree_paths(got), tree_paths(want)
    assert [p for p, _ in gp] == [p for p, _ in wp]
    for (path, g), (_, w) in zip(gp, wp):
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
    reduced = TM.init_params(get_config(arch, reduced=True),
                             torch.Generator().manual_seed(0))
    assert [p for p, _ in tree_paths(reduced)] == [
        p for p, _ in tree_paths(TM.abstract_params(
            get_config(arch, reduced=True)))]
