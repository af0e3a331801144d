"""The port's Mamba2 mixer (``repro_torch.models.mamba2``) against the
reference's ``repro.models.mamba2`` on the CPU: the SSD scan against the
reference's chunked scan and its O(S^2) oracle, the causal conv, the
masked segment sum, the mixer's prefill and decode step, the chunk
contract's refusals beside the reference's own failures, init layout and
scales, ``convert.params_from`` on a tree with fp32 leaves in bf16, and
the reduced mamba2-130m and jamba stacks and slot schedulers.  The
weights are the reference's, carried through ``convert.params_from``;
inputs come from seeded numpy."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import mamba2 as RMa
from repro.models import model as RM
from repro.serve import BatchScheduler as RefScheduler
from repro.serve import Request as RefRequest
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import mamba2 as TMa
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import BatchScheduler, Request

MAMBA_ARCHS = ["mamba2-130m", "jamba-1.5-large-398b"]

# The reference's SSD test shapes (tests/test_model_parity.py).
B, S, H, P, G, N = 2, 48, 4, 8, 2, 16
# fp32: the port's chunked scan against the reference's, the same sums in
# other orders; against the oracle, the reference's own 1e-4 / 1e-5.
# bf16 inputs: the LM tests' 2e-2, relative to the output's scale.
CHUNK_TOL = 1e-5
ORACLE_TOL = (1e-4, 1e-5)
BF16_TOL = 2e-2
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ssd_inputs(seed=0, h0=False):
    """x, dt, A, Bm, Cm (and h0) as numpy fp32, the reference test's
    distributions."""
    rng = np.random.default_rng(seed)
    out = dict(x=rng.normal(size=(B, S, H, P)),
               dt=rng.uniform(0.01, 0.2, size=(B, S, H)),
               A=-rng.uniform(0.5, 2.0, size=(H,)),
               Bm=rng.normal(size=(B, S, G, N)),
               Cm=rng.normal(size=(B, S, G, N)))
    if h0:
        out["h0"] = rng.normal(size=(B, H, N, P))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _both(a, dtype):
    """The same numpy array as a jax and a torch array of ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    r = jnp.asarray(a, jd)
    return r, torch.as_tensor(np.array(r.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _ssd_pair(inp, dtype):
    """(reference args, port args): x, da, dt, Bm, Cm in ``dtype`` (da from
    the same fp32 dt * A on both sides)."""
    ref, port = [], []
    da = inp["dt"] * inp["A"]
    for a in (inp["x"], da, inp["dt"], inp["Bm"], inp["Cm"]):
        r, t = _both(a, dtype)
        ref.append(r)
        port.append(t)
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [8, 24, 48])
def test_ssd_chunked_matches_reference(chunk, with_h0, dtype):
    """y and h_final against the reference's ``ssd_chunked`` (fp32: rel
    1e-5; bf16: 2e-2 of scale) and y against the oracle (fp32: the
    reference's rtol 1e-4, atol 1e-5; without h0 only, as the oracle starts
    from zero)."""
    inp = _ssd_inputs(chunk, with_h0)
    ref, port = _ssd_pair(inp, dtype)
    h0r = jnp.asarray(inp["h0"]) if with_h0 else None
    h0t = torch.as_tensor(inp["h0"]) if with_h0 else None
    yr, hr = RMa.ssd_chunked(*ref, chunk, h0=h0r)
    yt, ht = TMa.ssd_chunked(*port, chunk, h0=h0t)
    assert yt.dtype == getattr(torch, dtype) and ht.dtype == torch.float32
    assert tuple(yt.shape) == (B, S, H, P) and tuple(ht.shape) == (B, H, N, P)
    for got, want, what in ((yt, yr, "y"), (ht, hr, "h_final")):
        got, want = _f32(got), _f32(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=CHUNK_TOL,
                                       atol=CHUNK_TOL, err_msg=what)
        else:
            err = np.abs(got - want).max()
            assert err <= BF16_TOL * np.abs(want).max(), (what, err)
    if not with_h0:
        want = _f32(TMa.ssd_reference(*port))
        np.testing.assert_allclose(want, _f32(RMa.ssd_reference(*ref)),
                                   rtol=CHUNK_TOL, atol=CHUNK_TOL)
        if dtype == "float32":
            np.testing.assert_allclose(_f32(yt), want, rtol=ORACLE_TOL[0],
                                       atol=ORACLE_TOL[1])
        else:
            assert np.abs(_f32(yt) - want).max() <= BF16_TOL * np.abs(
                want).max()


def test_ssd_head_map_is_repeat_interleave(monkeypatch):
    """At G = 2 head h reads group h // 2 (``jnp.repeat``).  A ``.repeat``
    map (group h % 2) gives another y, which the reference refuses."""
    inp = _ssd_inputs(5)
    ref, port = _ssd_pair(inp, "float32")
    yr, _ = RMa.ssd_chunked(*ref, 24)
    y, _ = TMa.ssd_chunked(*port, 24)
    np.testing.assert_allclose(_f32(y), _f32(yr), rtol=CHUNK_TOL,
                               atol=CHUNK_TOL)

    def tiled(t, rep, dim):
        reps = [1] * t.dim()
        reps[dim] = rep
        return t.repeat(*reps)

    monkeypatch.setattr(TMa, "_repeat_heads", tiled)
    y_wrong, _ = TMa.ssd_chunked(*port, 24)
    assert np.abs(_f32(y_wrong) - _f32(yr)).max() > 1e-2


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = RMa._causal_conv(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    got = TMa._causal_conv(torch.as_tensor(w), torch.as_tensor(b),
                           torch.as_tensor(x))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=1e-6)
    # causal: the first output row sees only the first input row
    np.testing.assert_allclose(_f32(got)[:, 0], x[:, 0] * w[3] + b,
                               rtol=1e-6, atol=1e-6)


def test_segsum_exp_masks_before_the_exp():
    """Large cumulative sums (a fast-decaying head) give no inf or NaN:
    the upper triangle is exactly 0, the lower exp(cum_q - cum_s)."""
    cum = np.stack([np.cumsum(-np.linspace(0.0, 400.0, 16)),
                    np.cumsum(-np.full(16, 0.01))]).astype(np.float32)
    got = TMa._segsum_exp(torch.as_tensor(cum))
    want = RMa._segsum_exp(jnp.asarray(cum))
    assert torch.isfinite(got).all()
    assert (got.triu(1) == 0).all()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=0)


def _pair(arch, dtype, seed=0, **changes):
    cr = ref_config(arch, reduced=True).replace(param_dtype=dtype, **changes)
    ct = get_config(arch, reduced=True).replace(param_dtype=dtype, **changes)
    pr = RM.init_params(cr, jax.random.key(seed))
    pt = convert.params_from(jax.tree_util.tree_map(np.asarray, pr),
                             device="cpu")
    return (cr, pr), (ct, pt)


def _layer0(cfg, pr, pt):
    """The first Mamba position's group-0 params on both sides."""
    pos = next(p for p in range(TT.period_of(cfg))
               if TT.position_kind(cfg, p)[0] == "mamba")
    ref = jax.tree_util.tree_map(lambda a: a[0], pr["blocks"][pos]["mamba"])
    return ref, TT.group_params(pt["blocks"][pos], 0)["mamba"]


@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_mamba_forward_prefill_and_decode_match_reference(arch):
    """fp32: a 64-token prefill from a nonzero state (two chunks of 32),
    then 3 decode steps from the states each side returned: y, h_final
    and the new conv tail within 1e-5."""
    (cr, pr), (ct, pt) = _pair(arch, "float32")
    p_r, p_t = _layer0(ct, pr, pt)
    m = ct.mamba
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 64, ct.d_model)).astype(np.float32)
    hs, _ = TMa.mamba_state_shapes(ct, 2)
    h0 = (rng.normal(size=hs) * 0.1).astype(np.float32)
    yr, hr, cr_ = RMa._mamba_forward(cr, p_r, jnp.asarray(x),
                                     h0=jnp.asarray(h0), conv0=None)
    yt, ht, ct_ = TMa._mamba_forward(ct, p_t, torch.as_tensor(x),
                                     h0=torch.as_tensor(h0), conv0=None)
    assert tuple(ct_.shape) == (2, m.d_conv - 1,
                                m.d_inner + 2 * m.n_groups * m.d_state)
    for step in range(4):
        for got, want, what in ((yt, yr, "y"), (ht, hr, "h"),
                                (ct_, cr_, "conv")):
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                       atol=1e-5,
                                       err_msg=f"step {step}: {what}")
        xd = rng.normal(size=(2, 1, ct.d_model)).astype(np.float32)
        yr, hr, cr_ = RMa.apply_mamba_decode(cr, p_r, jnp.asarray(xd),
                                             hr, cr_)
        yt, ht, ct_ = TMa.apply_mamba_decode(ct, p_t, torch.as_tensor(xd),
                                             ht, ct_)


@pytest.mark.parametrize("S, what", [(40, "chunk"), (2, "conv"),
                                     (96, None), (20, None), (3, None)])
def test_prefill_contract_refusals_match_reference(S, what):
    """Reduced mamba2-130m (chunk 32, d_conv 4): 40 tokens are longer than
    the chunk and off it, 2 leave no full conv tail; the port raises
    ``ValueError`` saying which where the reference fails (its assert, its
    ``None.astype``).  96, 20 and 3 tokens serve on both."""
    (cr, pr), (ct, pt) = _pair("mamba2-130m", "float32")
    toks = np.random.default_rng(3).integers(0, ct.vocab, (1, S))
    call_r = lambda: RM.serve_prefill(  # noqa: E731
        cr, pr, {"tokens": jnp.asarray(toks, jnp.int32)},
        RM.init_cache(cr, 1, S, dtype=jnp.float32))
    call_t = lambda: TM.serve_prefill(  # noqa: E731
        ct, pt, {"tokens": torch.as_tensor(toks)},
        TM.init_cache(ct, 1, S, dtype=torch.float32, device="cpu"))
    if what is None:
        np.testing.assert_allclose(_f32(call_t()[0]), _f32(call_r()[0]),
                                   rtol=1e-4, atol=1e-4)
        return
    with pytest.raises((AssertionError, AttributeError)):
        call_r()
    match = {"chunk": "not a multiple of it",
             "conv": "shorter than the conv tail"}[what]
    with pytest.raises(ValueError, match=match):
        call_t()
    with pytest.raises(ValueError, match="not a multiple"):
        TMa.ssd_chunked(*(torch.zeros(sh) for sh in (
            (1, 40, 4, 8), (1, 40, 4), (1, 40, 4), (1, 40, 1, 16),
            (1, 40, 1, 16))), 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_follows_reference_layout_and_scales(dtype):
    """The leaves, shapes and dtypes of the reference's ``init_mamba`` at
    mamba2-130m's full width (``A_log``, ``D`` and ``dt_bias`` fp32 in a
    bf16 tree); the projections' spread d ** -0.5, the convs' 0.2,
    out_proj's d_inner ** -0.5; ``A_log`` = log(linspace(1, 16, H))."""
    cr = ref_config("mamba2-130m").replace(param_dtype=dtype)
    ct = get_config("mamba2-130m").replace(param_dtype=dtype)
    want = jax.eval_shape(lambda k: RMa.init_mamba(cr, k), jax.random.key(0))
    got = TMa.init_mamba(ct, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for k, leaf in want.items():
        assert tuple(got[k].shape) == leaf.shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(leaf.dtype), k
    for name, fp32 in (("A_log", True), ("D", True), ("dt_bias", True),
                       ("wz", False), ("norm_scale", False)):
        assert (got[name].dtype == torch.float32) == (
            fp32 or dtype == "float32"), name
    m, d = ct.mamba, ct.d_model
    for name, scale in (("wz", d ** -0.5), ("wx", d ** -0.5),
                        ("wdt", d ** -0.5), ("conv_x_w", 0.2),
                        ("out_proj", m.d_inner ** -0.5)):
        assert abs(float(got[name].float().std()) / scale - 1.0) < 0.05, name
    ref = RMa.init_mamba(cr, jax.random.key(0))
    for name in ("A_log", "D", "dt_bias", "conv_x_b", "norm_scale"):
        np.testing.assert_allclose(_f32(got[name]), _f32(ref[name]),
                                   rtol=1e-6, atol=0, err_msg=name)


def test_params_from_carries_mamba_leaves_bit_for_bit():
    """A bf16 jamba tree (fp32 ``A_log``/``D``/``dt_bias`` and router
    inside) crosses with every leaf's dtype and bits kept."""
    cr = ref_config("jamba-1.5-large-398b", reduced=True)
    pr = jax.tree_util.tree_map(np.asarray,
                                RM.init_params(cr, jax.random.key(1)))
    pt = convert.params_from(pr, device="cpu")
    ref_leaves = jax.tree_util.tree_flatten_with_path(pr)[0]
    n_f32 = 0
    for path, leaf in ref_leaves:
        t = pt
        for p in path:
            t = t[getattr(p, "key", getattr(p, "idx", None))]
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
        if leaf.dtype == ml_dtypes.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  leaf.view(np.int16)), path
        else:
            n_f32 += leaf.dtype == np.float32
            assert np.array_equal(t.numpy(), leaf), path
    assert n_f32 >= 3 * 7  # A_log, D, dt_bias at each Mamba position


@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_init_cache_shapes_and_dtypes(arch):
    cfg = get_config(arch, reduced=True)
    ref = RM.init_cache(ref_config(arch, reduced=True), 3, 40)
    cache = TM.init_cache(cfg, 3, 40, device="cpu")
    assert len(cache) == len(ref) == TT.period_of(cfg)
    for c, r in zip(cache, ref):
        assert set(c) == set(r)
        for k in c:
            assert tuple(c[k].shape) == r[k].shape, k
            assert str(c[k].dtype).replace("torch.", "") == str(r[k].dtype)
    kinds = {TT.position_kind(cfg, p)[0] for p in range(TT.period_of(cfg))}
    assert "mamba" in kinds


@pytest.mark.parametrize("arch, dtype", [
    ("mamba2-130m", "float32"), ("mamba2-130m", "bfloat16"),
    ("jamba-1.5-large-398b", "float32")])
def test_stack_prefill_and_decode_match_reference(arch, dtype):
    """Two prompts of 64 tokens (two chunks) prefilled together into a
    cache in the param dtype, then 4 decode steps: logits within 1e-4
    (fp32) or 2e-2 (bf16), and every Mamba position's h and conv (fp32:
    1e-4; bf16: 2e-2 of the leaf's scale).  jamba's MoE routes the 128
    prefill tokens as two groups of 64 and each decode step's 2 tokens as
    one; its attention position runs the flash kernel's plain version.

    jamba is held in fp32 only: in bf16 each of its Mamba positions is
    within one bf16 ulp of the reference's, given the same input, but
    eight bf16 layers carry those ulps to 2.4e-2 in the logits (at a
    scale of 0.78), the MoE left out or not."""
    (cr, pr), (ct, pt) = _pair(arch, dtype)
    Bz, S0, steps = 2, 64, 4
    S = S0 + steps
    toks = np.random.default_rng(4).integers(0, cr.vocab, (Bz, S))
    tol = LOGIT_TOL[dtype]
    cache_r = RM.init_cache(cr, Bz, S, dtype=jnp.dtype(dtype))
    cache_t = TM.init_cache(ct, Bz, S, dtype=getattr(torch, dtype),
                            device="cpu")

    def check(lr, lt, what):
        assert bool(torch.isfinite(lt).all())
        np.testing.assert_allclose(_f32(lt), _f32(lr), rtol=tol, atol=tol,
                                   err_msg=what)
        for cr_, ct_ in zip(cache_r, cache_t):
            for name in ("h", "conv"):
                if name not in ct_:
                    continue
                got, want = _f32(ct_[name]), _f32(cr_[name])
                if dtype == "float32":
                    np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                               err_msg=f"{what}: {name}")
                else:
                    err = np.abs(got - want).max()
                    assert err <= tol * np.abs(want).max(), (what, name, err)

    lr, cache_r = RM.serve_prefill(
        cr, pr, {"tokens": jnp.asarray(toks[:, :S0], jnp.int32)}, cache_r)
    lt, cache_t = TM.serve_prefill(
        ct, pt, {"tokens": torch.as_tensor(toks[:, :S0])}, cache_t)
    assert lt.shape == (Bz, 1, ct.padded_vocab)
    check(lr, lt, "prefill")
    for t in range(S0, S):
        pos = np.full((Bz,), t)
        lr, cache_r = RM.serve_decode(
            cr, pr, jnp.asarray(toks[:, t:t + 1], jnp.int32),
            jnp.asarray(pos, jnp.int32), cache_r)
        lt, cache_t = TM.serve_decode(
            ct, pt, torch.as_tensor(toks[:, t:t + 1]), torch.as_tensor(pos),
            cache_t)
        check(lr, lt, f"decode step {t}")


def test_prefill_then_decode_matches_longer_prefill():
    """The reference's own contract (tests/test_model_parity.py): prefill
    on 28 tokens and 4 decode steps give prefill(32)'s last logits, on
    reduced mamba2-130m in fp32 (here within 1e-4)."""
    _, (ct, pt) = _pair("mamba2-130m", "float32")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, ct.vocab, (1, 32)))
    cache = TM.init_cache(ct, 1, 32, dtype=torch.float32, device="cpu")
    TM.serve_prefill(ct, pt, {"tokens": toks[:, :28]}, cache)
    for t in range(28, 32):
        lt, cache = TM.serve_decode(ct, pt, toks[:, t:t + 1],
                                    torch.full((1,), t), cache)
    full, _ = TM.serve_prefill(
        ct, pt, {"tokens": toks},
        TM.init_cache(ct, 1, 32, dtype=torch.float32, device="cpu"))
    np.testing.assert_allclose(_f32(lt), _f32(full), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_scheduler_matches_reference(arch):
    """The slot scheduler, fp32 params, default bf16 cache: 5 prompts of
    5-32 tokens through 3 slots (slots recycled, the Mamba state of a
    recycled slot zeroed before its prefill), tokens and finish order the
    reference's; jamba makes no flash launch on the CPU."""
    (cr, pr), (ct, pt) = _pair(arch, "float32", seed=6)
    ref = RefScheduler(cr, pr, batch_slots=3, max_seq=64, eos_id=-1)
    port = BatchScheduler(ct, pt, batch_slots=3, max_seq=64, eos_id=-1)
    prompts = [list(np.random.default_rng(7).integers(0, ct.vocab, n))
               for n in (5, 32, 9, 16, 12)]
    for s, req in ((ref, RefRequest), (port, Request)):
        for rid, p in enumerate(prompts):
            s.submit(req(rid=rid, prompt=[int(t) for t in p],
                         max_new=3 + rid % 3))
    launches = FA.flash_attention.launches
    done = port.run_until_drained(max_ticks=64)
    ref.run_until_drained(max_ticks=64)
    assert FA.flash_attention.launches == launches
    assert len(done) == len(prompts) and all(r.done for r in done)
    assert [(r.rid, r.generated) for r in port.finished] == \
        [(r.rid, r.generated) for r in ref.finished]


@functools.lru_cache(maxsize=1)
def _deep_mamba():
    """mamba2-130m at its full depth (24 layers) and chunk (256), at the
    reduced width, the reference's weights carried to the port, and 256
    seeded tokens: (reference config, params; port config, params;
    tokens)."""
    import dataclasses

    cr = ref_config("mamba2-130m", reduced=True).replace(n_layers=24)
    cr = cr.replace(mamba=dataclasses.replace(cr.mamba, chunk=256))
    ct = get_config("mamba2-130m", reduced=True).replace(n_layers=24)
    ct = ct.replace(mamba=dataclasses.replace(ct.mamba, chunk=256))
    pr = RM.init_params(cr, jax.random.key(0))
    pt = convert.params_from(jax.tree_util.tree_map(np.asarray, pr),
                             device="cpu")
    toks = np.random.default_rng(1).integers(0, ct.vocab, (1, 256))
    return cr, pr, ct, pt, toks


def _deep_steps(who, dtype, S, steps=0):
    """On ``_deep_mamba``'s stack in ``dtype`` (weights and cache), by the
    reference (``who`` "ref") or the port: a prefill of the first ``S``
    tokens, then ``steps`` decode steps; the last logits as fp32 numpy."""
    cr, pr, ct, pt, toks = _deep_mamba()
    T = S + steps
    if who == "ref":
        c = cr.replace(param_dtype=dtype)
        p = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.dtype(dtype))
            if a.dtype == jnp.bfloat16 else a, pr)
        cache = RM.init_cache(c, 1, T, dtype=jnp.dtype(dtype))
        lg, cache = RM.serve_prefill(
            c, p, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)}, cache)
        for t in range(S, T):
            lg, cache = RM.serve_decode(
                c, p, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                jnp.full((1,), t, jnp.int32), cache)
        return _f32(lg)
    c = ct.replace(param_dtype=dtype)
    p = jax.tree_util.tree_map(
        lambda t: t.to(getattr(torch, dtype))
        if t.dtype == torch.bfloat16 else t, pt)
    cache = TM.init_cache(c, 1, T, dtype=getattr(torch, dtype),
                          device="cpu")
    lg, _ = TM.serve_prefill(c, p, {"tokens": torch.as_tensor(toks[:, :S])},
                             cache)
    for t in range(S, T):
        lg, _ = TM.serve_decode(c, p, torch.as_tensor(toks[:, t:t + 1]),
                                torch.full((1,), t), cache)
    return _f32(lg)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_bf16_drift_over_depth_is_the_references():
    """bf16 roundings compound over a deep stack: at mamba2-130m's full
    depth (24 layers, here at the reduced width, chunk 256) a 256-token
    prefill's bf16 logits lie a few percent of their scale off the fp32
    ones from the same weights, in the reference as in the port.  The
    port's bf16 logits follow the reference's bf16 ones, not a drift of
    their own: they are within 2e-2 of scale of the reference's bf16
    logits, and less than half as far from them as the reference's bf16
    logits are from its fp32 ones.  The port's own drift is the
    reference's to within a factor of 1.5 either way (the bf16 card run's
    end-to-end gap is measured against this, not held to the
    layer-by-layer 2e-2)."""
    logits = {(who, dtype): _deep_steps(who, dtype, 256)
              for who in ("ref", "port") for dtype in ("bfloat16", "float32")}
    np.testing.assert_allclose(logits["port", "float32"],
                               logits["ref", "float32"], rtol=1e-4,
                               atol=1e-4)
    drift = {who: _rel(logits[who, "bfloat16"], logits[who, "float32"])
             for who in ("ref", "port")}
    apart = _rel(logits["port", "bfloat16"], logits["ref", "bfloat16"])
    print(f"24 layers, rel to scale: bf16 vs fp32 {drift}; port bf16 vs "
          f"reference bf16 {apart:.4g}")
    assert drift["ref"] > 2e-2
    assert 1 / 1.5 < drift["port"] / drift["ref"] < 1.5
    assert apart <= BF16_TOL
    assert apart < drift["ref"] / 2


def test_bf16_prefill_then_decode_is_the_references():
    """The reference's own contract (tests/test_model_parity.py) in bf16 at
    full depth: on ``_deep_mamba``'s 24 layers, prefill(252) and 4 decode
    steps against prefill(256)'s last logits, by the reference and by the
    port from the same weights.  Both meet the contract's rtol and atol
    2e-2 here, where the logits' scale is about 0.45; the port's gap,
    relative to scale, is at most 1.5 times the reference's own.  (At
    full width the logits' scale is about 2.4, where the same relative gap
    exceeds the contract's absolute 2e-2, so the card run prints this gap
    and holds the contract in fp32.)"""
    gaps = {}
    for who in ("ref", "port"):
        full = _deep_steps(who, "bfloat16", 256)
        steps = _deep_steps(who, "bfloat16", 252, steps=4)
        diff = np.abs(steps - full)
        gaps[who] = dict(max_abs=float(diff.max()),
                         scale=float(np.abs(full).max()),
                         rel=_rel(steps, full),
                         within=bool((diff <= 2e-2 + 2e-2 * np.abs(full))
                                     .all()))
    print(f"bf16 prefill(252) + 4 decode steps vs prefill(256), 24 layers: "
          f"{gaps}")
    assert gaps["ref"]["within"] and gaps["port"]["within"]
    assert gaps["port"]["rel"] <= 1.5 * gaps["ref"]["rel"]


def test_jamba_bf16_positions_match_reference():
    """jamba's hybrid stack in bf16 against the reference's in bf16,
    position by position: two 64-token prompts embedded alike, then each
    of the eight positions (7 Mamba, 1 attention on the flash kernel's
    plain version, MoE on the odd ones) run by both on the reference's own
    hidden state.  The port's next hidden state, and a Mamba position's
    new state and conv tail, are within 2e-2 of the reference's scale.
    (Run free, the eight positions carry their bf16 roundings to a few
    percent of the logits' scale on either side; that gap is printed.)"""
    from repro.models import attention as RA
    from repro.models import transformer as RT
    from repro.models.layers import apply_norm as r_norm
    from repro_torch.models import attention as TA
    from repro_torch.models.layers import apply_norm as t_norm

    (cr, pr), (ct, pt) = _pair("jamba-1.5-large-398b", "bfloat16")
    Bz, S = 2, 64
    toks = np.random.default_rng(4).integers(0, cr.vocab, (Bz, S))
    xr, pos_r, _ = RM._assemble_inputs(
        cr, pr, {"tokens": jnp.asarray(toks, jnp.int32)})
    pos_t = torch.arange(S).expand(Bz, S)
    kinds, errs = set(), {}
    for pos in range(TT.period_of(ct)):
        bpr = jax.tree_util.tree_map(lambda a: a[0], pr["blocks"][pos])
        bpt = TT.group_params(pt["blocks"][pos], 0)
        xt = torch.as_tensor(np.array(_f32(xr))).to(torch.bfloat16)
        hr = r_norm(cr, bpr.get("ln1", {}), xr)
        ht = t_norm(ct, bpt.get("ln1", {}), xt)
        mixer, channel = TT.position_kind(ct, pos)
        kinds.add((mixer, channel))
        states = []
        if mixer == "attn":
            shape = (Bz, S, ct.n_kv_heads, ct.head_dim)
            yr, _, _ = RA.attention_prefill(
                cr, bpr["attn"], hr, pos_r, jnp.zeros(shape, jnp.bfloat16),
                jnp.zeros(shape, jnp.bfloat16))
            yt, _, _ = TA.attention_prefill(
                ct, bpt["attn"], ht, pos_t,
                torch.zeros(shape, dtype=torch.bfloat16),
                torch.zeros(shape, dtype=torch.bfloat16))
        else:
            hs, _ = TMa.mamba_state_shapes(ct, Bz)
            yr, h_r, c_r = RMa._mamba_forward(
                cr, bpr["mamba"], hr, h0=jnp.zeros(hs, jnp.float32),
                conv0=None)
            yt, h_t, c_t = TMa._mamba_forward(
                ct, bpt["mamba"], ht, h0=torch.zeros(hs), conv0=None)
            states = [("h", h_t, h_r), ("conv", c_t, c_r)]
        xr, _ = RT._apply_channel(cr, pos, bpr, xr + yr, {})
        xt = TT._apply_channel(ct, pos, bpt, xt + yt)
        for what, got, want in [("x", xt, xr)] + states:
            errs[f"{pos} {mixer}/{channel} {what}"] = err = _rel(
                _f32(got), _f32(want))
            assert err <= BF16_TOL, (pos, mixer, channel, what, err)
    assert {m for m, _ in kinds} == {"attn", "mamba"}
    assert {c for _, c in kinds} >= {"moe", "mlp"}
    cache_r = RM.init_cache(cr, Bz, S, dtype=jnp.bfloat16)
    cache_t = TM.init_cache(ct, Bz, S, dtype=torch.bfloat16, device="cpu")
    lr, _ = RM.serve_prefill(cr, pr, {"tokens": jnp.asarray(toks, jnp.int32)},
                             cache_r)
    lt, _ = TM.serve_prefill(ct, pt, {"tokens": torch.as_tensor(toks)},
                             cache_t)
    print(f"jamba bf16, rel to the reference's scale, by position: {errs}; "
          f"free-running prefill logits {_rel(_f32(lt), _f32(lr)):.4g}")


def test_full_width_sizes_of_the_mamba_configs():
    """The sizes the card phase is cut by, from the reference's
    ``abstract_params`` (shapes only): mamba2-130m at full width and depth
    is 129,100,224 parameters (the port's init on the card counts the
    same); one full-width period of jamba (8 layers: 7 Mamba, 1
    attention, MoE on the odd positions) is 45.145 B parameters, 90.29 GB
    in bf16, more than one 80 GB card holds, so the card runs jamba at
    its reduced config."""
    def size(cfg):
        leaves = jax.tree_util.tree_leaves(RM.abstract_params(cfg))
        return (sum(int(np.prod(x.shape)) for x in leaves),
                sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in leaves))

    n, _ = size(ref_config("mamba2-130m"))
    assert n == 129_100_224
    n, nbytes = size(ref_config("jamba-1.5-large-398b").replace(n_layers=8))
    assert (n, nbytes) == (45_144_659_968, 90_290_379_264)
    assert nbytes > 80e9
