"""The port's MoE channel (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the CPU: capacity and the virtual
expert factor for every MoE config, init layout and scales, and
``apply_moe`` on the reduced MoE configs (arctic's dense residual, grok,
jamba's MoE positions at module level), the same weights carried through
``convert.params_from`` and the same seeded numpy inputs.

The reference's routing is read off the one-hot tensors its dispatch and
combine products take (``jnp.einsum`` spied on), the port's off
``moe._route``.  In fp32 the routing must be the reference's exactly;
in bf16 a router logit may round one ulp apart, so a token may take
another expert only where its competing logits are a near-tie."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import list_archs as ref_archs
from repro.models import model as RM
from repro.models import moe as RMo
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMo
from repro_torch.models import transformer as TT

MOE_ARCHS = ["arctic-480b", "grok-1-314b", "jamba-1.5-large-398b"]

# (batch, tokens, capacity_factor, mlp) of each parity case; every reduced
# MoE config routes in groups of 64.
CASES = {"fallback": (1, 50, None, None),   # 50 % 64 != 0: one group of 50
         "groups": (2, 96, None, None),     # 192 tokens: 3 groups of 64
         "drops": (2, 64, 0.5, None),       # C halved: tokens are dropped
         "gelu": (2, 64, None, "gelu")}     # the w_in / w_out branch
# fp32: the gates come from a softmax whose last ulp may differ between
# XLA and torch (combine rel 1e-6); y and the aux through products summed
# in other orders.  bf16: the LM tests' tolerance.
Y_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
COMBINE_RTOL = 1e-6


def _cfgs(arch, dtype="float32", cf=None, mlp=None, reduced=True):
    out = []
    for get in (ref_config, get_config):
        cfg = get(arch, reduced=reduced).replace(param_dtype=dtype)
        if cf is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=cf))
        if mlp is not None:
            cfg = cfg.replace(mlp=mlp)
        out.append(cfg)
    return out


def _moe_params(cr, seed=0):
    """The reference's MoE leaves and the port's copy of them, carried as
    one position of a ``blocks`` tree through ``convert.params_from``."""
    pr = RMo.init_moe(cr, jax.random.key(seed))
    tree = {"blocks": [jax.tree_util.tree_map(np.asarray, pr)]}
    return pr, convert.params_from(tree, device="cpu")["blocks"][0]


def _inputs(cr, batch, tokens, dtype, seed=1):
    x = np.random.default_rng(seed).normal(
        size=(batch, tokens, cr.d_model)).astype(np.float32)
    if dtype == "bfloat16":
        xb = x.astype(ml_dtypes.bfloat16)
        return jnp.asarray(xb), torch.from_numpy(
            xb.view(np.int16).copy()).view(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _run_both(monkeypatch, cr, ct, pr, pt, xr, xt):
    """Both ``apply_moe`` calls, with the routing each took: the
    reference's dispatch and combine (as its products take them, the
    virtual experts' repeats folded back), its logits and probs; the
    port's ``_route`` arguments and results."""
    seen = {}
    einsum = jnp.einsum

    def spy(spec, *ops, **kw):
        if spec == "gtd,gtec->egcd":
            seen["dispatch"] = _f32(ops[1])
        elif spec == "egcd,gtec->gtd":
            seen["combine"] = _f32(ops[1])
        return einsum(spec, *ops, **kw)

    monkeypatch.setattr(jnp, "einsum", spy)
    yr, ar = RMo.apply_moe(cr, pr, xr)
    monkeypatch.setattr(jnp, "einsum", einsum)
    fac = RMo.virtual_expert_factor(cr)
    for name in ("dispatch", "combine"):
        full = seen[name]
        once = full[:, :, ::fac]
        # every virtual slice of an expert carries its expert's entries
        assert np.array_equal(full, np.repeat(once, fac, axis=2)), name
        seen[name] = once
    route = TMo._route
    mine = {}

    def spy_route(cfg, logits):
        out = route(cfg, logits)
        mine.update(logits=logits, dispatch=out[0], combine=out[1])
        return out

    monkeypatch.setattr(TMo, "_route", spy_route)
    yt, at = TMo.apply_moe(ct, pt, xt)
    monkeypatch.setattr(TMo, "_route", route)
    G, tg = mine["logits"].shape[:2]
    xg = xr.reshape(G, tg, -1)
    seen["logits"] = _f32((xg @ pr["router"].astype(xg.dtype))
                          .astype(jnp.float32))
    seen["probs"] = _f32(jax.nn.softmax(jnp.asarray(seen["logits"]), -1))
    return (yr, ar, seen), (yt, at, mine)


def _choices(probs, k):
    """Each token's experts, pass by pass, as ``apply_moe`` picks them
    (argmax of the remaining gates, the first on ties): (G, Tg, k)."""
    p = np.array(probs, dtype=np.float32)
    out = []
    for _ in range(k):
        idx = p.argmax(-1)
        out.append(idx)
        np.put_along_axis(p, idx[..., None], 0.0, axis=-1)
    return np.stack(out, -1)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_are_the_references(arch):
    """The registries hold the same MoE configs, full and reduced."""
    assert sorted(a for a in list_archs() if get_config(a).moe) == \
        sorted(a for a in ref_archs() if ref_config(a).moe) == MOE_ARCHS
    for reduced in (False, True):
        cr, ct = _cfgs(arch, reduced=reduced)
        assert dataclasses.asdict(ct.moe) == dataclasses.asdict(cr.moe)
        assert (ct.d_model, ct.d_ff, ct.mlp) == (cr.d_model, cr.d_ff,
                                                 cr.mlp)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_and_factor_match_reference(arch, reduced):
    """``capacity`` over a sweep of group sizes and capacity factors, and
    ``virtual_expert_factor`` at the reference's tp = 16 and others."""
    tgs = list(range(1, 301)) + [384, 512, 1000, 1024, 1500, 2047, 2048,
                                 4096, 32768]
    for cf in (None, 0.5, 1.0, 2.0):
        cr, ct = _cfgs(arch, cf=cf, reduced=reduced)
        assert [TMo.capacity(ct, tg) for tg in tgs] == \
            [RMo.capacity(cr, tg) for tg in tgs]
    for tp in (1, 2, 4, 8, 16, 32, 256):
        assert TMo.virtual_expert_factor(ct, tp) == \
            RMo.virtual_expert_factor(cr, tp)
    assert TMo.virtual_expert_factor(ct) == RMo.virtual_expert_factor(cr)


def test_virtual_expert_factors_of_the_served_configs():
    """Full-width grok splits each expert in two; arctic and jamba keep
    theirs; every reduced config splits in four."""
    got = {(a, r): TMo.virtual_expert_factor(get_config(a, reduced=r))
           for a in MOE_ARCHS for r in (False, True)}
    assert got == {("arctic-480b", False): 1, ("grok-1-314b", False): 2,
                   ("jamba-1.5-large-398b", False): 1,
                   ("arctic-480b", True): 4, ("grok-1-314b", True): 4,
                   ("jamba-1.5-large-398b", True): 4}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _scale(cfg, path):
    """The init scale of an MoE leaf: d^-0.5 into the ff dim, f^-0.5 out
    of it (f the full d_ff, also for a virtual slice)."""
    if path[-1] in ("w_down", "w_out"):
        return cfg.d_ff ** -0.5
    return cfg.d_model ** -0.5


@pytest.mark.parametrize("mlp", [None, "gelu"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_matches_reference_layout_and_scales(arch, mlp):
    """Same leaves, shapes and dtypes as the reference's (the router fp32
    in a bf16 tree; experts in the virtual layout), each leaf's spread its
    scale within five standard errors, in both packages."""
    cr, ct = _cfgs(arch, dtype="bfloat16", mlp=mlp)
    ref = dict(_flat(RMo.init_moe(cr, jax.random.key(0))))
    mine = dict(_flat(TMo.init_moe(ct, torch.Generator().manual_seed(0))))
    assert sorted(mine) == sorted(ref)
    fac = TMo.virtual_expert_factor(ct)
    for path, want in ref.items():
        got = mine[path]
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), path
        n = got.numel()
        for leaf in (_f32(got), _f32(want)):
            rel = float(leaf.std()) / _scale(ct, path) - 1.0
            assert abs(rel) < 5 / np.sqrt(2 * n), (path, rel)
    assert mine[("router",)].dtype == torch.float32
    expert = "w_gate" if ct.mlp == "swiglu" else "w_in"
    e = ct.moe.n_experts
    assert tuple(mine[(expert,)].shape) == (e * fac, ct.d_model,
                                            ct.d_ff // fac)
    assert any(p[0] == "residual" for p in mine) == ct.moe.dense_residual


@pytest.mark.parametrize("arch", ["arctic-480b", "grok-1-314b"])
def test_init_params_moe_tree_matches_reference(arch):
    """The whole bf16 tree: every leaf of the reference's ``init_params``,
    at its shape and dtype (MoE leaves under ``blocks[p]["moe"]``, stacked
    over groups)."""
    cr, ct = _cfgs(arch, dtype="bfloat16")
    ref = dict(_flat(jax.eval_shape(
        lambda k: RM.init_params(cr, k), jax.random.key(0))))
    mine = dict(_flat(TM.init_params(ct, torch.Generator().manual_seed(0))))
    assert sorted(mine, key=str) == sorted(ref, key=str)
    for path, want in ref.items():
        assert tuple(mine[path].shape) == want.shape, path
        assert str(mine[path].dtype).replace("torch.", "") == \
            str(want.dtype), path
    router = mine[("blocks", 0, "moe", "router")]
    assert router.dtype == torch.float32
    assert router.shape == (ct.n_layers, ct.d_model, ct.moe.n_experts)


@pytest.mark.parametrize("arch", ["arctic-480b", "grok-1-314b"])
def test_params_from_carries_moe_leaves(arch):
    """``convert.params_from`` carries a bf16 MoE tree bit for bit,
    the fp32 router inside it kept fp32."""
    cr, _ = _cfgs(arch, dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray,
                                  RM.init_params(cr, jax.random.key(3)))
    pt = convert.params_from(tree, device="cpu")
    want = dict(_flat(tree))
    got = dict(_flat(pt))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path, a in want.items():
        t = got[path]
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16)), path
        else:
            assert str(t.dtype) == f"torch.{a.dtype.name}", path
            assert np.array_equal(t.numpy(), a), path
    assert got[("blocks", 0, "moe", "router")].dtype == torch.float32
    assert got[("blocks", 0, "moe", "w_gate")].dtype == torch.bfloat16


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_fp32_matches_reference(monkeypatch, arch, case):
    """fp32: ``_route`` on the reference's own router logits gives its
    ``dispatch`` exactly (each token's expert, slot and keep) and its
    ``combine`` within rel 1e-6.  End to end the router logits are the
    port's own, which an fp32 product summed in another order puts a few
    ulps off the reference's (up to 1.2e-6 here): ``dispatch`` is still
    exact, ``combine`` within rel 1e-6 plus twice the logits' largest
    difference (a gate's relative change under a logit shift), ``y``
    within 1e-5 and the aux within 1e-6."""
    batch, tokens, cf, mlp = CASES[case]
    cr, ct = _cfgs(arch, cf=cf, mlp=mlp)
    pr, pt = _moe_params(cr)
    xr, xt = _inputs(cr, batch, tokens, "float32")
    (yr, ar, ref), (yt, at, mine) = _run_both(monkeypatch, cr, ct, pr, pt,
                                               xr, xt)
    G, tg = mine["dispatch"].shape[:2]
    assert G * tg == batch * tokens
    if case == "fallback":
        assert G == 1
    elif case == "groups":
        assert G == 3
    dispatch, combine, aux = TMo._route(ct, torch.tensor(ref["logits"]))
    assert np.array_equal(dispatch.numpy(), ref["dispatch"])
    np.testing.assert_allclose(combine.numpy(), ref["combine"],
                               rtol=COMBINE_RTOL, atol=0)
    assert np.array_equal(mine["dispatch"].numpy(), ref["dispatch"])
    shift = float(np.abs(mine["logits"].numpy() - ref["logits"]).max())
    np.testing.assert_allclose(mine["combine"].numpy(), ref["combine"],
                               rtol=COMBINE_RTOL + 2 * shift, atol=0)
    kept = int(ref["dispatch"].sum())
    if case == "drops":
        assert kept < batch * tokens * ct.moe.top_k  # the reference dropped
    assert yt.shape == yr.shape and yt.dtype == torch.float32
    np.testing.assert_allclose(_f32(yt), _f32(yr), rtol=Y_TOL["float32"],
                               atol=Y_TOL["float32"])
    assert sorted(at) == sorted(ar)
    for k in ar:
        np.testing.assert_allclose(_f32(at[k]), _f32(ar[k]), rtol=AUX_TOL,
                                   atol=AUX_TOL, err_msg=k)


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    v = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("case", ["fallback", "groups", "drops"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_bf16_routing_is_the_references_but_near_ties(
        monkeypatch, arch, case):
    """bf16 params and activations: a router logit may round one ulp
    apart between XLA's and torch's bf16 products, which can flip a top-k
    choice.  Every token whose experts differ from the reference's must
    be a near-tie (its two competing reference logits within two bf16
    ulps); a token whose slots moved without its experts changing must
    share a group with one that flipped; ``y`` is held to 2e-2 on every
    token whose routing (experts, slots, keep) agrees."""
    batch, tokens, cf, mlp = CASES[case]
    cr, ct = _cfgs(arch, dtype="bfloat16", cf=cf, mlp=mlp)
    pr, pt = _moe_params(cr)
    xr, xt = _inputs(cr, batch, tokens, "bfloat16")
    (yr, _, ref), (yt, _, mine) = _run_both(monkeypatch, cr, ct, pr, pt,
                                             xr, xt)
    k = ct.moe.top_k
    probs_t = torch.softmax(mine["logits"], -1).numpy()
    cr_, ct_ = _choices(ref["probs"], k), _choices(probs_t, k)
    flipped = (cr_ != ct_).any(-1)                               # (G, Tg)
    lg = ref["logits"]
    for g, t in zip(*np.nonzero(flipped)):
        j = int(np.argmax(cr_[g, t] != ct_[g, t]))
        a, b = cr_[g, t, j], ct_[g, t, j]
        gap = abs(lg[g, t, a] - lg[g, t, b])
        room = 2 * _bf16_ulp(max(abs(lg[g, t, a]), abs(lg[g, t, b])))
        assert gap <= room, (g, t, lg[g, t, a], lg[g, t, b])
    d_t = mine["dispatch"].numpy()
    same = (d_t == ref["dispatch"]).all(axis=(-1, -2))           # (G, Tg)
    moved = ~same & ~flipped
    assert not (moved & ~flipped.any(-1, keepdims=True)).any(), \
        "slots moved in a group where no token took another expert"
    d = yr.shape[-1]
    y_t = _f32(yt).reshape(same.shape + (d,))
    y_r = _f32(yr).reshape(same.shape + (d,))
    np.testing.assert_allclose(y_t[same], y_r[same], rtol=Y_TOL["bfloat16"],
                               atol=Y_TOL["bfloat16"])
    print(f"{arch} {case} bf16: {int(flipped.sum())} of {flipped.size} "
          f"tokens took another expert (near-ties), {int(moved.sum())} "
          f"more moved slots")


def test_route_drops_past_capacity_with_a_zero_row():
    """Every token prefers expert 0, then 1: the first C of a group take
    slots 0..C-1 of each, the rest are dropped with all-zero rows (jax's
    ``one_hot`` of an out-of-range slot; ``F.one_hot`` would refuse it)."""
    _, ct = _cfgs("grok-1-314b")
    tg = 40
    C = TMo.capacity(ct, tg)
    logits = torch.zeros((2, tg, ct.moe.n_experts))
    logits[..., 0], logits[..., 1] = 3.0, 2.0
    dispatch, combine, aux = TMo._route(ct, logits)
    assert C < tg and dispatch.shape == (2, tg, ct.moe.n_experts, C)
    for e in (0, 1):
        assert torch.equal(dispatch[:, :C, e], torch.eye(C).expand(2, C, C))
        assert not dispatch[:, C:, e].any()
    assert not dispatch[..., 2:, :].any()
    gates = torch.softmax(logits, -1)[0, 0]
    assert torch.equal(combine[:, :C, 0].sum(-1),
                       gates[0].expand(2, C))
    assert torch.equal(combine[:, :C, 1].sum(-1),
                       gates[1].expand(2, C))
    assert float(aux["moe_lb_loss"]) > 1.0  # all load on two experts


def test_repeat_experts_is_repeat_interleave():
    t = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    for fac in (1, 2, 4):
        assert torch.equal(TMo._repeat_experts(t, fac),
                           torch.repeat_interleave(t, fac, dim=2))


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


@pytest.mark.parametrize("arch, groups", [
    ("olmo-1b", 2), ("grok-1-314b", 2), ("arctic-480b", 1)])
def test_init_stack_gives_the_draws_of_stacked_groups(arch, groups):
    """``init_stack`` fills each stacked leaf group by group in the draw
    order of a per-group draw then ``torch.stack`` (one group: the leaves
    themselves), so no seed changes its numbers."""
    cfg = get_config(arch, reduced=True).replace(n_layers=groups)
    got = TT.init_stack(cfg, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    want = [_stack([TT.init_block_position(cfg, pos, gen)
                    for _ in range(TT.n_groups_of(cfg))])
            for pos in range(TT.period_of(cfg))]
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g, key=str) == sorted(w, key=str)
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        assert torch.equal(g[path], w[path]), path
        assert g[path].is_contiguous(), path
    assert TT.n_groups_of(cfg) == groups


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_scales_in_place_to_the_same_bits(dtype):
    a = TL.normal(torch.Generator().manual_seed(2), (64, 48), 0.125, dtype)
    x = torch.randn((64, 48), generator=torch.Generator().manual_seed(2))
    assert a.dtype == dtype and torch.equal(a, (x * 0.125).to(dtype))
