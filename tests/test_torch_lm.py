"""The port's LM serving path against the reference on the CPU: reduced
configs, the reference's params carried through ``convert.params_from``,
the same seeded numpy tokens.  Prefill and decode logits and the KV cache,
the slot scheduler's generated tokens and finish order, the MoE configs
(arctic-480b, grok-1-314b) in the stack and the scheduler, the families
once refused (MoE and Mamba2) serving, and the ``--workload lm`` CLI."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import frontends as RF
from repro.models import model as RM
from repro.serve import BatchScheduler as RefScheduler
from repro.serve import Request as RefRequest
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import frontends as TF
from repro_torch.models import model as TM
from repro_torch.serve import BatchScheduler, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]

# Logits: fp32 params agree to rounding (1e-4); in bf16 the reference
# rounds the probabilities to bf16 before P.V while flash keeps them fp32,
# so the two differ by design — the reference's own 2e-2
# (tests/test_model_parity.py).  The cache is bf16 on both sides.  From
# fp32 params an entry may round one bf16 ulp apart (rel 2^-7), and a
# near-zero entry carries the fp32 projection's cancellation error (abs
# 1e-5).  From bf16 params the second layer's k/v inherit the first
# layer's by-design difference through bf16 projections, so the cache is
# held to the logits' 2e-2 relative to its own scale (max |entry|).
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(arch, dtype, seed=0, **changes):
    """(reference cfg, params), (port cfg, params): the same weights; the
    reduced configs with ``param_dtype`` and ``changes`` replaced."""
    cr = ref_config(arch, reduced=True).replace(param_dtype=dtype, **changes)
    ct = get_config(arch, reduced=True).replace(param_dtype=dtype, **changes)
    pr = RM.init_params(cr, jax.random.key(seed))
    pt = convert.params_from(jax.tree_util.tree_map(np.asarray, pr),
                             device="cpu")
    return (cr, pr), (ct, pt)


def _check_cache(cache_r, cache_t, dtype, what,
                 cache_dtype=torch.bfloat16):
    """An fp32 cache holds the fp32 projections: held as the logits."""
    for cr, ct in zip(cache_r, cache_t):
        for name in ("k", "v"):
            assert ct[name].dtype == cache_dtype
            got, want = _f32(ct[name]), _f32(cr[name])
            msg = f"{what}: cache {name}"
            if cache_dtype == torch.float32:
                np.testing.assert_allclose(got, want, rtol=LOGIT_TOL[dtype],
                                           atol=LOGIT_TOL[dtype],
                                           err_msg=msg)
            elif dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                           atol=1e-5, err_msg=msg)
            else:
                err = np.abs(got - want).max()
                assert err <= 2e-2 * np.abs(want).max(), (msg, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["olmo-1b", "phi4-mini-3.8b",
                                  "qwen2.5-32b"])
def test_prefill_and_decode_match_reference(arch, dtype):
    """olmo-1b: ln_nonparam, MHA; phi4-mini: rmsnorm, GQA with one KV
    head; qwen2.5: QKV bias.  Prefill 20 tokens of 2 prompts into a
    24-row cache, then 4 decode steps."""
    (cr, pr), (ct, pt) = _pair(arch, dtype)
    B, S, S0 = 2, 24, 20
    toks = np.random.default_rng(0).integers(0, cr.vocab, (B, S))
    tol = LOGIT_TOL[dtype]
    cache_r = RM.init_cache(cr, B, S)
    cache_t = TM.init_cache(ct, B, S, device="cpu")
    lr, cache_r = RM.serve_prefill(
        cr, pr, {"tokens": jnp.asarray(toks[:, :S0], jnp.int32)}, cache_r)
    lt, cache_t = TM.serve_prefill(
        ct, pt, {"tokens": torch.as_tensor(toks[:, :S0])}, cache_t)
    assert lt.shape == (B, 1, ct.padded_vocab)
    assert lt.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(lt), _f32(lr), rtol=tol, atol=tol)
    _check_cache(cache_r, cache_t, dtype, "prefill")
    for t in range(S0, S):
        pos = np.full((B,), t)
        lr, cache_r = RM.serve_decode(
            cr, pr, jnp.asarray(toks[:, t:t + 1], jnp.int32),
            jnp.asarray(pos, jnp.int32), cache_r)
        lt, cache_t = TM.serve_decode(
            ct, pt, torch.as_tensor(toks[:, t:t + 1]), torch.as_tensor(pos),
            cache_t)
        np.testing.assert_allclose(_f32(lt), _f32(lr), rtol=tol, atol=tol,
                                   err_msg=f"decode step {t}")
        _check_cache(cache_r, cache_t, dtype, f"decode step {t}")


@pytest.mark.parametrize("prefill", [20, 64])
@pytest.mark.parametrize("arch", ["arctic-480b", "grok-1-314b"])
def test_moe_prefill_and_decode_match_reference(arch, prefill):
    """The MoE channel in the stack, fp32 params: arctic-480b (dense
    residual beside 4 experts) and grok-1-314b (4 experts split in 4
    virtual ones each).  Two prompts prefilled together route their
    2 x ``prefill`` tokens as one batch: 40 tokens fall back to one group
    (40 % 64 != 0), 128 make two groups of 64.  Then 4 decode steps,
    each routing the 2 slots' tokens together.

    The cache is kept in the param dtype, as the paligemma test keeps it:
    a bf16 cache from fp32 params rounds an entry one ulp apart now and
    then, and at 64 tokens the decode steps that read such entries put
    arctic's logits 1.5e-4 apart, past the fp32 1e-4; from an fp32 cache
    the two agree to 1e-6 at every step."""
    (cr, pr), (ct, pt) = _pair(arch, "float32")
    B, S0 = 2, prefill
    S = S0 + 4
    toks = np.random.default_rng(4).integers(0, cr.vocab, (B, S))
    tol = LOGIT_TOL["float32"]
    cache_r = RM.init_cache(cr, B, S, dtype=jnp.float32)
    cache_t = TM.init_cache(ct, B, S, dtype=torch.float32, device="cpu")
    lr, cache_r = RM.serve_prefill(
        cr, pr, {"tokens": jnp.asarray(toks[:, :S0], jnp.int32)}, cache_r)
    lt, cache_t = TM.serve_prefill(
        ct, pt, {"tokens": torch.as_tensor(toks[:, :S0])}, cache_t)
    assert lt.shape == (B, 1, ct.padded_vocab)
    np.testing.assert_allclose(_f32(lt), _f32(lr), rtol=tol, atol=tol)
    _check_cache(cache_r, cache_t, "float32", "prefill", torch.float32)
    for t in range(S0, S):
        pos = np.full((B,), t)
        lr, cache_r = RM.serve_decode(
            cr, pr, jnp.asarray(toks[:, t:t + 1], jnp.int32),
            jnp.asarray(pos, jnp.int32), cache_r)
        lt, cache_t = TM.serve_decode(
            ct, pt, torch.as_tensor(toks[:, t:t + 1]), torch.as_tensor(pos),
            cache_t)
        np.testing.assert_allclose(_f32(lt), _f32(lr), rtol=tol, atol=tol,
                                   err_msg=f"decode step {t}")
        _check_cache(cache_r, cache_t, "float32", f"decode step {t}",
                     torch.float32)


def test_decode_past_the_cache_clamps_like_reference():
    """A slot whose position runs past the cache (a retired slot keeps
    advancing in the scheduler) writes the cache's last row, as the
    reference's ``dynamic_update_slice`` clamps its start, and attends
    over every row."""
    (cr, pr), (ct, pt) = _pair("olmo-1b", "float32")
    B, S = 2, 8
    rng = np.random.default_rng(3)
    k0 = rng.normal(size=(cr.n_layers, B, S, cr.n_kv_heads, cr.head_dim))
    cache_r = [{n: jnp.asarray(k0, jnp.bfloat16) for n in "kv"}
               for _ in RM.init_cache(cr, B, S)]
    cache_t = [{n: torch.as_tensor(k0, dtype=torch.bfloat16) for n in "kv"}
               for _ in range(len(cache_r))]
    tok, pos = np.array([[7], [11]]), np.array([S + 1, 3])
    lr, cache_r = RM.serve_decode(cr, pr, jnp.asarray(tok, jnp.int32),
                                  jnp.asarray(pos, jnp.int32), cache_r)
    lt, cache_t = TM.serve_decode(ct, pt, torch.as_tensor(tok),
                                  torch.as_tensor(pos), cache_t)
    np.testing.assert_allclose(_f32(lt), _f32(lr), rtol=1e-4, atol=1e-4)
    _check_cache(cache_r, cache_t, "float32", "decode past the cache")


def test_prefix_embeds_prefill_matches_reference():
    """The frontend branch of ``_assemble_inputs`` (musicgen: a prefix of
    frame embeddings, GELU MLP), fp32, prefix embeddings handed to both."""
    (cr, pr), (ct, pt) = _pair("musicgen-medium", "float32")
    rng = np.random.default_rng(1)
    B, S_tok = 2, 10
    toks = rng.integers(0, cr.vocab, (B, S_tok))
    prefix = (rng.normal(size=(B, cr.frontend_len, cr.d_model)) * 0.02
              ).astype(np.float32)
    S = cr.frontend_len + S_tok
    lr, cache_r = RM.serve_prefill(
        cr, pr, {"tokens": jnp.asarray(toks, jnp.int32),
                 "prefix_embeds": jnp.asarray(prefix)},
        RM.init_cache(cr, B, S))
    lt, cache_t = TM.serve_prefill(
        ct, pt, {"tokens": torch.as_tensor(toks),
                 "prefix_embeds": torch.as_tensor(prefix)},
        TM.init_cache(ct, B, S, device="cpu"))
    np.testing.assert_allclose(_f32(lt), _f32(lr), rtol=1e-4, atol=1e-4)
    _check_cache(cache_r, cache_t, "float32", "prefill")


@pytest.mark.parametrize("head_dim", [None, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paligemma_prefix_prefill_and_decode_match_reference(dtype,
                                                            head_dim):
    """paligemma-3b's backbone as the reference serves a frontend config
    (``serve_prefill`` with ``prefix_embeds``, then ``serve_decode``):
    MQA (1 KV head), rmsnorm_1p, tanh-GELU, tied embeddings.  A prefix of
    16 patch embeddings and 12 tokens for 2 prompts, then 4 decode steps;
    once at the reduced head_dim 32 and once at paligemma's 256, so hd 256
    runs through the whole model.

    The cache is kept in the param dtype.  A bf16 cache from fp32 params
    rounds an entry one ulp apart now and then (``_check_cache``), and one
    such k entry moves this model's logits by up to ~5e-4, past the fp32
    1e-4; from the same cache the two decodes agree to ~1e-6.  For the
    same reason in bf16 (where prefill's P.V differs by design) each
    decode step starts from the reference's cache, carried bit for bit."""
    changes = {} if head_dim is None else {"head_dim": head_dim}
    (cr, pr), (ct, pt) = _pair("paligemma-3b", dtype, **changes)
    assert ct.n_kv_heads == 1 and ct.head_dim == (head_dim or 32)
    rng = np.random.default_rng(4)
    B, S_tok, steps = 2, 12, 4
    F = cr.frontend_len
    toks = rng.integers(0, cr.vocab, (B, S_tok + steps))
    prefix = (rng.normal(size=(B, F, cr.d_model)) * 0.02).astype(np.float32)
    S = F + S_tok + steps
    tol = LOGIT_TOL[dtype]
    cache_dt = getattr(torch, dtype)
    lr, cache_r = RM.serve_prefill(
        cr, pr, {"tokens": jnp.asarray(toks[:, :S_tok], jnp.int32),
                 "prefix_embeds": jnp.asarray(prefix)},
        RM.init_cache(cr, B, S, dtype=jnp.dtype(dtype)))
    lt, cache_t = TM.serve_prefill(
        ct, pt, {"tokens": torch.as_tensor(toks[:, :S_tok]),
                 "prefix_embeds": torch.as_tensor(prefix)},
        TM.init_cache(ct, B, S, dtype=cache_dt, device="cpu"))
    assert lt.shape == (B, 1, ct.padded_vocab)
    np.testing.assert_allclose(_f32(lt), _f32(lr), rtol=tol, atol=tol)
    _check_cache(cache_r, cache_t, dtype, "prefill", cache_dt)
    for i in range(steps):
        pos = np.full((B,), F + S_tok + i)
        tok = toks[:, S_tok + i:S_tok + i + 1]
        if dtype == "bfloat16":
            cache_t = [{n: torch.as_tensor(_f32(c[n])).to(cache_dt)
                        for n in ("k", "v")} for c in cache_r]
        lr, cache_r = RM.serve_decode(cr, pr, jnp.asarray(tok, jnp.int32),
                                      jnp.asarray(pos, jnp.int32), cache_r)
        lt, cache_t = TM.serve_decode(ct, pt, torch.as_tensor(tok),
                                      torch.as_tensor(pos), cache_t)
        np.testing.assert_allclose(_f32(lt), _f32(lr), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        _check_cache(cache_r, cache_t, dtype, f"decode step {i}", cache_dt)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-medium",
                                  "olmo-1b"])
def test_frontend_embed_shape_matches_reference(arch, reduced):
    for batch in (1, 3):
        assert TF.frontend_embed_shape(get_config(arch, reduced=reduced),
                                       batch) == RF.frontend_embed_shape(
            ref_config(arch, reduced=reduced), batch)


def test_synth_frontend_embeds_shape_dtype_and_scale():
    """paligemma-3b's 256 patch rows at d_model 2048 in the param dtype,
    N(0, 1) x 0.02 like the reference's stand-in (whose draws are
    jax.random's, so only shape, dtype and spread are compared), the same
    bits from the same seed."""
    cfg = get_config("paligemma-3b")
    x = TF.synth_frontend_embeds(cfg, 2, torch.Generator().manual_seed(0))
    want = RF.synth_frontend_embeds(ref_config("paligemma-3b"), 2,
                                    jax.random.key(0))
    assert tuple(x.shape) == want.shape == (2, 256, 2048)
    assert x.dtype == getattr(torch, cfg.param_dtype) == torch.bfloat16
    assert str(want.dtype) == cfg.param_dtype
    xf = x.float()
    assert abs(float(xf.std()) / 0.02 - 1.0) < 0.01
    assert abs(float(xf.mean())) < 1e-4
    assert abs(float(np.asarray(want, np.float32).std()) / 0.02 - 1.0) < 0.01
    again = TF.synth_frontend_embeds(cfg, 2, torch.Generator().manual_seed(0))
    other = TF.synth_frontend_embeds(cfg, 2, torch.Generator().manual_seed(1))
    assert torch.equal(x, again) and not torch.equal(x, other)
    with pytest.raises(ValueError, match="no frontend"):
        TF.synth_frontend_embeds(get_config("olmo-1b", reduced=True), 1,
                                 torch.Generator())


# ---------------------------------------------------------------------------
# The slot scheduler: the reference's three tests, both packages on the same
# fp32 weights and prompts.
# ---------------------------------------------------------------------------


def _schedulers(seed, slots, max_seq, arch="olmo-1b"):
    (cr, pr), (ct, pt) = _pair(arch, "float32", seed)
    return (RefScheduler(cr, pr, batch_slots=slots, max_seq=max_seq,
                         eos_id=-1),
            BatchScheduler(ct, pt, batch_slots=slots, max_seq=max_seq,
                           eos_id=-1), ct)


def _finished(sched):
    return [(r.rid, r.generated, r.done) for r in sched.finished]


def test_scheduler_generates_and_recycles():
    ref, port, cfg = _schedulers(0, 2, 48)
    for s in (ref, port):
        for rid in range(4):  # more requests than slots -> recycling
            s.submit((RefRequest if s is ref else Request)(
                rid=rid, prompt=[5, 6, 7], max_new=4))
    done = port.run_until_drained(max_ticks=64)
    ref.run_until_drained(max_ticks=64)
    assert len(done) == 4
    for req in done:
        assert req.done and len(req.generated) >= 4
        assert all(0 <= t < cfg.padded_vocab for t in req.generated)
    assert _finished(port) == _finished(ref)


def test_scheduler_slot_recycling_under_oversubscription():
    """3x more requests than slots: slots are reused, admissions follow
    queue order, the scheduler drains — tick for tick as the reference."""
    ref, port, _ = _schedulers(2, 2, 48)
    orders = []
    for s, req in ((ref, RefRequest), (port, Request)):
        for rid in range(6):
            s.submit(req(rid=rid, prompt=[3, 4], max_new=2 + rid % 3))
        ticks, admitted, seen = 0, [], set()
        while s.queue or any(x is not None for x in s.slots):
            for x in s.slots:
                if x is not None and x.rid not in seen:
                    seen.add(x.rid)
                    admitted.append(x.rid)
            s.tick()
            ticks += 1
            assert ticks < 64
        orders.append((admitted, ticks))
    assert orders[1] == orders[0]
    assert orders[1][0][:2] == [0, 1]
    assert sorted(r.rid for r in port.finished) == list(range(6))
    assert all(x is None for x in port.slots) and not port.queue
    assert _finished(port) == _finished(ref)


@pytest.mark.parametrize("arch", ["arctic-480b", "grok-1-314b"])
def test_moe_scheduler_matches_reference(arch):
    """The slot scheduler on the MoE configs, fp32: each admission
    prefills one prompt alone (its tokens route together; 70 and 64
    tokens of a 64-token group size take the fallback and one group), and
    every decode tick routes all 3 slots' tokens together, the slots with
    no request too, as the reference's tick does: MoE capacity couples a
    step's tokens, so the batch's make-up is part of the result.  The
    finished tokens and order are the reference's."""
    ref, port, cfg = _schedulers(6, 3, 96, arch)
    prompts = [list(np.random.default_rng(7).integers(0, cfg.vocab, n))
               for n in (5, 70, 9, 64, 12)]
    for s, req in ((ref, RefRequest), (port, Request)):
        for rid, pr in enumerate(prompts):
            s.submit(req(rid=rid, prompt=[int(t) for t in pr],
                         max_new=3 + rid % 3))
    done = port.run_until_drained(max_ticks=64)
    ref.run_until_drained(max_ticks=64)
    assert len(done) == len(prompts) and all(r.done for r in done)
    assert _finished(port) == _finished(ref)


def test_scheduler_tick_counts():
    ref, port, _ = _schedulers(1, 2, 32)
    launches = FA.flash_attention.launches
    assert port.tick() == ref.tick() == 0  # nothing queued
    port.submit(Request(rid=0, prompt=[1, 2], max_new=2))
    ref.submit(RefRequest(rid=0, prompt=[1, 2], max_new=2))
    assert port.tick() == ref.tick() == 1  # admitted + advanced
    assert [r.generated for r in port.slots if r] == \
        [r.generated for r in ref.slots if r]
    assert FA.flash_attention.launches == launches  # CPU: plain version


# ---------------------------------------------------------------------------
# What this slice does not serve, and the CLI.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,item", [
    ("mamba2-130m", "item 9, 'Mamba2 mixer'"),
    ("jamba-1.5-large-398b", "item 9, 'Mamba2 mixer'"),
    ("arctic-480b", "item 8, 'MoE channel'"),
    ("grok-1-314b", "item 8, 'MoE channel'")])
def test_unported_families_name_their_roadmap_item(arch, item):
    """The families whose ROADMAP Queue A item once raised here (the
    Mamba2 mixer, item 9; the MoE channel, item 8) are ported: each inits,
    gets its cache (a Mamba position's ``{"h", "conv"}``: h fp32, conv in
    the cache dtype) and serves a request, and ROADMAP.md marks the item
    landed."""
    import re

    cfg = get_config(arch, reduced=True)
    num, name = re.match(r"item (\d+), '(.+)'", item).groups()
    assert re.search(rf"^{num}\. \*\*{re.escape(name)}:\*\* landed",
                     (ROOT / "ROADMAP.md").read_text(), re.M), item
    gen = torch.Generator().manual_seed(0)
    params = TM.init_params(cfg, gen)
    cache = TM.init_cache(cfg, 1, 8, device="cpu")
    for pos, c in enumerate(cache):
        if "k" in c:
            assert tuple(c["k"].shape) == (cfg.n_layers // len(cache), 1,
                                           8, cfg.n_kv_heads, cfg.head_dim)
            continue
        m = cfg.mamba
        groups = cfg.n_layers // len(cache)
        assert set(c) == {"h", "conv"}
        assert tuple(c["h"].shape) == (groups, 1, m.n_heads, m.d_state,
                                       m.head_dim)
        assert tuple(c["conv"].shape) == (
            groups, 1, m.d_conv - 1, m.d_inner + 2 * m.n_groups * m.d_state)
        assert c["h"].dtype == torch.float32
        assert c["conv"].dtype == torch.bfloat16
        assert params["blocks"][pos]["mamba"]["A_log"].dtype == torch.float32
    if cfg.moe is not None:
        moe_pos = next(b for b in params["blocks"] if "moe" in b)
        assert moe_pos["moe"]["router"].dtype == torch.float32
    sched = BatchScheduler(cfg, params, batch_slots=1, max_seq=8,
                           eos_id=-1)
    sched.submit(Request(rid=0, prompt=[3, 4, 5], max_new=2))
    (req,) = sched.run_until_drained(max_ticks=8)
    assert req.done and len(req.generated) == 3
    assert all(0 <= t < cfg.padded_vocab for t in req.generated)


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-medium"])
def test_frontend_scheduler_names_its_roadmap_item(arch):
    cfg = get_config(arch, reduced=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue C, 'The frontend raise'"):
        BatchScheduler(cfg, params, batch_slots=1, max_seq=32)


def test_init_params_follows_reference_layout_and_scales():
    """Same leaves, shapes and dtypes as the reference's pytree; the
    projections' spread is the reference's ``d ** -0.5``."""
    (cr, pr), _ = _pair("qwen2.5-32b", "float32")
    ct = get_config("qwen2.5-32b", reduced=True).replace(
        param_dtype="float32")
    pt = TM.init_params(ct, torch.Generator().manual_seed(0))
    ref_leaves = jax.tree_util.tree_flatten_with_path(pr)[0]
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            flat[path] = t
    walk(pt, ())
    assert len(flat) == len(ref_leaves)
    for path, leaf in ref_leaves:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        assert tuple(flat[key].shape) == leaf.shape, key
        assert flat[key].dtype == torch.float32
    wq = pt["blocks"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * ct.d_model ** 0.5 - 1.0) < 0.05


def test_serve_cli_lm_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "lm", "--reduced", "--device", "cpu"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 6 requests, 78 tokens" in out.stdout
    assert out.stdout.count("req ") == 6


def test_serve_cli_defaults_to_the_lm_workload():
    """With no ``--workload`` the port's CLI serves the LM, as the
    reference's does."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 6 requests, 78 tokens" in out.stdout


@pytest.mark.parametrize("arch", ["arctic-480b", "grok-1-314b"])
def test_serve_cli_lm_serves_the_moe_configs(arch):
    """``--workload lm --arch <moe arch> --reduced --device cpu`` serves
    all six requests through the MoE channel."""
    _serve_cli_six(arch)


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_serve_cli_lm_serves_the_mamba_configs(arch):
    """``--workload lm --arch <arch> --reduced --device cpu`` serves all
    six requests through the Mamba2 mixer (prompts of 4-11 tokens, inside
    the chunk contract); jamba through its attention and MoE positions
    too."""
    _serve_cli_six(arch)


def _serve_cli_six(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "lm", "--arch", arch, "--reduced", "--device", "cpu"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 6 requests, 78 tokens" in out.stdout
    assert out.stdout.count("req ") == 6
