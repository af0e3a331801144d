"""The port's LM serving path against the reference on the CPU: reduced
configs, the reference's params carried through ``convert.params_from``,
the same seeded numpy tokens.  Prefill and decode logits and the KV cache,
the slot scheduler's generated tokens and finish order, the families not
ported yet, and the ``--workload lm`` CLI."""
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
from repro.models import model as RM
from repro.serve import BatchScheduler as RefScheduler
from repro.serve import Request as RefRequest
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
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


def _pair(arch, dtype, seed=0):
    """(reference cfg, params), (port cfg, params): the same weights."""
    cr = ref_config(arch, reduced=True).replace(param_dtype=dtype)
    ct = get_config(arch, reduced=True).replace(param_dtype=dtype)
    pr = RM.init_params(cr, jax.random.key(seed))
    pt = convert.params_from(jax.tree_util.tree_map(np.asarray, pr),
                             device="cpu")
    return (cr, pr), (ct, pt)


def _check_cache(cache_r, cache_t, dtype, what):
    for cr, ct in zip(cache_r, cache_t):
        for name in ("k", "v"):
            assert ct[name].dtype == torch.bfloat16
            got, want = _f32(ct[name]), _f32(cr[name])
            msg = f"{what}: cache {name}"
            if dtype == "float32":
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


# ---------------------------------------------------------------------------
# The slot scheduler: the reference's three tests, both packages on the same
# fp32 weights and prompts.
# ---------------------------------------------------------------------------


def _schedulers(seed, slots, max_seq):
    (cr, pr), (ct, pt) = _pair("olmo-1b", "float32", seed)
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
    cfg = get_config(arch, reduced=True)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue A {item}"):
        TM.init_params(cfg, gen)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue A {item}"):
        TM.init_cache(cfg, 1, 8, device="cpu")


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-medium"])
def test_frontend_scheduler_names_its_roadmap_item(arch):
    cfg = get_config(arch, reduced=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue A item 10, 'Frontends'"):
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
