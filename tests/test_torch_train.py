"""The port's training path on the CPU: the optimizer against the
reference's on the same trees, ``train_step`` against the reference's
(one microbatch and two; every telemetry mode), the synthetic stream, and
the reference's own integration checks on the port alone (reduced olmo-1b
descends over 30 steps; a restore-and-replay after a checkpoint repeats
the losses).

Tolerances: the optimizer's outputs within 1e-6 of each leaf's scale (its
max |x|) in fp32.  ``train_step`` (one step, fp32): loss, ``grad_norm``,
``lr`` and the telemetry within rel 1e-5, ``m`` and ``v`` within 1e-5 of
each leaf's scale.  New params within 1e-5 of each leaf's scale wherever
the gradient exceeds 1e-4 of its leaf's largest: Adam's first step moves
each element by ``lr * g / (|g| + eps)``, so where |g| lies at the level
of the grads' own rounding (a few 1e-6 of the leaf's scale apart between
the packages) the two steps may differ by up to ``2 * lr``, and there they
are held to that bound."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import data as RD
from repro.train import optimizer as RO
from repro.train import train_step as RS
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as TD
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TS
from repro_torch.core.tree import tree_leaves, tree_map, tree_paths

import _torch_train_cases as C

OPT_TOL = 1e-6
STEP_TOL = 1e-5
SMALL_GRAD = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_leaves(want, got, tol, what=""):
    for (path, a), b in zip(tree_paths(_np_tree(want)), tree_leaves(got)):
        a, b = np.asarray(a, np.float32), C.f32(b)
        assert a.shape == b.shape, (what, path)
        err = np.abs(a - b).max() if a.size else 0.0
        assert err <= tol * max(np.abs(a).max(), 1e-30), (what, path, err)


# ---------------------------------------------------------------------------
# The optimizer.
# ---------------------------------------------------------------------------


def _trees(seed, dtype="float32"):
    """Params, grads and a warm optimizer state (moments of two earlier
    steps) as numpy trees of the reference's shape."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}, "e": [(4,)]}

    def draw(scale, dt="float32"):
        return jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s) * scale).astype(dt), shapes,
            is_leaf=lambda x: isinstance(x, tuple))

    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(dtype), draw(1.0))
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(dtype), draw(0.3))
    m = jax.tree_util.tree_map(jnp.asarray, draw(0.01))
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(np.abs(a)), draw(1e-3))
    state = RO.OptState(step=jnp.asarray(2, jnp.int32), m=m, v=v)
    return params, grads, state


def _port(tree):
    return convert.params_from({"blocks": [_np_tree(tree)]},
                               device="cpu")["blocks"][0]


@pytest.mark.parametrize("clip", [100.0, 0.5], ids=["no-clip", "clipped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype, clip):
    """One AdamW step from a warm state on the same trees: new params (in
    their dtype), moments, step, ``grad_norm`` and ``lr``; bf16 params and
    grads are rounded where the reference rounds them (the clip casts back,
    the update upcasts)."""
    p, g, st = _trees(0, dtype)
    cfg = dict(lr=1e-2, warmup_steps=4, total_steps=50, weight_decay=0.1,
               clip_norm=clip)
    want_p, want_s, want_m = RO.adamw_update(RO.OptimizerConfig(**cfg), p,
                                             g, st)
    tst = convert.opt_state_from(_np_tree(st), device="cpu")
    got_p, got_s, got_m = TO.adamw_update(TO.OptimizerConfig(**cfg),
                                          _port(p), _port(g), tst)
    assert int(got_s.step) == int(want_s.step) == 3
    assert got_s.step.dtype == torch.int32
    for k in ("grad_norm", "lr"):
        assert float(got_m[k]) == pytest.approx(float(want_m[k]),
                                                rel=OPT_TOL)
    for leaf, want in zip(tree_leaves(got_p), tree_leaves(_np_tree(want_p))):
        assert str(leaf.dtype).replace("torch.", "") == str(want.dtype)
    # a bf16 param moves by whole bf16 ulps: its one-ulp roundings apart
    # are the only gaps allowed there
    _close_leaves(want_p, got_p, OPT_TOL if dtype == "float32" else 2 ** -7,
                  "params")
    _close_leaves(want_s.m, got_s.m, OPT_TOL, "m")
    _close_leaves(want_s.v, got_s.v, OPT_TOL, "v")


@pytest.mark.parametrize("max_norm", [0.1, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, g, _ = _trees(1)
    want, wn = RO.clip_by_global_norm(g, max_norm)
    got, gn = TO.clip_by_global_norm(_port(g), max_norm)
    assert float(gn) == pytest.approx(float(wn), rel=OPT_TOL)
    assert float(TO.global_norm(_port(g))) == pytest.approx(
        float(RO.global_norm(g)), rel=OPT_TOL)
    _close_leaves(want, got, OPT_TOL)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_lr_schedule_matches_reference(step):
    for cfg in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                     min_lr_ratio=0.1), dict(lr=3e-4, warmup_steps=0)):
        want = RO.lr_schedule(RO.OptimizerConfig(**cfg), jnp.int32(step))
        got = TO.lr_schedule(TO.OptimizerConfig(**cfg),
                             torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=OPT_TOL,
                                           abs=1e-12)


# The reference's own cases (tests/test_train_substrate.py) on the port.

def test_adamw_descends_quadratic():
    cfg = TO.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=1000,
                             weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = TO.init_opt_state(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}      # d/dw |w|^2
        params, state, m = TO.adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.5


def test_clip_norm():
    tree = {"a": torch.tensor([3.0, 4.0])}  # norm 5
    clipped, norm = TO.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0)


def test_lr_schedule_shape():
    cfg = TO.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_ratio=0.1)
    at = lambda s: float(TO.lr_schedule(cfg, torch.tensor(s)))
    assert at(0) == pytest.approx(0.0)
    assert at(10) == pytest.approx(1.0)
    assert at(100) == pytest.approx(0.1)


def test_opt_state_init_and_abstract():
    """fp32 zero moments beside each param (``m`` and ``v`` distinct
    tensors), an int32 step; the abstract state on ``meta``, as the
    reference's shapes."""
    (cr, pr), (ct, pt) = C.pair("olmo-1b", "bfloat16")
    st = TO.init_opt_state(pt)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for m, v, p in zip(tree_leaves(st.m), tree_leaves(st.v),
                       tree_leaves(pt)):
        assert m.dtype == v.dtype == torch.float32 and m.shape == p.shape
        assert m.data_ptr() != v.data_ptr() and not m.any()
    from repro_torch.models import model as TM
    ab = TO.abstract_opt_state(TM.abstract_params(ct))
    want = RO.abstract_opt_state(jax.eval_shape(
        lambda: jax.tree_util.tree_map(jnp.asarray, pr)))
    assert ab.step.device.type == "meta" and ab.step.dtype == torch.int32
    for (path, a), (_, w) in zip(tree_paths(ab.m), tree_paths(want.m)):
        assert a.device.type == "meta" and a.dtype == torch.float32
        assert tuple(a.shape) == tuple(w.shape), path


# ---------------------------------------------------------------------------
# train_step against the reference's.
# ---------------------------------------------------------------------------


def _step_pair(arch, microbatches, mode, lr=1e-3):
    kw = dict(microbatches=microbatches, telemetry_exact=True,
              telemetry_mode=mode, isla_rate=0.25)
    opt = dict(lr=lr, warmup_steps=2, total_steps=50)
    return (RS.TrainConfig(opt=RO.OptimizerConfig(**opt), **kw),
            TS.TrainConfig(opt=TO.OptimizerConfig(**opt), **kw))


# every telemetry mode on olmo-1b; the MoE config (its moe_lb_loss metric
# and its aux terms in the loss) in the default mode
STEP_CASES = [("olmo-1b", mb, mode) for mb in (1, 2)
              for mode in ("isla", "exact", "trimmed_exact", "off")] + [
    ("grok-1-314b", mb, "isla") for mb in (1, 2)]


@pytest.mark.parametrize("arch, microbatches, mode", STEP_CASES)
def test_train_step_matches_reference(arch, microbatches, mode):
    """One step from the same weights, optimizer state and batch (fp32):
    new params, ``m``, ``v``, the step, and every metric the reference
    reports (loss, ``grad_norm``, ``lr``, ``moe_lb_loss`` for one
    microbatch, and the telemetry of the mode)."""
    (cr, pr), (ct, pt) = C.pair(arch, "float32")
    br, bt = C.batch(cr, b=4)
    rcfg, tcfg = _step_pair(arch, microbatches, mode)
    ro = RO.init_opt_state(pr)
    to = convert.opt_state_from(_np_tree(ro), device="cpu")
    want_p, want_o, want_m = jax.jit(
        lambda p, o, b: RS.train_step(cr, rcfg, p, o, b))(pr, ro, br)
    got_p, got_o, got_m = TS.train_step(ct, tcfg, pt, to, bt)
    assert sorted(got_m) == sorted(want_m)
    for k, w in want_m.items():
        assert got_m[k].dim() == 0 and not got_m[k].requires_grad, k
        assert float(got_m[k]) == pytest.approx(float(w), rel=STEP_TOL), k
    assert int(got_o.step) == int(want_o.step) == 1
    _close_leaves(want_o.m, got_o.m, STEP_TOL, "m")
    _close_leaves(want_o.v, got_o.v, STEP_TOL, "v")
    grads = [np.abs(np.asarray(m, np.float32)) / (1 - rcfg.opt.b1)
             for m in tree_leaves(_np_tree(want_o.m))]
    for (path, w), g, got, old in zip(tree_paths(_np_tree(want_p)), grads,
                                      tree_leaves(got_p), tree_leaves(pt)):
        w, got = np.asarray(w, np.float32), C.f32(got)
        gap = np.abs(got - w)
        big = g > SMALL_GRAD * g.max()
        assert gap[big].max(initial=0) <= STEP_TOL * np.abs(w).max(), path
        assert gap.max() <= 2 * rcfg.opt.lr * 1.0001, path
    # the inputs are left as they were (a functional step)
    for a, b in zip(tree_leaves(pt), tree_leaves(C.pair(arch, "float32")[1][1])):
        assert torch.equal(a, b)


def test_train_step_makes_one_fold_a_step(monkeypatch):
    """The default telemetry estimates the loss through one Phase 1 fold
    (``ops.isla_moments``) a step, on the detached per-token losses."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.isla_moments

    def spy(x, *a, **kw):
        calls.append(x.requires_grad)
        return real(x, *a, **kw)

    monkeypatch.setattr(ops, "isla_moments", spy)
    _, (ct, pt) = C.pair("olmo-1b", "float32")
    _, bt = C.batch(ct, b=4)
    st = TO.init_opt_state(pt)
    for i in range(3):
        pt, st, m = TS.train_step(ct, TS.TrainConfig(), pt, st, bt)
        assert calls == [False] * (i + 1)
        assert "loss_mean_isla" in m and "loss_mean_exact" not in m
    TS.train_step(ct, TS.TrainConfig(telemetry_mode="off"), pt, st, bt)
    TS.train_step(ct, TS.TrainConfig(isla_telemetry=False), pt, st, bt)
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# The synthetic stream.
# ---------------------------------------------------------------------------


def test_data_deterministic_replay():
    """The reference's case on the port: a batch is a function of (seed,
    step) alone; shapes and the vocab range hold."""
    cfg = get_config("olmo-1b", reduced=True)
    s1 = TD.SyntheticStream(cfg, batch=4, seq=32, device="cpu")
    s2 = TD.SyntheticStream(cfg, batch=4, seq=32, device="cpu")
    b1, b2 = s1.batch_at(17), s2.batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(b1["tokens"], s1.batch_at(18)["tokens"])
    assert b1["tokens"].shape == b1["labels"].shape == (4, 32)
    assert int(b1["tokens"].max()) < cfg.vocab and int(b1["tokens"].min()) >= 0
    # labels are the next tokens
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    # another data seed, another stream
    s3 = TD.SyntheticStream(cfg, batch=4, seq=32, device="cpu",
                            data_cfg=TD.DataConfig(seed=1))
    assert not torch.equal(b1["tokens"], s3.batch_at(17)["tokens"])


def test_data_frontend_prefix():
    """A frontend config's batch: the tokens and labels cut to S - F and F
    prefix embeddings in the param dtype, replayed exactly."""
    cfg = get_config("paligemma-3b", reduced=True)
    s = TD.SyntheticStream(cfg, batch=2, seq=48, device="cpu")
    b, b2 = s.batch_at(3), s.batch_at(3)
    F = cfg.frontend_len
    assert b["tokens"].shape == b["labels"].shape == (2, 48 - F)
    assert b["prefix_embeds"].shape == (2, F, cfg.d_model)
    assert b["prefix_embeds"].dtype == torch.bfloat16
    assert torch.equal(b["prefix_embeds"], b2["prefix_embeds"])


def test_data_is_drawn_on_the_cpu_whatever_the_device(monkeypatch):
    """The batch is drawn on the CPU and only then moved: the stream asks
    no device for its draws, so a batch is the same on any device."""
    cfg = get_config("olmo-1b", reduced=True)
    moved = []
    real = torch.Tensor.to

    def to(self, *a, **kw):
        moved.append((a, kw))
        return real(self, *a, **kw)

    s = TD.SyntheticStream(cfg, batch=2, seq=16, device="cpu")
    monkeypatch.setattr(torch.Tensor, "to", to)
    b = s.batch_at(0)
    monkeypatch.setattr(torch.Tensor, "to", real)
    assert all(t.device.type == "cpu" for t in b.values())
    assert moved and all(a == (s.device,) for a, _ in moved)
    toks, use = s.draw(0)
    assert torch.equal(toks[:, :-1], b["tokens"])


STAT_BATCH, STAT_SEQ, STAT_STEPS = 64, 64, 100


def _stream_stats(tokens, use):
    toks = np.concatenate(tokens).ravel()
    top = np.bincount(toks).argmax()
    return (top, float((toks == top).mean()),
            float(np.concatenate(use).mean()))


def test_stream_statistics_match_the_references():
    """The structure is the reference's: over 100 batches of 64 x 65 tokens
    the most frequent token is rank 0 in both streams, its frequency
    within 5% of the reference stream's, and the share of positions inside
    a copied motif within 5% (each estimate's standard error ~1%).  The
    reference's motif positions are recomputed from its own keys."""
    cfg_r = C.ref_config("olmo-1b", reduced=True)
    cfg = get_config("olmo-1b", reduced=True)
    ref = RD.SyntheticStream(cfg_r, batch=STAT_BATCH, seq=STAT_SEQ)
    mine = TD.SyntheticStream(cfg, batch=STAT_BATCH, seq=STAT_SEQ,
                              device="cpu")
    dc = ref.dc
    B, S, L = STAT_BATCH, STAT_SEQ + 1, dc.motif_len
    r_toks, r_use, t_toks, t_use = [], [], [], []
    for step in range(STAT_STEPS):
        b = ref.batch_at(step)
        # the reference's own draws of its motif rows and windows
        key = jax.random.fold_in(jax.random.key(dc.seed), step)
        _, k2, _, k4 = jax.random.split(key, 4)
        starts = np.asarray(jax.random.randint(k2, (B,), L,
                                               max(S - L, L + 1)))
        pos = np.arange(S)[None, :]
        in_motif = (pos >= starts[:, None]) & (pos < starts[:, None] + L)
        use = in_motif & (np.asarray(jax.random.uniform(k4, (B, 1)))
                          < dc.motif_prob)
        r_toks.append(np.asarray(b["tokens"]))
        r_use.append(use)
        toks, u = mine.draw(step)
        t_toks.append(toks[:, :-1].numpy())
        t_use.append(u.numpy())
    r_top, r_freq, r_share = _stream_stats(r_toks, r_use)
    t_top, t_freq, t_share = _stream_stats(t_toks, t_use)
    assert r_top == t_top == 0
    assert t_freq == pytest.approx(r_freq, rel=0.05)
    assert t_share == pytest.approx(r_share, rel=0.05)
    assert t_share == pytest.approx(dc.motif_prob * L / S, rel=0.05)


# ---------------------------------------------------------------------------
# The reference's integration checks, on the port alone.
# ---------------------------------------------------------------------------


def _setup(arch="olmo-1b", B=8, S=64, lr=1e-2):
    cfg = get_config(arch, reduced=True)
    from repro_torch.models import model as TM
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    opt = TO.init_opt_state(params)
    tcfg = TS.TrainConfig(
        opt=TO.OptimizerConfig(lr=lr, warmup_steps=5, total_steps=200,
                               weight_decay=0.0),
        isla_telemetry=True, telemetry_exact=True, isla_rate=0.25)
    stream = TD.SyntheticStream(cfg, batch=B, seq=S, device="cpu")
    return cfg, params, opt, stream, (
        lambda p, o, b: TS.train_step(cfg, tcfg, p, o, b))


def test_loss_decreases_and_telemetry_tracks():
    """``tests/test_train_integration.py``'s thresholds: the mean of the
    last five losses below the first five's by more than 0.2, and the
    median |isla - exact| of the telemetry below 0.5."""
    cfg, params, opt, stream, step_fn = _setup()
    losses, isla_err = [], []
    for step in range(30):
        params, opt, m = step_fn(params, opt, stream.batch_at(step))
        losses.append(float(m["loss"]))
        isla_err.append(abs(float(m["loss_mean_isla"])
                            - float(m["loss_mean_exact"])))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, \
        f"no learning: {losses[:3]} -> {losses[-3:]}"
    assert np.median(isla_err) < 0.5, f"telemetry err {isla_err}"


def test_microbatch_accumulation_matches_full_batch():
    """The reference's case on the port: two microbatches of the same data
    make the same step as one batch (bf16 params)."""
    cfg, params, _, stream, _ = _setup(B=8, S=32)
    batch = stream.batch_at(0)

    def run(microbatches):
        tcfg = TS.TrainConfig(opt=TO.OptimizerConfig(
            lr=1e-3, warmup_steps=0, weight_decay=0.0),
            microbatches=microbatches, isla_telemetry=False)
        p, _, m = TS.train_step(cfg, tcfg, params,
                                TO.init_opt_state(params), batch)
        return p, float(m["loss"])

    p1, l1 = run(1)
    p2, l2 = run(2)
    assert l1 == pytest.approx(l2, rel=1e-2)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(C.f32(a), C.f32(b), rtol=0.05, atol=2e-3)


def test_elastic_restart_reproduces_trajectory(tmp_path):
    """Checkpoint at step 5, 'fail', restore (into the abstract shapes),
    replay steps 5..9: the same losses (rtol 1e-5; on the CPU the same
    bits)."""
    from repro_torch.models import model as TM
    cfg, params, opt, stream, step_fn = _setup(B=4, S=32)
    d = str(tmp_path / "ck")
    losses_a = []
    for step in range(10):
        if step == 5:
            ckpt.save(d, 5, {"params": params, "opt": opt}, fingerprint="t")
        params, opt, m = step_fn(params, opt, stream.batch_at(step))
        losses_a.append(float(m["loss"]))
    like = {"params": TM.abstract_params(cfg),
            "opt": TO.abstract_opt_state(TM.abstract_params(cfg))}
    restored, _ = ckpt.restore(d, 5, like, device="cpu", fingerprint="t")
    p2, o2 = restored["params"], restored["opt"]
    assert isinstance(o2, TO.OptState) and int(o2.step) == 5
    losses_b = []
    for step in range(5, 10):
        p2, o2, m = step_fn(p2, o2, stream.batch_at(step))
        losses_b.append(float(m["loss"]))
    np.testing.assert_allclose(losses_a[5:], losses_b, rtol=1e-5)
    assert losses_a[5:] == losses_b
