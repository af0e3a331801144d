"""The port's training CLI (``launch/train.py``) against the reference's on
the CPU.

Both packages draw their params and batches from their own generators, so
``--seed`` cannot give them one run.  Each test patches both launch
modules' names instead: ``get_config`` (the reduced config in fp32),
``model_lib.init_params`` (one numpy parameter set, the reference's
draw carried through ``convert.params_from``) and ``SyntheticStream`` (one
numpy batch a step, seeded by the step).  The reference's files are not
touched.

Tolerances: losses and every 0-d metric within rel 1e-5 (MoE configs
1e-4), the one-step tolerances of ``tests/test_torch_train.py``; the worst
seen over four steps is 4.2e-6.  Checkpoints leaf by leaf, under that file's
small-gradient rule carried over four steps: params within ``CKPT_TOL``
of each leaf's scale wherever the first step's gradient exceeds 1e-4 of
its leaf's largest, and elsewhere within twice the steps' summed learning
rate.  Adam's first step moves an element by ``lr * g / (|g| + eps)``, so
where |g| lies at rounding level the packages' steps differ by up to
``2 * lr`` (seen: grok's ``w_down``, a gradient 1e-6 of its leaf's
largest at step 0, 0.04 lr apart after that step and every later one).
The next steps' gradients are taken at those params, so ``m``, ``v`` and
the other params part by more than one step's 1e-5: ``CKPT_TOL`` is 1e-4
of each leaf's scale (worst seen 6.2e-5, paligemma-3b's params; olmo-1b's
moments 5.9e-5).

The batch is 4 x 64 tokens: at the CLI's telemetry rate 0.02, 128 tokens
give the estimator 3 samples, and there the reference's own jitted
``loss_stats`` parts from its eager one on the same losses by 0.4%; from
256 tokens on they agree within 1e-7."""
import contextlib
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as RT
from repro_torch import convert
from repro_torch.core.tree import tree_leaves, tree_paths
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import abstract_opt_state

import _torch_train_cases as C

TOL = {"olmo-1b": 1e-5, "mamba2-130m": 1e-5, "paligemma-3b": 1e-5,
       "grok-1-314b": 1e-4}
SMALL_GRAD = 1e-4
CKPT_TOL = 1e-4
# torch's CPU kernels do not repeat a run bit for bit in one process (seen:
# the fourth step's grad_norm one ulp apart, and its ISLA loss estimate,
# which rests on 6 samples, further): two runs of the port are held to
# the tolerance of the packages' pair
REPEAT_TOL = 1e-5
B, S = 4, 64
STEPS = 4
LOG = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) \((\d+\.\d{2})s\)"
                 r"( isla_loss (\d+\.\d{4}))?$")


def args(**kw):
    """The CLI's defaults (the reference's, plus ``--device``) at the
    tests' size, on the CPU."""
    a = TT.parser().parse_args([
        "--reduced", "--device", "cpu", "--steps", str(STEPS), "--batch",
        str(B), "--seq", str(S), "--lr", "1e-3", "--warmup", "1",
        "--log-every", "1", "--telemetry-exact"])
    for k, v in kw.items():
        setattr(a, k, v)
    return a


class _Stream:
    """One numpy batch a step (``_torch_train_cases.batch`` seeded by the
    step), the reference's half or the port's."""
    side = 0

    def __init__(self, cfg, batch, seq, **_):
        self.cfg, self.b, self.s = cfg, batch, seq

    def batch_at(self, step):
        return C.batch(self.cfg, self.b, self.s, seed=1000 + step)[self.side]


class _RefStream(_Stream):
    side = 0


class _PortStream(_Stream):
    side = 1


@contextlib.contextmanager
def shared(arch):
    """Both launch modules on one fp32 parameter set and one batch
    stream; yields the port's config and the numpy parameter set."""
    (cr, pr), (ct, _) = C.pair(arch, "float32")
    host = jax.tree_util.tree_map(np.asarray, pr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RT, "get_config", lambda a, reduced=False: cr)
        mp.setattr(TT, "get_config", lambda a, reduced=False: ct)
        mp.setattr(RT.model_lib, "init_params", lambda cfg, key:
                   jax.tree_util.tree_map(jnp.asarray, host))
        mp.setattr(TT.model_lib, "init_params", lambda cfg, gen:
                   convert.params_from(host, device=gen.device))
        mp.setattr(RT, "SyntheticStream", _RefStream)
        mp.setattr(TT, "SyntheticStream", _PortStream)
        yield ct, host


def run_both(arch, root, capsys, **kw):
    """(reference result, port result, their step log lines), each run
    with ``--ckpt-dir`` under ``root``."""
    out, logs = [], []
    with shared(arch) as case:
        for name, mod in (("ref", RT), ("port", TT)):
            out.append(mod.run(args(arch=arch, ckpt_dir=str(root / name),
                                    **kw)))
            logs.append([ln for ln in capsys.readouterr().out.splitlines()
                         if ln.startswith("step")])
    return out[0], out[1], logs, case


def like(ct):
    ap = TM.abstract_params(ct)
    return {"params": ap, "opt": abstract_opt_state(ap)}


def load(d, step, ct):
    tree, manifest = ckpt.restore(str(d), step, like(ct), device="cpu")
    return tree, manifest


def close_rows(got, want, tol, steps):
    assert [r["step"] for r in got] == [r["step"] for r in want] == steps
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k not in ("step", "dt_s"):
                assert g[k] == pytest.approx(w[k], rel=tol, abs=1e-12), \
                    (g["step"], k)


def small_first_grads(case):
    """Per param leaf, where the first step's gradient (the shared
    weights on step 0's batch) is at most ``SMALL_GRAD`` of the leaf's
    largest."""
    ct, host = case
    _, _, grads = TS._value_and_grad(
        ct, convert.params_from(host, device="cpu"),
        _PortStream(ct, B, S).batch_at(0), None)
    return [g.abs() <= SMALL_GRAD * float(g.abs().max())
            for g in tree_leaves(grads)]


def close_ckpt(got, want, tol, lr_sum, small):
    """Two committed checkpoints of one tree, leaf by leaf; ``small`` from
    ``small_first_grads``."""
    assert int(got["opt"].step) == int(want["opt"].step)
    for part in ("m", "v"):
        for (path, g), w in zip(tree_paths(getattr(got["opt"], part)),
                                tree_leaves(getattr(want["opt"], part))):
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= tol * max(scale, 1e-30), \
                (part, path)
    for (path, g), w, sm in zip(tree_paths(got["params"]),
                                tree_leaves(want["params"]), small):
        gap, big = (g - w).abs(), ~sm
        if bool(big.any()):
            assert float(gap[big].max()) <= tol * float(w.abs().max()), path
        assert float(gap.max()) <= 2 * lr_sum * 1.0001, path


def lr_sum(history):
    return sum(r["lr"] for r in history)


@pytest.mark.parametrize("arch", sorted(TOL))
def test_run_matches_reference(arch, tmp_path, capsys):
    """Four steps of each package's ``run`` from the same weights and
    batches: history rows with the same keys (``moe_lb_loss`` for grok,
    the loss telemetry and its exact mean for all), the same losses and
    metrics, log lines of the same format, and final checkpoints at step
    4 (the periodic one at 2 kept beside it) that agree leaf by leaf."""
    want, got, logs, case = run_both(arch, tmp_path, capsys, ckpt_every=2)
    ct = case[0]
    tol = TOL[arch]
    close_rows(got["history"], want["history"], tol, list(range(STEPS)))
    assert got["final_loss"] == got["history"][-1]["loss"]
    keys = set(got["history"][0])
    assert {"loss", "grad_norm", "lr", "loss_mean_isla",
            "loss_mean_exact"} <= keys
    assert ("moe_lb_loss" in keys) is (arch == "grok-1-314b")
    for ref_line, port_line in zip(*logs):
        r, p = LOG.match(ref_line), LOG.match(port_line)
        assert r and p and r.group(1) == p.group(1) and p.group(4)
    assert len(logs[0]) == len(logs[1]) == STEPS
    for name in ("ref", "port"):
        assert sorted(os.listdir(tmp_path / name)) == [
            "step_00000002", "step_00000004"]
    a, ma = load(tmp_path / "port", STEPS, ct)
    b, mb = load(tmp_path / "ref", STEPS, ct)
    assert ma["fingerprint"] == mb["fingerprint"] == \
        f"{ct.name}|{ct.n_layers}|{ct.d_model}|0.001"
    close_ckpt(a, b, CKPT_TOL, lr_sum(want["history"]),
               small_first_grads(case))


@pytest.fixture(scope="module")
def olmo_runs(tmp_path_factory):
    """Uninterrupted runs of olmo-1b in both packages, checkpoints at 2 and
    4."""
    root = tmp_path_factory.mktemp("olmo")
    out = {}
    with shared("olmo-1b") as case:
        for name, mod in (("ref", RT), ("port", TT)):
            out[name] = mod.run(args(ckpt_dir=str(root / name),
                                     ckpt_every=2))
    return root, out, case


@pytest.mark.parametrize("writer, reader", [("ref", "port"),
                                            ("port", "ref")])
def test_resume_across_packages(olmo_runs, writer, reader, tmp_path, capsys):
    """A checkpoint at step 2 written by one package's ``run`` is resumed
    by the other's ``run --resume`` (a crash after step 2's commit, mid-
    write of step 4): it prints ``[resume] from step 2``, continues as an
    uninterrupted run of either package does, and commits step 4."""
    root, runs, case = olmo_runs
    ct = case[0]
    d = tmp_path / "ckpt"
    os.makedirs(d)
    os.rename(root / writer / "step_00000002", d / "step_00000002")
    os.makedirs(d / "step_00000004.tmp")
    mod = TT if reader == "port" else RT
    with shared("olmo-1b"):
        got = mod.run(args(ckpt_dir=str(d), ckpt_every=2, resume=True))
    assert "[resume] from step 2" in capsys.readouterr().out.splitlines()
    for name in ("ref", "port"):
        close_rows(got["history"], runs[name]["history"][2:], 1e-5, [2, 3])
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]
    close_ckpt(load(d, 4, ct)[0], load(root / reader, 4, ct)[0], CKPT_TOL,
               lr_sum(runs[reader]["history"]), small_first_grads(case))


def test_resume_cleans_a_stray_tmp_and_replays(tmp_path, capsys):
    """The port alone: a crash mid-write of step 4 leaves step 2 committed
    and ``step_00000004.tmp``; ``--resume`` removes the ``.tmp``, restores
    step 2 and repeats steps 2 and 3 (within ``REPEAT_TOL``)."""
    with shared("olmo-1b"):
        first = TT.run(args(ckpt_dir=str(tmp_path), ckpt_every=2))
        os.rename(tmp_path / "step_00000004", tmp_path / "step_00000004.tmp")
        capsys.readouterr()
        again = TT.run(args(ckpt_dir=str(tmp_path), ckpt_every=2,
                            resume=True))
    assert capsys.readouterr().out.splitlines()[0] == "[resume] from step 2"
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]
    close_rows(again["history"], first["history"][2:], REPEAT_TOL, [2, 3])


def test_fail_changes_nothing_on_one_device():
    """``--fail`` acts only with a mesh (reference ``:108``): the schedule
    is consumed and the run is the run without it (within
    ``REPEAT_TOL``)."""
    with shared("olmo-1b"):
        plain = TT.run(args())
        failed = TT.run(args(fail=["2:1"]))
    close_rows(failed["history"], plain["history"], REPEAT_TOL,
               list(range(STEPS)))


def test_microbatches_run():
    """``--microbatches 2`` splits each batch in two and steps as the one
    batch does (fp32 sums of two halves' gradients)."""
    with shared("olmo-1b"):
        one = TT.run(args())
        two = TT.run(args(microbatches=2))
    close_rows(two["history"], one["history"], 1e-5, list(range(STEPS)))


def test_two_ranks_build_a_mesh_and_train(tmp_path):
    """Two gloo ranks (a process group of two: ``device_count`` is its
    world) make ``run`` build the reference's (2, 1) ``("data",
    "model")`` mesh and train the sharded step on it: the history is the
    one-device run's (within ``REPEAT_TOL``), rank 0 alone prints."""
    import _torch_mesh_lm_cases as M
    with shared("olmo-1b") as (ct, host):
        one = TT.run(args())
    batches = [{k: v.numpy() for k, v in _PortStream(ct, B, S).batch_at(
        st).items()} for st in range(STEPS)]
    M.write_case(tmp_path / "case.pkl", ct, host, batches)
    argv = ["--reduced", "--device", "cpu", "--steps", str(STEPS),
            "--batch", str(B), "--seq", str(S), "--lr", "1e-3", "--warmup",
            "1", "--log-every", "1", "--telemetry-exact"]
    M.spawn(M.cli_run, 2, tmp_path, str(tmp_path / "case.pkl"), argv,
            str(tmp_path))
    got = json.loads((tmp_path / "result.json").read_text())
    assert got["meshes"] == [[2, 1]] and got["device_count"] == 2
    close_rows(got["history"], one["history"], REPEAT_TOL,
               list(range(STEPS)))
    lines = [(tmp_path / f"stdout_{r}.txt").read_text().splitlines()
             for r in range(2)]
    assert len(lines[0]) == STEPS and all(LOG.match(ln) for ln in lines[0])
    assert lines[1] == []
    assert TT.device_count(torch.device("cpu")) == 1


def test_build_step_without_a_mesh_is_train_step():
    fn, placements = TT.build_step("cfg", "tcfg", None)
    assert placements is None and fn.func is TT.train_step
    assert fn.args == ("cfg", "tcfg")


def test_cli_defaults_are_the_references():
    """Every flag of the reference's ``main`` with its default; the port
    adds ``--device`` (``cuda``) only."""
    import argparse
    import ast
    import inspect

    src = inspect.getsource(RT.main)
    want = dict(re.findall(r'add_argument\("--([a-z-]+)"[^)]*?default=([^,)]+)',
                           src))
    flags = re.findall(r'add_argument\("--([a-z-]+)"', src)
    actions = {a.option_strings[0][2:]: a for a in TT.parser()._actions
               if a.option_strings and a.option_strings[0] != "-h"}
    assert sorted(actions) == sorted(flags + ["device"])
    for flag, default in want.items():
        assert actions[flag].default == ast.literal_eval(default), flag
    for flag in set(flags) - set(want):
        assert isinstance(actions[flag], argparse._StoreTrueAction), flag
    assert actions["device"].default == "cuda"


def test_main_writes_history_and_final_loss(tmp_path, capsys):
    """``python -m repro_torch.launch.train ... --out F`` writes the
    reference's ``{"history", "final_loss"}``."""
    out = tmp_path / "run.json"
    with shared("olmo-1b"):
        TT.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch",
                 str(B), "--seq", str(S), "--log-every", "1", "--out",
                 str(out)])
    res = json.loads(out.read_text())
    assert sorted(res) == ["final_loss", "history"]
    assert [r["step"] for r in res["history"]] == [0, 1]
    assert res["final_loss"] == res["history"][-1]["loss"]
    lines = capsys.readouterr().out.splitlines()
    assert all(LOG.match(ln) for ln in lines) and len(lines) == 2
