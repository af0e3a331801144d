"""The sharded train step (``train_step.make_jit_train_step`` through
``launch.train.build_step``), re-shard-on-load and the training CLI's
elastic drill, on four gloo ranks on the CPU
(``tests/_torch_mesh_lm_cases.py`` spawns them).

Tolerances: each sharded step's rows (loss, the ISLA loss estimate, its
exact mean, grad norm, lr, the MoE load-balance loss) within rel 1e-5 of
the meshless step from the same inputs (MoE configs 1e-4), the pairs of
``tests/test_torch_launch_train.py``; TP's partial sums and the gathered
losses are added in another order, nothing more.  Each step's new params
within 1e-4 of each leaf's scale where that step's gradient exceeds 1e-4
of its leaf's largest, and within twice its learning rate elsewhere
(that file's ``close_ckpt`` rule: Adam's first step moves an element
whose gradient sits at rounding level by up to ``lr``).  The drill is
held to the reference's drill by that file's rules."""
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_lm_cases as M
import _torch_train_cases as C
from repro_torch import convert
from repro_torch.core.tree import tree_leaves
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import abstract_opt_state
from test_torch_launch_train import (CKPT_TOL, SMALL_GRAD, close_ckpt,
                                     close_rows, lr_sum)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    M.spawn(M.sharded_steps, 4, out, str(out))
    with open(out / "steps.json") as f:
        steps = json.load(f)
    with open(out / "reshard.json") as f:
        reshard = json.load(f)
    with open(out / "constraints.json") as f:
        constraints = json.load(f)
    return steps, reshard, constraints


@pytest.mark.parametrize("arch", M.ARCHS)
def test_sharded_step_matches_the_meshless_step(sharded, arch):
    """On a (2, 2) mesh with TP, FSDP and ZeRO on: every step's rows and
    new params equal the meshless step's from the same state."""
    res = sharded[0][arch]
    tol = M.TOL[arch]
    assert len(res["steps"]) == M.STEPS
    for row in res["steps"]:
        assert sorted(row["got"]) == sorted(row["want"])
        assert ("moe_lb_loss" in row["got"]) is (arch == "grok-1-314b"
                                                 or arch.startswith("jamba"))
        for k, w in row["want"].items():
            assert row["got"][k] == pytest.approx(w, rel=tol, abs=1e-12), k
        for path, big, small in row["leaves"]:
            assert big <= M.CKPT_TOL, path
            assert small <= 1.0001, path
    # TP and FSDP acted: some leaf split over both mesh dims
    assert any(p.count("Shard") == 2 for p in res["placements"])


def test_checkpoint_reshards_on_load(sharded):
    """Written from (2, 2) DTensors by rank 0 in the reference's format,
    restored onto (2, 2), onto (1, 2) and onto no mesh, bit for bit."""
    rep = sharded[1]
    assert rep["files"] == ["step_00000002"]
    for name in ("2x2", "1x2", "none"):
        assert rep[name]["equal"], name
    assert all(p == "None" for p in rep["none"]["placements"])
    for name in ("2x2", "1x2"):
        assert rep[name]["placements"] == rep[name]["want"], name
    assert "(Shard(dim=1), Shard(dim=2))" in rep["2x2"]["placements"]
    assert {tuple(m) for m in rep["2x2"]["mesh"]} == {(2, 2)}
    assert {tuple(m) for m in rep["1x2"]["mesh"]} == {(1, 2)}


def test_constraints_redistribute_by_the_references_rules(sharded):
    """Under ``use_mesh`` on (2, 2): ``constrain_expert_parallel`` puts the
    experts over "model" and the groups over "data", ``constrain_heads``
    the heads over "model" and the batch over "data" (the reference's
    PartitionSpecs), values unchanged; experts that "model" does not
    divide stay as they are; a plain tensor is returned itself."""
    c = sharded[2]
    assert c["experts"] == {"placements": "(Shard(dim=1), Shard(dim=0))",
                            "equal": True}
    assert c["heads"] == {"placements": "(Shard(dim=0), Shard(dim=2))",
                          "equal": True}
    assert c["odd"] == {"placements": "(Replicate(), Replicate())",
                        "equal": True}
    assert c["plain"] is True


B, S, STEPS = 4, 64, 4

_REF_DRILL = """
import json, pickle, sys
import jax, jax.numpy as jnp
from repro.launch import train as RT
from repro_torch.launch import train as TT
case = pickle.load(open({case!r}, "rb"))
RT.get_config = lambda a, reduced=False: case["ref_cfg"]
RT.model_lib.init_params = lambda cfg, key: jax.tree_util.tree_map(
    jnp.asarray, case["host"])
class Stream:
    def __init__(self, cfg, batch, seq, **_):
        pass
    def batch_at(self, step):
        return {{k: jnp.asarray(v, jnp.int32)
                for k, v in case["batches"][step].items()}}
RT.SyntheticStream = Stream
assert len(jax.devices()) == 4
res = RT.run(TT.parser().parse_args({argv!r}))
json.dump(res, open({out!r}, "w"))
"""


def _drill_argv(ckpt_dir):
    return ["--reduced", "--device", "cpu", "--steps", str(STEPS),
            "--batch", str(B), "--seq", str(S), "--lr", "1e-3", "--warmup",
            "1", "--log-every", "1", "--telemetry-exact",
            "--model-parallel", "2", "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", "2", "--fail", "2:1"]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The elastic drill, both packages, on one numpy parameter set and
    batch stream: the reference's ``run`` on four host devices in a
    subprocess, the port's on four gloo ranks, at the same time."""
    root = tmp_path_factory.mktemp("drill")
    (cr, pr), (ct, _) = C.pair("olmo-1b", "float32")
    host = jax.tree_util.tree_map(np.asarray, pr)
    batches = []
    for st in range(STEPS):
        _, bt = C.batch(ct, B, S, seed=1000 + st)
        batches.append({k: v.numpy() for k, v in bt.items()})
    case = root / "case.pkl"
    with open(case, "wb") as f:
        pickle.dump({"cfg": ct, "ref_cfg": cr, "host": host,
                     "batches": batches}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_DRILL.format(
            case=str(case), argv=_drill_argv(root / "ref"),
            out=str(root / "ref.json"))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        M.spawn(M.cli_run, 4, root, str(case), _drill_argv(root / "port"),
                str(root))
    finally:
        out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    with open(root / "ref.json") as f:
        want = json.load(f)
    with open(root / "result.json") as f:
        got = json.load(f)
    lines = [open(root / f"stdout_{r}.txt").read().splitlines()
             for r in range(4)]
    return root, want, got, out.splitlines(), lines, ct


def test_elastic_drill_matches_the_references(drill):
    """``--fail 2:1`` on a (2, 2) mesh: the data axis goes 2 -> 1, the
    microbatches 1 -> 2, step 2's checkpoint is restored onto the (1, 2)
    mesh and steps 2-3 are replayed; the history equals the reference's
    drill's row for row, and both final checkpoints (step 4, beside the
    periodic step 2) agree leaf by leaf."""
    root, want, got, ref_out, lines, ct = drill
    close_rows(got["history"], want["history"], 1e-5, list(range(STEPS)))
    note = "[elastic] step 2: data axis 2 -> 1 after 1 failures"
    assert note in ref_out and note in lines[0]
    for name in ("ref", "port"):
        assert sorted(os.listdir(root / name)) == [
            "step_00000002", "step_00000004"]
    ap = TM.abstract_params(ct)
    like = {"params": ap, "opt": abstract_opt_state(ap)}
    a = ckpt.restore(str(root / "port"), STEPS, like, device="cpu")[0]
    b = ckpt.restore(str(root / "ref"), STEPS, like, device="cpu")[0]
    with open(root / "case.pkl", "rb") as f:
        case = pickle.load(f)
    _, _, g0 = TS._value_and_grad(
        ct, convert.params_from(case["host"], device="cpu"),
        {k: torch.as_tensor(v) for k, v in case["batches"][0].items()},
        None)
    small = [g.abs() <= SMALL_GRAD * float(g.abs().max())
             for g in tree_leaves(g0)]
    close_ckpt(a, b, CKPT_TOL, lr_sum(want["history"]), small)


def test_drill_output_comes_from_rank_0(drill):
    """Rank 0 alone prints: the elastic line and one step line a step
    (steps 2-3 after the replay); the other ranks print nothing, ranks 2
    and 3 leave at the remesh."""
    _, _, got, _, lines, _ = drill
    steps = [ln for ln in lines[0] if ln.startswith("step")]
    assert len(steps) == STEPS
    assert any(ln.startswith("[elastic] step 2") for ln in lines[0])
    assert lines[1] == lines[2] == lines[3] == []
    assert got["final_loss"] == got["history"][-1]["loss"]
