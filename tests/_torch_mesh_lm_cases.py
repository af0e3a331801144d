"""Shared cases of the sharded LM training tests: gloo ranks spawned on
the CPU, and what each rank runs.

``spawn`` starts ``world`` processes, each in a ``gloo`` process group
through a file store under the test's own directory (so that xdist
workers never share a port), one torch thread each, and runs a
module-level function of this file there.  The rank functions import only
torch and the port; what they find is written by rank 0 as JSON (or
pickled tensors) for the test to check in its own process.

``sharded_steps``: reduced configs in fp32 with ``TP_THRESHOLD``,
``FSDP_THRESHOLD`` and ``FSDP_MIN_ELEMENTS`` set to 0, so that TP, FSDP
(of the weights and the ZeRO moments) and the expert and head
constraints all act on a (2, 2) ``("data", "model")`` mesh.  Each step of
``make_jit_train_step`` is held against the meshless ``train_step`` run
on the same inputs (the sharded step's state gathered whole).

``reshard``: a checkpoint written from (2, 2) DTensors, restored with
``shardings=`` onto (2, 2), onto (1, 2) and onto no mesh.

``cli_run``: the port's ``launch.train.run`` on every rank, its names
patched as ``tests/test_torch_launch_train.py`` patches them (a pickled
case: the config, one numpy parameter set, one numpy batch a step)."""
import contextlib
import io
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

STEPS = 2
B, S = 4, 64
MESH = ((2, 2), ("data", "model"))
ARCHS = ("olmo-1b", "grok-1-314b", "mamba2-130m", "jamba-1.5-large-398b")
# the meshless step from the same inputs: rows within rel 1e-5 (MoE 1e-4,
# as ``tests/test_torch_launch_train.py``'s pairs)
TOL = {"olmo-1b": 1e-5, "grok-1-314b": 1e-4, "mamba2-130m": 1e-5,
       "jamba-1.5-large-398b": 1e-4}
SMALL_GRAD = 1e-4
CKPT_TOL = 1e-4
ROWS = ("loss", "loss_mean_isla", "loss_mean_exact", "grad_norm", "lr",
        "moe_lb_loss")


def spawn(fn, world, root, *args):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; returns when all
    have exited (a rank's exception fails the call)."""
    store = os.path.join(str(root), "store")
    mp.spawn(_rank_entry, args=(world, store, fn, args), nprocs=world)


def _rank_entry(rank, world, store, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
        # a rank that left a smaller mesh early waits for the others: its
        # group's connections close only when every rank is done
        dist.barrier()
    finally:
        dist.destroy_process_group()


def config(arch):
    from repro_torch.configs import get_config
    return get_config(arch, reduced=True).replace(param_dtype="float32")


def step_batch(cfg, step, b=B, s=S):
    """The seeded batch of ``step`` (the same on every rank)."""
    g = torch.Generator().manual_seed(1000 + step)
    n = s - (cfg.frontend_len if cfg.frontend is not None else 0)
    return {"tokens": torch.randint(0, cfg.vocab, (b, n), generator=g),
            "labels": torch.randint(0, cfg.vocab, (b, n), generator=g)}


def _all_on():
    from repro_torch.sharding import specs as SP
    SP.TP_THRESHOLD = SP.FSDP_THRESHOLD = SP.FSDP_MIN_ELEMENTS = 0


def _rows(metrics) -> dict:
    return {k: float(metrics[k]) for k in ROWS if k in metrics}


def close_leaves(got, want, small, lr_sum, tol=CKPT_TOL) -> list:
    """Per leaf (path, worst gap over the big-gradient set / scale, worst
    gap / (2 lr_sum)): the rule of ``tests/test_torch_launch_train.py``'s
    ``close_ckpt``, as numbers for the test to hold."""
    from repro_torch.core.tree import tree_leaves, tree_paths
    out = []
    for (path, g), w, sm in zip(tree_paths(got), tree_leaves(want), small):
        gap, big = (g - w).abs(), ~sm
        scale = max(float(w.abs().max()), 1e-30)
        out.append((path, float(gap[big].max()) / scale if big.any()
                    else 0.0, float(gap.max()) / (2 * lr_sum)))
    return out


def sharded_steps(rank, world, out_dir):
    """Every arch of ``ARCHS``: ``STEPS`` sharded steps from the seeded
    init, each beside the meshless step from the same state (the sharded
    one gathered whole): its rows, and its new params by
    ``close_leaves`` with that step's gradients as the small-gradient
    set."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.train import build_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    _all_on()
    mesh = make_host_mesh(*MESH)
    result = {}
    for arch in ARCHS:
        cfg = config(arch)
        tcfg = TS.TrainConfig(
            opt=OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS),
            telemetry_exact=True)
        init = TM.init_params(cfg, torch.Generator().manual_seed(0))
        step_fn, plc = build_step(cfg, tcfg, mesh)
        params, opt = init, init_opt_state(init)
        steps, placements = [], None
        for st in range(STEPS):
            batch = step_batch(cfg, st)
            p_in = tree_map(TS.local_value, params)
            o_in = tree_map(TS.local_value, opt)
            params, opt, m = step_fn(params, opt, batch)
            placements = [str(l.placements) for l in tree_leaves(params)]
            p_out = tree_map(TS.local_value, params)
            if rank == 0:
                p_want, _, want = TS.train_step(cfg, tcfg, p_in, o_in, batch)
                _, _, g = TS._value_and_grad(cfg, p_in, batch, None)
                small = [x.abs() <= SMALL_GRAD * float(x.abs().max())
                         for x in tree_leaves(g)]
                steps.append({"got": _rows(m), "want": _rows(want),
                              "leaves": close_leaves(
                                  p_out, p_want, small, float(want["lr"]))})
        result[arch] = {"steps": steps, "placements": placements}
    if rank == 0:
        with open(os.path.join(out_dir, "steps.json"), "w") as f:
            json.dump(result, f)
    reshard(rank, world, out_dir)
    constraints(rank, out_dir)


def constraints(rank, out_dir):
    """``constrain_expert_parallel`` and ``constrain_heads`` on replicated
    DTensors under ``use_mesh`` on (2, 2): the placements they give and
    whether the values stay; and on a plain tensor (itself)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import context as C
    mesh = make_host_mesh(*MESH)
    g = torch.Generator().manual_seed(7)
    xe = torch.randn(8, 2, 3, 16, generator=g)      # (E', G, C, d)
    xh = torch.randn(4, 6, 8, 16, generator=g)      # (B, S, H, P)
    odd = torch.randn(7, 2, 3, 16, generator=g)     # experts not divisible
    out = {}
    with C.use_mesh(mesh):
        for name, t, fn in (
                ("experts", xe, C.constrain_expert_parallel),
                ("heads", xh, lambda x: C.constrain_heads(x, head_dim=2)),
                ("odd", odd, C.constrain_expert_parallel)):
            d = distribute_tensor(t, mesh, [Replicate(), Replicate()],
                                  src_data_rank=None)
            got = fn(d)
            out[name] = {"placements": str(tuple(got.placements)),
                         "equal": bool(torch.equal(got.full_tensor(), t))}
        out["plain"] = C.constrain_heads(xh, head_dim=2) is xh
    if rank == 0:
        with open(os.path.join(out_dir, "constraints.json"), "w") as f:
            json.dump(out, f)


def reshard(rank, world, out_dir):
    """Reduced olmo-1b's params and moments placed on (2, 2) with TP and
    FSDP on, saved at step 2 (rank 0 writes), then restored with
    ``shardings=`` onto (2, 2), onto (1, 2) (ranks 0 and 1) and onto no
    mesh (rank 0): each leaf's whole value and its placements."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.mesh import (in_mesh, make_host_mesh,
                                         make_rank_mesh, mesh_barrier)
    from repro_torch.launch.train import build_step
    from repro_torch.models import model as TM
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import init_opt_state
    _all_on()
    cfg = config("olmo-1b")
    tcfg = TS.TrainConfig()
    d = os.path.join(out_dir, "ckpt")
    params = TM.init_params(cfg, torch.Generator().manual_seed(3))
    opt = init_opt_state(params)
    opt = opt._replace(m=tree_map(lambda x: x + 1.5, params))
    whole = {"params": params, "opt": opt}
    mesh = make_host_mesh(*MESH)
    _, plc = build_step(cfg, tcfg, mesh)
    tree = {"params": TS.place(params, plc.params),
            "opt": TS.place(opt, plc.opt)}
    ckpt.save(d, 2, tree, fingerprint="fp")
    mesh_barrier(mesh)
    report = {}

    def check(name, got, sh=None):
        same = all(torch.equal(TS.local_value(a), b) for a, b in
                   zip(tree_leaves(got), tree_leaves(whole)))
        report[name] = {"equal": same, "placements": [
            str(getattr(a, "placements", None)) for a in tree_leaves(got)],
            "want": [str(s.placements) for s in tree_leaves(sh)]
            if sh is not None else None,
            "mesh": [list(a.device_mesh.shape) for a in tree_leaves(got)
                     if hasattr(a, "device_mesh")]}

    sh = {"params": plc.params, "opt": plc.opt}
    got, _ = ckpt.restore(d, 2, whole, fingerprint="fp", shardings=sh)
    check("2x2", got, sh)
    small = make_rank_mesh((1, 2), MESH[1])
    if in_mesh(small):
        _, plc12 = build_step(cfg, tcfg, small)
        sh = {"params": plc12.params, "opt": plc12.opt}
        got, _ = ckpt.restore(d, 2, whole, shardings=sh)
        check("1x2", got, sh)
    if rank == 0:
        got, _ = ckpt.restore(d, 2, whole, device="cpu")
        check("none", got)
        report["files"] = sorted(os.listdir(d))
        with open(os.path.join(out_dir, "reshard.json"), "w") as f:
            json.dump(report, f)


class _Stream:
    """The pickled case's batch of each step."""
    batches = None

    def __init__(self, cfg, batch, seq, **_):
        pass

    def batch_at(self, step):
        return {k: torch.as_tensor(v)
                for k, v in type(self).batches[step].items()}


def cli_run(rank, world, case_path, argv, out_dir):
    """The port's ``run`` on this rank with the case's config, params and
    batches, ``argv`` over the tests' defaults; rank 0 writes the result,
    every rank its printed lines."""
    from repro_torch import convert
    from repro_torch.launch import train as TT
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    TT.get_config = lambda a, reduced=False: case["cfg"]
    real = TT.model_lib.init_params

    def init_params(cfg, gen):
        # ``abstract_params`` draws from a meta generator: its shapes
        if gen.device.type == "meta":
            return real(cfg, gen)
        return convert.params_from(case["host"], device=gen.device)

    TT.model_lib.init_params = init_params
    _Stream.batches = case["batches"]
    TT.SyntheticStream = _Stream
    meshes, build = [], TT.build_step

    def build_step(cfg, tcfg, mesh):
        meshes.append(None if mesh is None else list(mesh.mesh.shape))
        return build(cfg, tcfg, mesh)

    TT.build_step = build_step
    args = TT.parser().parse_args(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = TT.run(args)
    result["meshes"] = meshes
    result["device_count"] = TT.device_count(torch.device("cpu"))
    with open(os.path.join(out_dir, f"stdout_{rank}.txt"), "w") as f:
        f.write(buf.getvalue())
    if rank == 0:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(result, f)


def write_case(path, cfg, host, batches):
    """Pickle a ``cli_run`` case: the port's config, the reference's numpy
    parameter set, one numpy batch a step."""
    with open(path, "wb") as f:
        pickle.dump({"cfg": cfg, "host": host, "batches": batches}, f)
