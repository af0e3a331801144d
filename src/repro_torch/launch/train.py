"""Fault-tolerant trainer (``repro.launch.train`` in torch).

Runs the train step under a supervisor that:
  * checkpoints asynchronously every --ckpt-every steps (atomic commit),
    in the reference's on-disk format, so a checkpoint written by either
    package resumes in the other (``train.checkpoint``),
  * resumes with --resume from the last committed checkpoint, after
    removing any crash leftover (``.tmp``),
  * simulates data-group failures at scheduled steps (--fail
    "step:groups"): on a failure it shrinks the data axis by
    ``elastic.remesh_plan``, rebuilds the mesh over the surviving ranks,
    restores the last committed checkpoint re-sharded onto it, replays the
    deterministic data stream (``train.data``), and turns the lost
    data-parallelism into gradient accumulation, so the global batch (and
    the optimization trajectory) is kept.

On one device the step is ``train_step`` itself (the reference's
``mesh is None`` branch: a plain jit there, eager autograd here), on
``--device`` (``cuda`` by default; ``--device cpu`` runs the kernels'
plain versions).  Over a ``torch.distributed`` process group (one rank a
device: ``nccl`` on cards, ``gloo`` on the CPU) it trains on a
(world / --model-parallel, --model-parallel) ``("data", "model")``
``DeviceMesh`` through ``train_step.make_jit_train_step``: params,
moments and batches as DTensors in the ``sharding.specs`` placements.
Without a process group ``run`` trains on the one device; ``main``
starts one rank a visible card when more than one card is visible and
no process group is up; without a card, several ranks come only from a
gloo group the caller initialised.  Rank 0 alone prints,
writes checkpoints and writes --out.  Each step's loss telemetry is one
hand-written ``isla_fold`` launch a rank on the card.  Without a mesh
--fail changes nothing, as in the reference.

  PYTHONPATH=src python -m repro_torch.launch.train --reduced \
      --device cpu --steps 5
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..configs import get_config
from ..core.distributed import resolve_device
from ..models import model as model_lib
from ..sharding import (activation_constraint, opt_state_specs, param_specs,
                        shardings)
from ..train import checkpoint as ckpt
from ..train.data import SyntheticStream
from ..train.elastic import FailureInjector, remesh_plan, rescale_batch
from ..train.optimizer import (OptimizerConfig, abstract_opt_state,
                               init_opt_state)
from ..train.train_step import (StepPlacements, TrainConfig,
                                make_jit_train_step, place, train_step)
from .mesh import in_mesh, make_rank_mesh, mesh_barrier


def _fingerprint(cfg, tcfg) -> str:
    return f"{cfg.name}|{cfg.n_layers}|{cfg.d_model}|{tcfg.opt.lr}"


def _make_mesh(shape, axis_names):
    """The ``DeviceMesh`` over the first ``prod(shape)`` ranks of the
    process group (all of them at the start)."""
    return make_rank_mesh(tuple(shape), tuple(axis_names))


def build_step(cfg, tcfg, mesh):
    """The train step and its placements: ``train_step`` itself (no
    placements) with no mesh; with one, the sharded step under the mesh
    (``use_mesh``, the activation constraint) and its ``StepPlacements``
    (params and optimizer state by ``param_specs`` / ``opt_state_specs``
    of ``abstract_params``, each microbatch by ``batch_specs``)."""
    if mesh is None:
        return functools.partial(train_step, cfg, tcfg), None
    ap = model_lib.abstract_params(cfg)
    p_sh = shardings(mesh, param_specs(cfg, mesh, ap))
    o_sh = shardings(mesh, opt_state_specs(cfg, mesh,
                                           abstract_opt_state(ap)))
    step = make_jit_train_step(cfg, tcfg, mesh, p_sh, o_sh, None,
                               activation_constraint(cfg, mesh))
    return step, StepPlacements(mesh, p_sh, o_sh)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def device_count(device: torch.device) -> int:
    """The devices the trainer trains on: a process group's world (one
    rank a device), else one (``device``; ``main`` starts a rank a card
    when several are visible)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _say(*a, **kw):
    if _rank() == 0:
        print(*a, **kw)


def run(args) -> dict:
    cfg = get_config(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(
        opt=OptimizerConfig(lr=args.lr, warmup_steps=args.warmup,
                            total_steps=args.steps),
        microbatches=args.microbatches,
        isla_telemetry=True, telemetry_exact=args.telemetry_exact,
    )
    device = resolve_device(args.device)
    if device.type == "cuda" and dist.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    n_dev = device_count(device)
    mesh_shape = None
    mesh = None
    if n_dev > 1:
        data = max(1, n_dev // args.model_parallel)
        mesh_shape = (data, args.model_parallel)
        mesh = _make_mesh(mesh_shape, ("data", "model"))

    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    opt_state = init_opt_state(params)
    stream = SyntheticStream(cfg, batch=args.batch, seq=args.seq,
                             device=device)
    step_fn, plc = build_step(cfg, tcfg, mesh)
    injector = FailureInjector(
        [(int(s.split(":")[0]), int(s.split(":")[1]))
         for s in (args.fail or [])])
    writer = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3) \
        if args.ckpt_dir else None
    fp = _fingerprint(cfg, tcfg)
    history = []

    def restore(step):
        sh = None if plc is None else {"params": plc.params,
                                       "opt": plc.opt}
        restored, _ = ckpt.restore(
            args.ckpt_dir, step, {"params": params, "opt": opt_state},
            device=device, fingerprint=fp, shardings=sh)
        return restored["params"], restored["opt"]

    if mesh is not None and not in_mesh(mesh):
        return {"history": history, "final_loss": None}
    if plc is not None:
        # each rank keeps its own shards of the whole trees it drew
        params, opt_state = place(params, plc.params), place(opt_state,
                                                             plc.opt)

    start = 0
    if args.ckpt_dir and args.resume:
        if _rank() == 0:
            ckpt.clean_tmp(args.ckpt_dir)
        if mesh is not None:
            mesh_barrier(mesh)
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            params, opt_state = restore(last)
            start = last
            _say(f"[resume] from step {last}")

    step = start
    while step < args.steps:
        n_fail = injector.failures_at(step)
        if n_fail and mesh is not None:
            # ---- simulated failure: shrink mesh, restore, replay
            plan = remesh_plan(mesh_shape, ("data", "model"), n_fail)
            _say(f"[elastic] step {step}: {plan.note}")
            _, accum = rescale_batch(args.batch, mesh_shape[0],
                                     plan.shape[0])
            if writer:
                writer.wait()
            mesh_barrier(mesh)        # rank 0's last commit is on disk
            mesh_shape = plan.shape
            mesh = _make_mesh(plan.shape, plan.axis_names)
            if not in_mesh(mesh):     # a lost rank leaves
                params = opt_state = None
                break
            tcfg = TrainConfig(opt=tcfg.opt,
                               microbatches=tcfg.microbatches * accum,
                               isla_telemetry=tcfg.isla_telemetry)
            step_fn, plc = build_step(cfg, tcfg, mesh)
            last = ckpt.latest_step(args.ckpt_dir)
            params, opt_state = restore(last)
            step = last
            continue

        t0 = time.perf_counter()
        batch = stream.batch_at(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        history.append({"step": step, "loss": loss, "dt_s": round(dt, 3),
                        **{k: float(v) for k, v in metrics.items()
                           if hasattr(v, "shape") and v.shape == ()}})
        if step % args.log_every == 0:
            isla = metrics.get("loss_mean_isla")
            _say(f"step {step:5d} loss {loss:.4f} "
                 f"({dt:.2f}s)"
                 + (f" isla_loss {float(isla):.4f}" if isla is not None
                    else ""), flush=True)
        step += 1
        if writer and step % args.ckpt_every == 0:
            writer.submit(step, {"params": params, "opt": opt_state},
                          fingerprint=fp)
    if writer:
        if params is not None:
            writer.submit(step, {"params": params, "opt": opt_state},
                          fingerprint=fp)
        writer.close()
    return {"history": history, "final_loss": history[-1]["loss"]
            if history else None}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--telemetry-exact", action="store_true")
    ap.add_argument("--fail", nargs="*", default=None,
                    help="step:groups failure injections, e.g. 50:1")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where params, optimizer state and batches live: "
                         "cuda (default) or cpu (the kernels' plain "
                         "versions)")
    return ap


def _write_out(args, result) -> None:
    if args.out and _rank() == 0:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


def _card_rank(rank: int, world: int, store: str, args) -> None:
    """One rank of ``main``'s spawn: card ``rank``, an ``nccl`` group
    through the file store, then ``run``."""
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        _write_out(args, run(args))
        dist.barrier()        # a rank the remesh dropped waits for the rest
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = parser().parse_args(argv)
    cards = (torch.cuda.device_count()
             if resolve_device(args.device).type == "cuda" else 0)
    if cards > 1 and not dist.is_initialized():
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as d:
            mp.spawn(_card_rank, args=(cards, os.path.join(d, "store"),
                                       args), nprocs=cards)
        return
    _write_out(args, run(args))


if __name__ == "__main__":
    main()
