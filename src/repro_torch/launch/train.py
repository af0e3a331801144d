"""Fault-tolerant trainer (``repro.launch.train`` in torch).

Runs the train step under a supervisor that:
  * checkpoints asynchronously every --ckpt-every steps (atomic commit),
    in the reference's on-disk format, so a checkpoint written by either
    package resumes in the other (``train.checkpoint``),
  * resumes with --resume from the last committed checkpoint, after
    removing any crash leftover (``.tmp``),
  * replays the deterministic data stream from that step
    (``train.data``).

On one device the step is ``train_step`` itself (the reference's
``mesh is None`` branch: a plain jit there, eager autograd here), on
``--device`` (``cuda`` by default; ``--device cpu`` runs the kernels'
plain versions).  Each step's loss telemetry is one hand-written
``isla_fold`` launch on the card.  More than one visible device would
build the reference's mesh, shard the step and remesh on a simulated
failure (--fail "step:groups"); that branch waits for ROADMAP Queue A
item 12 and raises ``NotImplementedError``, so the trainer never trains on
one card of several.  Without a mesh --fail changes nothing, as in the
reference.

  PYTHONPATH=src python -m repro_torch.launch.train --reduced \
      --device cpu --steps 5
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import torch

from ..configs import get_config
from ..core.distributed import resolve_device
from ..models import model as model_lib
from ..train import checkpoint as ckpt
from ..train.data import SyntheticStream
from ..train.elastic import FailureInjector, remesh_plan, rescale_batch
from ..train.optimizer import OptimizerConfig, init_opt_state
from ..train.train_step import TrainConfig, train_step

MESH_ITEM = "ROADMAP Queue A item 12"


def _fingerprint(cfg, tcfg) -> str:
    return f"{cfg.name}|{cfg.n_layers}|{cfg.d_model}|{tcfg.opt.lr}"


def _no_mesh(what: str):
    return NotImplementedError(
        f"{what}: the sharded train step and its elastic remesh are "
        f"{MESH_ITEM} (sharding/), not yet ported; make one device visible "
        f"(CUDA_VISIBLE_DEVICES) to train on one card")


def _make_mesh(shape, axis_names):
    raise _no_mesh(f"a {'x'.join(map(str, shape))} mesh over "
                   f"{axis_names}")


def build_step(cfg, tcfg, mesh):
    """The train step and its param placements: ``train_step`` itself
    (no placements) with no mesh."""
    if mesh is None:
        return functools.partial(train_step, cfg, tcfg), None
    raise _no_mesh("a train step sharded over a mesh")


def device_count(device: torch.device) -> int:
    """The devices the trainer would train on: every visible card for
    ``cuda``, one for the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def run(args) -> dict:
    cfg = get_config(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(
        opt=OptimizerConfig(lr=args.lr, warmup_steps=args.warmup,
                            total_steps=args.steps),
        microbatches=args.microbatches,
        isla_telemetry=True, telemetry_exact=args.telemetry_exact,
    )
    device = resolve_device(args.device)
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
    step_fn, _ = build_step(cfg, tcfg, mesh)
    injector = FailureInjector(
        [(int(s.split(":")[0]), int(s.split(":")[1]))
         for s in (args.fail or [])])
    writer = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=3) \
        if args.ckpt_dir else None
    fp = _fingerprint(cfg, tcfg)

    start = 0
    if args.ckpt_dir and args.resume:
        ckpt.clean_tmp(args.ckpt_dir)
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            restored, _ = ckpt.restore(
                args.ckpt_dir, last,
                {"params": params, "opt": opt_state}, device=device,
                fingerprint=fp)
            params, opt_state = restored["params"], restored["opt"]
            start = last
            print(f"[resume] from step {last}")

    history = []
    step = start
    while step < args.steps:
        n_fail = injector.failures_at(step)
        if n_fail and mesh is not None:
            # ---- simulated failure: shrink mesh, restore, replay
            plan = remesh_plan(mesh_shape, ("data", "model"), n_fail)
            print(f"[elastic] step {step}: {plan.note}")
            _, accum = rescale_batch(args.batch, mesh_shape[0],
                                     plan.shape[0])
            mesh_shape = plan.shape
            mesh = _make_mesh(plan.shape, plan.axis_names)
            tcfg = TrainConfig(opt=tcfg.opt,
                               microbatches=tcfg.microbatches * accum,
                               isla_telemetry=tcfg.isla_telemetry)
            step_fn, _ = build_step(cfg, tcfg, mesh)
            if writer:
                writer.wait()
            last = ckpt.latest_step(args.ckpt_dir)
            restored, _ = ckpt.restore(
                args.ckpt_dir, last, {"params": params, "opt": opt_state},
                device=device, fingerprint=fp)
            params, opt_state = restored["params"], restored["opt"]
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
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({dt:.2f}s)"
                  + (f" isla_loss {float(isla):.4f}" if isla is not None
                     else ""), flush=True)
        step += 1
        if writer and step % args.ckpt_every == 0:
            writer.submit(step, {"params": params, "opt": opt_state},
                          fingerprint=fp)
    if writer:
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


def main(argv=None):
    args = parser().parse_args(argv)
    result = run(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
