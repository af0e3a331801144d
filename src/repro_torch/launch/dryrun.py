"""Multi-pod dry run: trace every (arch x shape x mesh) cell as rank 0 of
the production mesh (``repro.launch.dryrun`` in torch).

The reference lowers and compiles each cell's SPMD program for 256 or 512
forced host devices and reads XLA's per-device memory and cost analyses.
The port has no compiler: a cell is traced eagerly as rank 0 of a fake
process group of 256 or 512 ranks (``torch.testing``'s ``fake`` backend:
every collective returns at once), on a ``DeviceMesh`` whose DTensors
hold fake local shards (``FakeTensorMode``: shapes and dtypes, no data).
Nothing is allocated on a card and nothing is launched: the hand-written
kernels' wrappers infer their outputs' shapes from fake inputs and record
their cost.  ``roofline.op_cost.CostCounter`` counts rank 0's local work
while the step runs: "lower" here means "trace".

The mesh is on ``cuda`` where torch was built with CUDA, a card or not;
a CPU-only build traces on ``cpu`` (its indexing refuses fake CUDA
tensors), where DTensor turns each all-to-all into an all-gather and a
chunk, as it does for gloo.  The cell records which (``trace_device``).

Per cell this writes <out>/<arch>__<shape>__<mesh>.json with the
reference's meta keys, ``status`` (ok / skip / fail, with ``reason`` or
``error`` and ``traceback``), ``t_trace_s``, ``memory_analysis`` (rank
0's bytes: arguments and outputs from the local shards, aliases from what
the reference donates, temporaries from the trace's peak of live fake
bytes above the arguments), ``cost_analysis``, ``roofline``
(``roofline.analysis`` on the H100) and the kernels' records; and, unless
``--no-hlo``, <cell>.ops.json.gz: each op's count, flops and bytes, the
largest first (the counterpart of the reference's optimized HLO).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import json
import math
import time
import traceback

import torch

from ..configs import SHAPES, get_config, list_archs, shape_applicable
from ..core.tree import tree_leaves, tree_map
from ..models import model as model_lib
from ..roofline.analysis import analyze_cell
from ..roofline.op_cost import CostCounter
from ..sharding import (activation_constraint, batch_specs, cache_specs,
                        opt_state_specs, param_specs, shardings)
from ..sharding.context import local_shape, use_mesh
from ..sharding.specs import fit_placements
from ..train.optimizer import abstract_opt_state
from ..train.train_step import TrainConfig, make_jit_train_step
from .mesh import PRODUCTION, make_production_mesh, mesh_devices
from .specs_io import input_specs

OUT_DIR = os.environ.get("DRYRUN_OUT", "dryrun_out_torch")


def trace_device() -> str:
    """``cuda`` where torch was built with CUDA, else ``cpu``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks
    (its collectives return at once, moving nothing), destroyed on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _fake_dtensors(mesh, tree, spec_fn, cfg, fake_mode, device):
    """``tree``'s ``meta`` leaves as DTensors of fake local shards in the
    placements of ``spec_fn``, and the ``MeshSharding`` tree."""
    from torch.distributed.tensor import DTensor
    sh = shardings(mesh, spec_fn(cfg, mesh, tree))

    def one(a, s):
        pl = fit_placements(s.placements, a.shape)
        shape = local_shape(a.shape, mesh, pl)
        with fake_mode:
            local = torch.empty(shape, dtype=a.dtype, device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=a.shape, stride=a.stride())

    return tree_map(one, tree, sh), sh


def cell_program(cfg, kind: str, mesh, param_sh, opt_sh=None,
                 batch_sh=None, tcfg: TrainConfig = TrainConfig()):
    """(the function one cell runs, the positions of the arguments the
    reference donates): train ``step(params, opt, batch)`` (the sharded
    step, ISLA telemetry included), prefill ``(params, batch, cache)``
    with the activation constraint, decode ``(params, token, pos,
    cache)``."""
    if kind == "train":
        return make_jit_train_step(cfg, tcfg, mesh, param_sh, opt_sh,
                                   batch_sh,
                                   activation_constraint(cfg, mesh)), (0, 1)
    if kind == "prefill":
        constraint = activation_constraint(cfg, mesh)
        return (lambda params, batch, cache: model_lib.serve_prefill(
            cfg, params, batch, cache, constraint=constraint)), (2,)
    return (lambda params, token, pos, cache: model_lib.serve_decode(
        cfg, params, token, pos, cache)), (3,)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               tcfg: TrainConfig = TrainConfig()):
    """Trace one cell as rank 0 of the production mesh (a fake process
    group of its size must be up, ``fake_world``): (counter, meta, cfg,
    memory analysis)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    device = trace_device()
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    spec = input_specs(cfg, shape_name)
    kind = spec["kind"]
    meta = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "devices": mesh_devices(mesh),
        "params": cfg.n_params(), "active_params": cfg.n_active_params(),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": kind,
    }
    fm = FakeTensorMode()
    aparams = model_lib.abstract_params(cfg)
    params, param_sh = _fake_dtensors(mesh, aparams, param_specs, cfg, fm,
                                      device)
    batch, batch_sh = _fake_dtensors(mesh, spec["batch"], batch_specs, cfg,
                                     fm, device)
    opt_sh = None
    if kind == "train":
        opt, opt_sh = _fake_dtensors(mesh, abstract_opt_state(aparams),
                                     opt_state_specs, cfg, fm, device)
        args = (params, opt, batch)
    else:
        cache, _ = _fake_dtensors(mesh, spec["cache"], cache_specs, cfg, fm,
                                  device)
        args = ((params, batch, cache) if kind == "prefill" else
                (params, batch["token"], batch["pos"], cache))
    fn, donated = cell_program(cfg, kind, mesh, param_sh, opt_sh, batch_sh,
                               tcfg)
    counter = CostCounter()
    with use_mesh(mesh), fm, counter:
        out = fn(*args)
    memory = {
        "argument_size_in_bytes": _local_bytes(args),
        "output_size_in_bytes": _local_bytes(out),
        "temp_size_in_bytes": counter.peak_bytes,
        "generated_code_size_in_bytes": 0,
        "alias_size_in_bytes": _local_bytes([args[i] for i in donated]),
    }
    return counter, meta, cfg, memory


def cost_analysis(counter: CostCounter) -> dict:
    """The cell's ``cost_analysis``: XLA's two keys the reference reads
    (``flops``, ``bytes accessed``), then the collectives and the flops by
    dtype."""
    c = counter.cost
    return {"flops": c.flops, "bytes accessed": c.hbm_bytes,
            "collective_bytes": dict(c.coll_bytes),
            "collective_counts": dict(c.coll_counts),
            "flops_by_dtype": dict(c.flops_by_dtype),
            "unknown_trip_whiles": c.unknown_trip_whiles}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, save_hlo: bool = True) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, SHAPES[shape_name])
    if not ok:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "skip", "reason": why}
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        return result
    t0 = time.time()
    try:
        with fake_world(math.prod(PRODUCTION[multi_pod][0])):
            counter, meta, cfg, memory = lower_cell(arch, shape_name,
                                                    multi_pod)
        result = dict(meta)
        result.update({
            "status": "ok",
            "trace_device": trace_device(),
            "t_trace_s": round(time.time() - t0, 2),
            "memory_analysis": memory,
            "cost_analysis": cost_analysis(counter),
            "roofline": analyze_cell(counter.cost, cfg, SHAPES[shape_name],
                                     meta),
            "kernels": counter.kernels,
        })
        if save_hlo:
            ops_path = out_path.replace(".json", ".ops.json.gz")
            counter.write_ops(ops_path)
            result["ops_path"] = ops_path
    except Exception as e:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "fail",
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Trace each (arch x shape x mesh) cell as rank 0 of "
                    "the production mesh on fake tensors and write its "
                    "per-device cost and roofline on the H100.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the per-op table (<cell>.ops.json.gz, the "
                         "port's counterpart of the reference's .hlo.gz)")
    ap.add_argument("--out", default=OUT_DIR,
                    help="output directory (default: $DRYRUN_OUT or "
                         "dryrun_out_torch)")
    return ap


def _fake_device_init() -> None:
    """Make torch's fake CUDA tensors ready before any cell, and start the
    card's peak count after it: the first fake CUDA tensor makes torch
    create and free one real 4-byte tensor to initialise the context
    (``fake_tensor.init_gpu_context``), the only card allocation of a
    run; the cells themselves allocate none."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        torch.empty(1, device="cuda")
    torch.cuda.reset_peak_memory_stats()


def main(argv=None):
    args = parser().parse_args(argv)
    on_card = torch.cuda.is_available() and trace_device() == "cuda"
    if on_card:
        _fake_device_init()
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                r = run_cell(arch, shape, mp, args.out, force=args.force,
                             save_hlo=not args.no_hlo)
                status = r.get("status")
                line = (f"{arch:24s} {shape:12s} "
                        f"{'multi ' if mp else 'single'} -> {status}")
                if status == "ok":
                    ca, rf = r["cost_analysis"], r["roofline"]
                    line += (f"  flops/dev={ca['flops']:.3e}"
                             f"  bytes/dev={ca['bytes accessed']:.3e}"
                             f"  coll/dev={rf['collective_bytes_per_dev']:.3e}"
                             f"  {rf['dominant']}-bound"
                             f" {rf['step_time_bound_s']:.4g}s"
                             f"  trace={r['t_trace_s']}s")
                elif status == "fail":
                    line += "  " + r.get("error", "")[:160]
                    failures += 1
                elif status == "skip":
                    line += "  " + r.get("reason", "")
                print(line, flush=True)
    if on_card:
        print(f"dryrun: card bytes over the cells: "
              f"torch.cuda.max_memory_allocated() = "
              f"{torch.cuda.max_memory_allocated()}, held after them "
              f"{torch.cuda.memory_allocated()}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
