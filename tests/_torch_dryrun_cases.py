"""Shared cases of the dry-run tests: the reduced cells, the reference's
dry run on them (run in a subprocess with four forced host devices), and
the gloo ranks that run the same sharded programs for real.

A reduced cell is a reduced config at a small shape (``SMALL``: the
shape names kept, their sizes cut) on a (2, 2) ``("data", "model")``
mesh.  ``reference_main`` patches ``repro.launch.dryrun``'s
``get_config`` (reduced configs), ``make_production_mesh`` (a (2, 2)
mesh of the four host devices) and ``SHAPES`` (in place), lowers and
compiles each cell and writes ``hlo_parse.parse_and_cost`` of its HLO.
``port_cells`` runs ``launch.dryrun.run_cell`` patched the same way
(``patch_port``), on a ``cpu`` mesh (where DTensor takes gloo's paths,
and a CPU-only torch refuses fake CUDA tensors' indexing).  Both sides set
``TP_THRESHOLD`` to 0: the reduced configs are below it, and without TP
the port's sequence constraint gathers S before each product, so every
"model" rank would compute its data group's whole products (the
reference's GSPMD keeps them split); with TP both split them alike.

``gloo_collectives`` runs the port's cell programs
(``launch.dryrun.cell_program``) for real on four gloo ranks, with
``TP_THRESHOLD``, ``FSDP_THRESHOLD`` and ``FSDP_MIN_ELEMENTS`` at 0, under
``chip_smoke.CollectiveCounter``; ``fake_collectives`` traces the same
cells on a fake four-rank group under the same thresholds."""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("olmo-1b", "mamba2-130m", "grok-1-314b", "jamba-1.5-large-398b")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
# shape name -> (seq_len, global_batch, kind)
SMALL = {"train_4k": (256, 8, "train"), "prefill_32k": (256, 4, "prefill"),
         "decode_32k": (256, 8, "decode"), "long_500k": (512, 1, "decode")}
MESH = ((2, 2), ("data", "model"))


def reference_main(out_path):
    """The reference's ``lower_cell`` + ``compile`` + ``parse_and_cost``
    on every reduced cell (env ``XLA_FLAGS_EXTRA`` forces 4 devices)."""
    import numpy as np
    import repro.launch.dryrun as D
    import jax
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.roofline.hlo_parse import parse_and_cost
    import repro.sharding.specs as RS
    assert jax.device_count() == 4, jax.device_count()
    RS.TP_THRESHOLD = 0
    for name, (s, b, kind) in SMALL.items():
        D.SHAPES[name] = ShapeConfig(name, s, b, kind)
    D.get_config = lambda arch: get_config(arch, reduced=True)
    D.make_production_mesh = lambda multi_pod=False: Mesh(
        np.array(jax.devices()[:4]).reshape(MESH[0]), MESH[1])
    out = {}
    for arch in ARCHS:
        for shape in KINDS:
            lowered, meta, cfg = D.lower_cell(arch, shape, False)
            cost = parse_and_cost(lowered.compile().as_text())
            out[f"{arch}/{shape}"] = {
                "flops": cost.flops, "coll_counts": cost.coll_counts,
                "coll_bytes": cost.coll_bytes}
    with open(out_path, "w") as f:
        json.dump(out, f)


def patch_port(monkeypatch):
    """The port's dry run patched as the reference's is, through a
    ``pytest.MonkeyPatch``: reduced configs, ``SHAPES`` cut, the
    single-pod ``PRODUCTION`` mesh (2, 2), TP on (``TP_THRESHOLD`` 0) and
    the trace on ``cpu``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.launch import dryrun, mesh
    from repro_torch.sharding import specs
    for name, (s, b, kind) in SMALL.items():
        monkeypatch.setitem(SHAPES, name, ShapeConfig(name, s, b, kind))
    monkeypatch.setitem(mesh.PRODUCTION, False, MESH)
    monkeypatch.setattr(specs, "TP_THRESHOLD", 0)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, reduced=True))
    monkeypatch.setattr(dryrun, "trace_device", lambda: "cpu")


def port_cells(out_dir, archs=ARCHS, kinds=KINDS):
    """``run_cell`` of each reduced cell (patched as ``patch_port``):
    {arch/shape: cell JSON}."""
    from repro_torch.launch import dryrun
    return {f"{arch}/{shape}": dryrun.run_cell(arch, shape, False,
                                               str(out_dir), force=True)
            for arch in archs for shape in kinds}


def _inputs(cfg, kind, mesh, seed=0):
    """Real inputs of a reduced cell on ``mesh``: params (and optimizer
    state) from a seeded init, a seeded batch, a zero cache, each placed
    by its specs; with the program's placements."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.models import model as TM
    from repro_torch.sharding import (batch_specs, cache_specs,
                                      opt_state_specs, param_specs,
                                      shardings)
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import place
    shape = SHAPES[kind]
    B, S = shape.global_batch, shape.seq_len
    g = torch.Generator().manual_seed(seed)
    params = TM.init_params(cfg, g)
    p_sh = shardings(mesh, param_specs(cfg, mesh, params))
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g)
    if shape.kind == "train":
        batch = {"tokens": toks, "labels": toks.roll(1, 1)}
        opt = init_opt_state(params)
        o_sh = shardings(mesh, opt_state_specs(cfg, mesh, opt))
        b_sh = shardings(mesh, batch_specs(cfg, mesh, batch))
        return (place(params, p_sh), place(opt, o_sh), place(batch, b_sh)
                ), (p_sh, o_sh, b_sh)
    cache = TM.init_cache(cfg, B, S, device="cpu")
    cache = place(cache, shardings(mesh, cache_specs(cfg, mesh, cache)))
    if shape.kind == "prefill":
        batch = {"tokens": toks}
        b_sh = shardings(mesh, batch_specs(cfg, mesh, batch))
        return (place(params, p_sh), place(batch, b_sh), cache), (p_sh,
                                                                  None, b_sh)
    inp = {"token": toks[:, :1],
           "pos": torch.full((B,), S // 2, dtype=torch.int64)}
    inp = place(inp, shardings(mesh, batch_specs(cfg, mesh, inp)))
    return (place(params, p_sh), inp["token"], inp["pos"], cache), (
        p_sh, None, None)


def _patch_shapes():
    from repro_torch.configs.base import SHAPES, ShapeConfig
    for name, (s, b, kind) in SMALL.items():
        SHAPES[name] = ShapeConfig(name, s, b, kind)


def _all_on():
    from repro_torch.sharding import specs as SP
    SP.TP_THRESHOLD = SP.FSDP_THRESHOLD = SP.FSDP_MIN_ELEMENTS = 0


def gloo_collectives(rank, world, out_dir, arch, kinds=KINDS):
    """Each cell's program run for real on (2, 2) gloo ranks under
    ``CollectiveCounter``: rank 0 writes {shape: {op: {count, bytes}}}."""
    sys.path.insert(0, ROOT)
    from chip_smoke import CollectiveCounter
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.context import use_mesh
    _patch_shapes()
    _all_on()
    cfg = get_config(arch, reduced=True)
    mesh = make_host_mesh(*MESH)
    out = {}
    for shape in kinds:
        args, (p_sh, o_sh, b_sh) = _inputs(cfg, shape, mesh)
        fn, _ = dryrun.cell_program(cfg, SHAPES[shape].kind, mesh, p_sh,
                                    o_sh, b_sh)
        with use_mesh(mesh), CollectiveCounter() as cc:
            fn(*args)
        out[shape] = cc.counts
    if rank == 0:
        with open(os.path.join(out_dir, f"gloo_{arch}.json"), "w") as f:
            json.dump(out, f)


def fake_collectives(arch, out_dir, kinds=KINDS):
    """The same cells traced on a fake four-rank group (a ``cpu`` mesh, as
    gloo's): {shape: {op: {count, bytes}}} from the counter's op table."""
    from repro_torch.launch import dryrun
    cells = {}
    for shape in kinds:
        r = dryrun.run_cell(arch, shape, False, str(out_dir), force=True)
        assert r["status"] == "ok", r.get("traceback")
        import gzip
        with gzip.open(r["ops_path"], "rt") as f:
            ops = json.load(f)
        cells[shape] = {row["op"].split(".")[-1]: {
            "count": row["count"], "bytes": row["in_bytes"]}
            for row in ops if row["op"].startswith("_c10d_functional.")
            and "wait" not in row["op"]}
    return cells
