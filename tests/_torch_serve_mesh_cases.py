"""Shared cases of the sharded serving tests: what each gloo rank runs
(``tests/_torch_mesh_lm_cases.py`` spawns the ranks).

``sharded_serving``: for every arch of ``ARCHS`` (reduced, fp32, with
``TP_THRESHOLD``, ``FSDP_THRESHOLD`` and ``FSDP_MIN_ELEMENTS`` at 0 so that
TP, FSDP and the cache's sequence split all act), ``serve_prefill`` of
``PROMPT`` tokens with the activation constraint, then ``DECODE_STEPS``
``serve_decode`` steps, on DTensors placed by ``param_specs``,
``batch_specs`` and ``cache_specs`` on a (2, 2) ``("data", "model")``
mesh, beside the meshless calls on the same inputs (rank 0); or the same
on a one-rank (1, 1) mesh.  Rank 0 writes each step's worst gap (over
the step's scale) for the logits and every cache leaf, whether the mesh
run equals the meshless run bit for bit, and the ``flash_attention``
calls of each."""
import json
import os

import torch

B, PROMPT, S_MAX = 4, 32, 64
DECODE_STEPS = 3
ARCHS = ("olmo-1b", "grok-1-314b", "mamba2-130m", "jamba-1.5-large-398b")
MESH = ((2, 2), ("data", "model"))


def _inputs(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (B, PROMPT + DECODE_STEPS),
                         generator=g)
    return toks


def _gap(got, want) -> float:
    from repro_torch.train.train_step import local_value
    g, w = local_value(got).float(), local_value(want).float()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def _same(got, want) -> bool:
    from repro_torch.train.train_step import local_value
    return bool(torch.equal(local_value(got), local_value(want)))


def serve_run(cfg, params, toks, cache, mesh=None):
    """Prefill then the decode steps: (logits of each call, the cache
    after each call as plain tensors, flash calls).  With ``mesh`` the
    params and cache are placed on it and the batch too."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import ref
    from repro_torch.models import model as TM
    from repro_torch.sharding import (activation_constraint, batch_specs,
                                      cache_specs, param_specs, shardings)
    from repro_torch.sharding.context import use_mesh
    from repro_torch.train.train_step import local_value, place

    calls = []
    flash = ref.flash_attention_ref

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return flash(*a, **k)

    ref.flash_attention_ref = counted
    try:
        constraint = None
        batch = {"tokens": toks[:, :PROMPT]}
        if mesh is not None:
            params = place(params, shardings(
                mesh, param_specs(cfg, mesh, params)))
            cache = place(cache, shardings(mesh, cache_specs(cfg, mesh,
                                                             cache)))
            batch = place(batch, shardings(mesh, batch_specs(cfg, mesh,
                                                             batch)))
            constraint = activation_constraint(cfg, mesh)
        logits, caches = [], []
        with use_mesh(mesh):
            lg, cache = TM.serve_prefill(cfg, params, batch, cache,
                                         constraint=constraint)
            logits.append(local_value(lg))
            caches.append(tree_map(lambda t: local_value(t).clone(), cache))
            for i in range(DECODE_STEPS):
                tok = toks[:, PROMPT + i:PROMPT + i + 1]
                pos = torch.full((B,), PROMPT + i, dtype=torch.int64)
                if mesh is not None:
                    inp = {"token": tok, "pos": pos}
                    inp = place(inp, shardings(mesh, batch_specs(cfg, mesh,
                                                                 inp)))
                    tok, pos = inp["token"], inp["pos"]
                lg, cache = TM.serve_decode(cfg, params, tok, pos, cache)
                logits.append(local_value(lg))
                caches.append(tree_map(lambda t: local_value(t).clone(),
                                       cache))
        placements = [str(getattr(t, "placements", None))
                      for t in tree_leaves(cache)]
    finally:
        ref.flash_attention_ref = flash
    return logits, caches, calls, placements


def sharded_serving(rank, world, out_dir, archs=ARCHS):
    """On four ranks the (2, 2) mesh against the meshless calls (rank 0);
    on one rank a (1, 1) mesh against them.  Rank 0 writes
    ``serving_<world>.json``."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from _torch_mesh_lm_cases import _all_on, config
    _all_on()
    mesh = make_host_mesh(*MESH) if world == 4 else make_host_mesh(
        (1, 1), MESH[1])
    result = {}
    for arch in archs:
        cfg = config(arch)
        params = TM.init_params(cfg, torch.Generator().manual_seed(0))
        toks = _inputs(cfg)

        def fresh():
            return TM.init_cache(cfg, B, S_MAX, dtype=torch.float32,
                                 device="cpu")

        got = serve_run(cfg, params, toks, fresh(), mesh)
        if rank != 0:
            continue
        want = serve_run(cfg, params, toks, fresh())
        rows = []
        for lg, lw, cg, cw in zip(got[0], want[0], got[1], want[1]):
            rows.append({"logits": _gap(lg, lw), "cache": [
                _gap(a, b) for a, b in zip(tree_leaves(cg),
                                           tree_leaves(cw))]})
        result[arch] = {
            "steps": rows, "flash": [got[2], want[2]],
            "placements": got[3],
            "equal": all(_same(a, b) for a, b in zip(got[0], want[0]))
            and all(_same(a, b) for cg, cw in zip(got[1], want[1])
                    for a, b in zip(tree_leaves(cg), tree_leaves(cw)))}
    if rank == 0:
        with open(os.path.join(out_dir, f"serving_{world}.json"), "w") as f:
            json.dump(result, f)
