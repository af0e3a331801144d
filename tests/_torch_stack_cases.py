"""Stacked-key cases for the ``isla_fold_stack`` / ``isla_sketch_stack``
tests, on the CPU and on the card: a dense tick's panes and resident
state made from a numpy seed, and the same stack written out key by key
through the one-key ``isla_fold`` / ``isla_sketch`` calls (the fold loop
the dense tick ran before its keys shared one launch).

Pad lanes carry garbage on purpose — values, ids far out of range, random
predicate bits — so a kernel that folds, hashes or addresses a dead lane
shows up as a row that differs.
"""
import numpy as np
import torch

from repro_torch.core import distributed as D
from repro_torch.core import sketch as SK
from repro_torch.kernels import isla_moments as K

# Per key: (n_groups, gid slot, valid slot, affine, bound slot).
STACKS = {
    "groups_1_1_3_3": [(1, -1, -1, (1.0, 0.0), 0),
                       (1, -1, 0, (1.25, 0.1), 1),
                       (3, 0, -1, (1.0, 0.0), 0),
                       (3, 1, 1, (0.8, -0.05), 1)],
    # The serving loop's four keys: plain, WHERE, GROUP BY, both.
    "loop": [(1, -1, -1, (1.0, 0.0), 0), (1, -1, 0, (1.0, 0.0), 0),
             (16, 0, -1, (1.0, 0.0), 0), (16, 0, 0, (1.0, 0.0), 0)],
    # Wide GROUP BYs: more cells a row than the fold holds at once, and a
    # pane of more groups than it buckets (its ids reach 300 on the
    # 200-group key, which match no group there).
    "wide": [(1, -1, -1, (1.0, 0.0), 0), (200, 0, 0, (1.0, 0.0), 0),
             (300, 1, -1, (0.8, -0.05), 1)],
}


def stack_case(rng, device, stack="groups_1_1_3_3", n_b=9, q=40,
               compacted=False, bf16=False):
    """A dense tick's operands: ``panes`` (values, pad, gid panes, valid
    panes, bounds), the ``fold_panes`` keywords ``kw``, the resident
    ``prior`` rows (n_cells, 11), the int64 ``bits`` pane and the
    resident register plane ``regs0``."""
    keys = STACKS[stack]
    n_groups = max(k[0] for k in keys)
    active = np.arange(n_b)
    if compacted:
        active = np.sort(rng.choice(n_b, size=n_b // 2, replace=False))
    a_pad = -(-active.size // 4) * 4 + 2  # pad rows drop
    rows = a_pad if compacted else n_b
    quota = rng.integers(1, q + 1, size=rows)
    quota[min(2, rows - 1)] = q
    if compacted:
        quota[active.size:] = 0
    live = np.arange(q)[None, :] < quota[:, None]
    shape = (rows, q)
    raw = np.round(rng.normal(1.0, 0.2, shape) * 64.0) / 64.0
    gid = [np.where(live, rng.integers(0, n_groups, shape),
                    rng.integers(-1000, 1000, shape)) for _ in range(2)]
    if stack == "wide":  # pane 0 holds ids of the 200-group key and past it
        gid[0] = np.where(live, rng.integers(0, 260, shape), gid[0])
    valid = [np.where(live, rng.random(shape) < 0.6, rng.random(shape) < 0.5)
             for _ in range(2)]

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    n_cells = sum(k[0] * n_b for k in keys)
    kw = dict(n_groups_list=tuple(k[0] for k in keys),
              gid_slots=tuple(k[1] for k in keys),
              valid_slots=tuple(k[2] for k in keys),
              key_affine=tuple(k[3] for k in keys),
              bound_slots=tuple(k[4] for k in keys), active_cells=None)
    if compacted:
        ext = np.full(a_pad, -1)
        ext[:active.size] = active
        parts, o = [], 0
        for g, *_ in keys:
            idx = o + np.arange(g)[:, None] * n_b + ext[None, :]
            parts.append(np.where(ext[None, :] < 0, n_cells, idx).reshape(-1))
            o += g * n_b
        kw["active_cells"] = (t(np.concatenate(parts), torch.int32), None)
    panes = (t(raw, torch.bfloat16 if bf16 else torch.float32), t(live),
             tuple(t(g, torch.int32) for g in gid), tuple(t(v) for v in valid),
             t([[0.6, 0.9, 1.1, 1.4], [0.75, 0.95, 1.05, 1.3]]))
    bits = np.round(rng.normal(100.0, 30.0, shape) * 4.0) / 4.0
    return dict(panes=panes, kw=kw, n_b=n_b,
                prior=t(rng.uniform(0, 5, (n_cells, 11))),
                bits=t(bits.view(np.int64), torch.int64),
                regs0=t(rng.integers(0, 12, (n_cells, SK.M)), torch.uint8))


def fold_key_by_key(state, panes, kw) -> None:
    """The stack's fold, one ``isla_fold`` call per key onto its rows of
    ``state`` ((n_cells, 11) fp32), as the dense tick folded before its
    keys shared one launch."""
    values, pad, gids, valids, bounds = panes
    n_b = values.shape[0]
    o = 0
    for g, gs, vs, (ratio, off), brow in zip(
            kw["n_groups_list"], kw["gid_slots"], kw["valid_slots"],
            kw["key_affine"], kw["bound_slots"]):
        fkw = dict(pad=pad, valid=None if vs < 0 else valids[vs],
                   gid=None if g == 1 else gids[gs], n_groups=g,
                   affine=(None if ratio == 1.0 and off == 0.0
                           else (ratio, off)))
        if kw["active_cells"] is None:
            rows = state[o:o + g * n_b]
            K.isla_fold(values, bounds[brow], rows[:, 0:4], rows[:, 4:8],
                        rows[:, 8:11], **fkw)
        else:
            K.isla_fold(values, bounds[brow], state[:, 0:4], state[:, 4:8],
                        state[:, 8:11],
                        cell_idx=kw["active_cells"][0][o:o + g * n_b], **fkw)
        o += g * n_b


def fold_stacked(state, panes, kw) -> None:
    """The same fold through ``distributed.fold_panes`` (one launch)."""
    D.fold_panes(state[:, 0:4], state[:, 4:8], state[:, 8:11], *panes,
                 **kw)


def sketch_key_by_key(regs, bits, panes, kw) -> None:
    """The stack's register merge, one ``isla_sketch`` call per key."""
    _, pad, gids, valids, _ = panes
    n_b = bits.shape[0]
    o = 0
    for g, gs, vs in zip(kw["n_groups_list"], kw["gid_slots"],
                         kw["valid_slots"]):
        skw = dict(pad=pad, valid=None if vs < 0 else valids[vs],
                   gid=None if g == 1 else gids[gs], n_groups=g)
        if kw["active_cells"] is None:
            K.isla_sketch(bits, regs[o:o + g * n_b], **skw)
        else:
            K.isla_sketch(bits, regs,
                          cell_idx=kw["active_cells"][0][o:o + g * n_b],
                          **skw)
        o += g * n_b


def sketch_stacked(regs, bits, panes, kw) -> None:
    """The same merge through ``distributed.sketch_panes``."""
    _, pad, gids, valids, _ = panes
    D.sketch_panes(regs, bits, pad, gids, valids,
                   n_groups_list=kw["n_groups_list"],
                   gid_slots=kw["gid_slots"], valid_slots=kw["valid_slots"],
                   active_cells=kw["active_cells"])
