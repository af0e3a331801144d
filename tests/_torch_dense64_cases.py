"""Float64 fold cases shared by the CPU tests (``test_torch_dense64.py``)
and the card tests (``test_torch_cuda.py``): a dense pane folded for four
stacked keys (plain, WHERE, GROUP BY, WHERE + GROUP BY) onto float64
resident rows, built with numpy from a seed.

The pane is ragged (each row's quota, then zero padding), its values
straddle the cuts, and the GROUP BY key has 5 groups.  ``fold`` runs the
stacked fold on a case through ``isla_fold_stack`` (the kernel on a card
tensor, the plain version on a CPU one), optionally on a subset of the
rows (the compacted launch: only those rows' panes, their cells mapped
back onto the full rows by a ``cell_idx`` map).
"""
import numpy as np
import torch

from repro_torch.kernels.isla_moments import StackKey, isla_fold_stack

G = 5
# (groups, WHERE): plain, WHERE, GROUP BY, WHERE + GROUP BY.
KEYS = ((1, False), (1, True), (G, False), (G, True))
BOUNDS = ((0.6, 0.9, 1.1, 1.4), (0.55, 0.95, 1.05, 1.45))


def stack_keys(n_rows, affine=None):
    """The four keys' ``StackKey`` table over ``n_rows`` pane rows: each
    key's cells after the previous key's, the second key classified by
    the second bounds row, the last one read through ``affine``."""
    keys, o = [], 0
    for k, (g, where) in enumerate(KEYS):
        keys.append(StackKey(g, 0 if g > 1 else -1, 0 if where else -1, o,
                             affine if k == len(KEYS) - 1 else None,
                             k % 2))
        o += g * n_rows
    return keys


def n_cells(n_rows):
    return sum(g for g, _ in KEYS) * n_rows


def fold_case(n_rows, q, seed=0, device="cpu"):
    """A float64 pane of ``n_rows`` rows of up to ``q`` samples with its
    fp32 pad and WHERE masks, int32 GROUP BY ids, float64 cuts table and
    float64 prior rows (one (cells, 11) tensor)."""
    rng = np.random.default_rng(seed)
    quotas = rng.integers(1, q + 1, size=n_rows)
    vmask = np.arange(q)[None, :] < quotas[:, None]

    def t(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt,
                               device=device).contiguous()

    return dict(
        values=t(np.where(vmask, rng.normal(1.0, 0.25, (n_rows, q)), 0.0),
                 torch.float64),
        pad=t(vmask, torch.float32),
        gid=t(np.where(vmask, rng.integers(0, G, (n_rows, q)), 0),
              torch.int32),
        valid=t(np.where(vmask, rng.random((n_rows, q)) < 0.6, 0.0),
                torch.float32),
        bounds=t(BOUNDS, torch.float64),
        prior=t(rng.uniform(0.0, 50.0, (n_cells(n_rows), 11)),
                torch.float64))


def fold(case, rows=None, affine=None, out=None):
    """Fold ``case`` for the four keys onto a copy of its prior rows (or
    onto ``out``) and return them.  ``rows`` (pane row indices, ascending)
    folds only those rows' panes, each cell landing on its full-pane row
    through a ``cell_idx`` map, as the zone-pruned launch does."""
    n = case["values"].shape[0]
    state = case["prior"].clone() if out is None else out
    panes = {k: case[k] for k in ("values", "pad", "gid", "valid")}
    cell_idx = None
    if rows is not None:
        rows = torch.as_tensor(rows, device=state.device)
        panes = {k: v[rows].contiguous() for k, v in panes.items()}
        full = stack_keys(n)
        cell_idx = torch.cat([
            (key.offset + torch.arange(g, device=state.device)[:, None] * n
             + rows[None, :]).reshape(-1)
            for key, (g, _) in zip(full, KEYS)]).to(torch.int32)
    keys = stack_keys(panes["values"].shape[0], affine)
    isla_fold_stack(panes["values"], case["bounds"], state[:, 0:4],
                    state[:, 4:8], state[:, 8:11], keys=keys,
                    pad=panes["pad"], gid_panes=(panes["gid"],),
                    valid_panes=(panes["valid"],), cell_idx=cell_idx)
    return state


def numpy_fold(case, affine=None):
    """The same fold as a float64 numpy loop, cell by cell in sample
    order, onto a copy of the prior rows."""
    v = case["values"].cpu().numpy()
    pad = case["pad"].cpu().numpy() != 0
    gid = case["gid"].cpu().numpy()
    valid = case["valid"].cpu().numpy() != 0
    b = case["bounds"].cpu().numpy()
    out = case["prior"].cpu().numpy().copy()
    n = v.shape[0]
    for key, (g, where) in zip(stack_keys(n, affine), KEYS):
        lo_s, hi_s, lo_l, hi_l = b[key.bound_row]
        for r in range(n):
            for j in range(v.shape[1]):
                if not pad[r, j] or (where and not valid[r, j]):
                    continue
                x = v[r, j]
                if key.affine is not None:
                    x = x * key.affine[0] + key.affine[1]
                cell = key.offset + (gid[r, j] if g > 1 else 0) * n + r
                cols = [1.0, x, x * x]
                row = out[cell]
                if lo_s < x < hi_s:
                    row[0:4] += cols + [x * x * x]
                if lo_l < x < hi_l:
                    row[4:8] += cols + [x * x * x]
                row[8:11] += cols
    return out
