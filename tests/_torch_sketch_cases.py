"""Hash-pane cases for the ``isla_sketch`` tests, on the CPU and on the
card: the kernel's inputs made from a numpy seed, and the registers the
port's numpy host twin (``sketch.hash_values`` / ``encode`` and an
``np.maximum.at`` merge) says they must hold afterwards.

Pad lanes carry garbage on purpose — real-looking values, ids far out of
range, random predicate bits — so a kernel that hashes or addresses a
dead lane shows up as a register that differs.
"""
import numpy as np
import torch

from repro_torch.core import sketch as SK

SKETCH_CASES = ("dense", "grouped", "predicated", "compacted", "prior")


def sketch_case(case, rng, device, n_rows=37, q=300, n_groups=5):
    """``(panes, kw, prior, want)``: ``isla_sketch(*panes, regs, **kw)``
    on ``regs = prior.clone()`` must leave ``want`` (numpy uint8)."""
    quota = rng.integers(1, q, size=n_rows)
    quota[3] = 0                                  # a row with no lane
    live = np.arange(q)[None, :] < quota[:, None]
    raw = np.round(rng.normal(100.0, 30.0, (n_rows, q)) * 4.0) / 4.0
    raw[~live] = rng.normal(100.0, 30.0, int((~live).sum()))

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    kw = dict(pad=t(live))
    cell = np.broadcast_to(np.arange(n_rows)[:, None], live.shape)
    n_out = n_rows
    if case in ("grouped", "predicated", "compacted"):
        g = rng.integers(0, n_groups, live.shape)
        gid = np.where(live, g, rng.integers(-1000, 1000, live.shape))
        kw.update(gid=t(gid, torch.int32), n_groups=n_groups)
        cell = g * n_rows + cell
        n_out = n_groups * n_rows
    if case in ("predicated", "compacted"):
        valid = rng.random(live.shape) < 0.6
        kw["valid"] = t(valid)
        live = live & valid
    if case == "compacted":
        idx = rng.permutation(2 * n_out)[:n_out] - n_out // 2
        kw["cell_idx"] = t(idx, torch.int32)
        cell = idx[cell]
        n_out = 2 * n_out
        live = live & (cell >= 0) & (cell < n_out)
    prior = (np.zeros((n_out, SK.M), np.uint8) if case == "dense" else
             rng.integers(0, 12, (n_out, SK.M)).astype(np.uint8))
    want = prior.copy()
    j, rho = SK.encode(SK.hash_values(raw[live]))
    np.maximum.at(want, (cell[live], j), rho)
    panes = (t(raw.view(np.int64), torch.int64),)
    return panes, kw, t(prior, torch.uint8), want
