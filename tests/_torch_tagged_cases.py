"""Tagged-fold cases shared by the CPU tests (``test_torch_tagged.py``)
and the card tests (``test_torch_cuda.py``): a tagged stream, its cuts and
resident rows built from a seed with numpy, and the host carry fold
(``engine._segment_moment_rows`` / ``sample_moments_batch``) that the fold
must match bit for bit in float64.

* ``shuffled`` — a block-major stream of (group, block) cells, shuffled;
* ``drop`` — a tenth of the samples carry the drop segment ``n_cells``;
* ``per_cell`` — two anchors: a (n_cells + 1, 4) cut table, +inf pad row;
* ``on_cut`` — a twentieth of the samples lie exactly on a cut.
"""
import numpy as np

from repro_torch.core.engine import _segment_moment_rows, sample_moments_batch
from repro_torch.core.types import Boundaries

CASES = ("shuffled", "drop", "per_cell", "on_cut")
CUTS = ((60.0, 95.0, 105.0, 140.0), (70.0, 99.5, 101.0, 150.0))


def tagged_case(case: str, rng: np.random.Generator, n_cells: int = 120,
                m: int = 6000):
    """``(values, seg, bounds, prior)``: the (m,) float64 stream, its (m,)
    int32 cell ids, the (1, 4) or (n_cells + 1, 4) cut table and
    (n_cells, 11) float64 resident rows (S, L, totals)."""
    values = rng.normal(100.0, 20.0, m)
    seg = rng.permutation(np.repeat(np.arange(n_cells), -(-m // n_cells))
                          [:m]).astype(np.int32)
    bounds = np.asarray([CUTS[0]])
    if case == "drop":
        seg[rng.random(m) < 0.1] = n_cells
    if case == "per_cell":
        rows = np.where(np.arange(n_cells)[:, None] < n_cells // 2,
                        CUTS[0], CUTS[1])
        bounds = np.concatenate([rows, np.full((1, 4), np.inf)])
    if case == "on_cut":
        at = rng.random(m) < 0.05
        values[at] = rng.choice(np.asarray(CUTS[0]), int(at.sum()))
    prior = np.concatenate([rng.integers(0, 50, (n_cells, 1)),
                            rng.normal(0, 1e3, (n_cells, 3)),
                            rng.integers(0, 50, (n_cells, 1)),
                            rng.normal(0, 1e3, (n_cells, 3)),
                            rng.integers(0, 90, (n_cells, 1)),
                            rng.normal(0, 1e3, (n_cells, 2))], axis=1)
    return values, seg, bounds, prior.astype(np.float64)


def host_fold(values, seg, bounds, prior):
    """The host carry fold of one tagged pass onto ``prior`` (n, 11):
    each anchor's cells folded by ``_segment_moment_rows`` over the
    samples of its cells (stream order kept), the totals by
    ``sample_moments_batch``; drop-segment samples fold nowhere."""
    n = prior.shape[0]
    keep = (seg >= 0) & (seg < n)
    v, s = values[keep], seg[keep].astype(np.intp)
    rows_s, rows_l = prior[:, 0:4], prior[:, 4:8]
    cell_cut = np.zeros(n, dtype=np.intp)
    cuts = [bounds[0]]
    if bounds.shape[0] > 1:
        cuts, cell_cut = np.unique(bounds[:n], axis=0, return_inverse=True)
        cell_cut = cell_cut.reshape(-1)
    for i, cut in enumerate(cuts):
        mine = cell_cut[s] == i
        rows_s, rows_l = _segment_moment_rows(
            v[mine], s[mine], n, Boundaries(*(float(c) for c in cut)),
            carry=(rows_s, rows_l))
    totals = sample_moments_batch(v, s, n, carry=prior[:, 8:11])
    return np.concatenate([rows_s, rows_l, totals], axis=1)
