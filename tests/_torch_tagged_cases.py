"""Tagged-fold cases shared by the CPU tests (``test_torch_tagged.py``)
and the card tests (``test_torch_cuda.py``): a tagged stream, its cuts and
resident rows built from a seed with numpy, and the host carry fold
(``engine._segment_moment_rows`` / ``sample_moments_batch``) that the fold
must match bit for bit in float64.

* ``shuffled`` — a block-major stream of (group, block) cells, shuffled;
* ``drop`` — a tenth of the samples carry the drop segment ``n_cells``;
* ``per_cell`` — two anchors: a (n_cells + 1, 4) cut table, +inf pad row;
* ``on_cut`` — a twentieth of the samples lie exactly on a cut.

Block-major cases (``run_case``), the executor's streams: stacked key
slices in key order, each block by block, with the (key, block) run
lengths that ``TaggedRuns`` takes:

* ``stacked`` — four keys (plain, WHERE, GROUP BY 16, both), some blocks
  missing from the chunk (quota 0);
* ``per_cell`` — the same with a (n_cells + 1, 4) cut table;
* ``empty`` — a WHERE that keeps nothing in some blocks (empty runs);
* ``drop`` — drop-segment samples inside the runs;
* ``long`` — one run of more than 100,000 samples (many staged tiles);
* ``wide`` — a GROUP BY key of 300 groups (more cells than a run
  block's threads).
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


RUN_CASES = ("stacked", "per_cell", "empty", "drop", "long", "wide")
# Keys of the block-major cases: (groups, WHERE).
RUN_KEYS = ((1, False), (1, True), (16, False), (16, True))


def run_case(case: str, rng: np.random.Generator):
    """A block-major tagged stream: ``(values, seg, bounds, prior,
    lengths, key_offsets)`` — the stream and its int32 cell ids, the cut
    table, (n_cells, 11) resident rows, the (n_keys, n_blocks) run lengths
    and the (n_keys + 1,) key offsets (``tagged_run_table``'s
    arguments)."""
    keys = ((300, False), (1, True)) if case == "wide" else RUN_KEYS
    n_b = 3 if case == "long" else 12
    quotas = rng.integers(50, 400, n_b)
    quotas[rng.random(n_b) < 0.25] = 0  # blocks missing from the chunk
    if case == "long":
        quotas[:] = (0, 100_500, 700)
    rows = int(quotas.sum())
    x = rng.normal(100.0, 20.0, rows)
    block = np.repeat(np.arange(n_b), quotas)
    flag = rng.random(rows) < 0.5
    if case == "empty":
        flag[np.isin(block, (1, 4, 7))] = False
    g_max = max(g for g, _ in keys)
    grp = rng.integers(0, g_max, rows)
    offsets = np.concatenate([[0], np.cumsum([g * n_b for g, _ in keys])])
    n_cells = int(offsets[-1])
    vals, segs, lengths = [], [], []
    for (g, where), off in zip(keys, offsets):
        keep = flag if where else np.ones(rows, dtype=bool)
        seg = off + (grp % g) * n_b + block
        v, s = x[keep], seg[keep]
        if case == "drop":
            at = rng.random(v.size) < 0.1
            s = np.where(at, n_cells, s)
        vals.append(v)
        segs.append(s)
        lengths.append(np.bincount(block[keep], minlength=n_b))
    bounds = np.asarray([CUTS[0]])
    if case == "per_cell":
        cut = np.where(np.arange(n_cells)[:, None] % 3 == 0, CUTS[0], CUTS[1])
        bounds = np.concatenate([cut, np.full((1, 4), np.inf)])
    prior = tagged_case("shuffled", rng, n_cells=n_cells, m=n_cells)[3]
    return (np.concatenate(vals), np.concatenate(segs).astype(np.int32),
            bounds, prior, np.stack(lengths), offsets)


# Ways a run table can fail to describe its stream.
WRONG_TABLES = ("boundary", "foreign_id", "other_key", "short", "offsets",
                "negative")


def wrong_table(kind, seg, lengths, offsets):
    """A ``run_case`` stream's ids, run lengths and key offsets spoiled
    the ``kind`` way (one of ``WRONG_TABLES``)."""
    lengths, offsets, seg = lengths.copy(), offsets.copy(), seg.copy()
    if kind == "boundary":  # a run boundary one sample late
        r = np.flatnonzero(lengths.reshape(-1))[2]
        lengths.reshape(-1)[r] += 1
        nxt = r + 1 + np.flatnonzero(lengths.reshape(-1)[r + 1:])[0]
        lengths.reshape(-1)[nxt] -= 1
    elif kind == "foreign_id":  # a sample tagged with another block
        seg[5] = seg[5] + 1
    elif kind == "other_key":  # a sample tagged with another key's cell
        seg[-1] = 0
    elif kind == "short":  # the runs end before the stream
        lengths[-1, np.flatnonzero(lengths[-1])[-1]] -= 1
    elif kind == "offsets":  # key offsets that do not tile the cells
        offsets[2] += 1
    elif kind == "negative":  # a run that ends before it starts
        lengths[0, np.flatnonzero(lengths[0])[0]] *= -1
    return seg, lengths, offsets
