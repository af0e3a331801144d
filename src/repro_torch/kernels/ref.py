"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its CUDA kernel computes, in ordinary
tensor ops: the wrappers in ``isla_moments.py`` and ``flash_attention.py``
run these for CPU tensors (the tests), and ``chip_smoke.py`` holds each
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

F32 = torch.float32


def chunk_columns(chunks: Tuple[int, int, int],
                  device=None) -> torch.Tensor:
    """Column indices a ``(chunk_len, chunk_stride, n_chunks)`` read
    visits: ``n_chunks`` contiguous runs of ``chunk_len`` elements, the
    c-th starting at ``c * chunk_stride``."""
    chunk_len, chunk_stride, n_chunks = chunks
    starts = torch.arange(n_chunks, device=device) * chunk_stride
    return (starts[:, None]
            + torch.arange(chunk_len, device=device)[None, :]).reshape(-1)


def fold_delta(values: torch.Tensor, bounds: torch.Tensor, *,
               pad: Optional[torch.Tensor] = None,
               valid: Optional[torch.Tensor] = None,
               gid: Optional[torch.Tensor] = None, n_groups: int = 1,
               affine: Optional[Tuple[float, float]] = None,
               chunks: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """The fold's per-cell sums, ``(n_groups * R, 11)`` fp32, cell
    ``group * R + row`` — the weight columns of ``_dense_core`` (S and L
    count/v/v^2/v^3, then count/v/v^2 of every sample) contracted over the
    sample axis against the GROUP BY one-hot."""
    x = values if chunks is None else values[:, chunk_columns(
        chunks, values.device)]
    v = x.to(F32)
    if affine is not None:
        ratio = torch.tensor(affine[0], dtype=F32, device=v.device)
        off = torch.tensor(affine[1], dtype=F32, device=v.device)
        v = v * ratio + off
    b = bounds.to(F32).reshape(-1, 4)
    s_lo, s_hi, l_lo, l_hi = (b[:, k:k + 1] for k in range(4))
    m = torch.ones_like(v)
    if pad is not None:
        m = m * pad
    if valid is not None:
        m = m * valid
    ms = ((v > s_lo) & (v < s_hi)).to(F32) * m
    ml = ((v > l_lo) & (v < l_hi)).to(F32) * m
    v2 = v * v
    v3 = v2 * v
    w = torch.stack([ms, v * ms, v2 * ms, v3 * ms,
                     ml, v * ml, v2 * ml, v3 * ml,
                     m, v * m, v2 * m], dim=-1)          # (R, Q, 11)
    if gid is None:
        return w.sum(dim=1)
    oh = (gid.to(torch.int64)[..., None]
          == torch.arange(n_groups, device=v.device)).to(F32)  # (R, Q, G)
    blk = torch.einsum("rqk,rqg->grk", w, oh)           # (G, R, 11)
    return blk.reshape(n_groups * v.shape[0], 11)


def isla_fold_ref(values: torch.Tensor, bounds: torch.Tensor,
                  out_s: torch.Tensor, out_l: torch.Tensor,
                  out_t: Optional[torch.Tensor] = None, *,
                  pad: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None,
                  gid: Optional[torch.Tensor] = None, n_groups: int = 1,
                  affine: Optional[Tuple[float, float]] = None,
                  cell_idx: Optional[torch.Tensor] = None,
                  chunks: Optional[Tuple[int, int, int]] = None) -> None:
    """Plain version of the ``isla_fold`` kernel: add the fold's sums in
    place onto ``out_s`` / ``out_l`` (and ``out_t``), row ``cell`` or row
    ``cell_idx[cell]`` — out-of-range map entries drop."""
    delta = fold_delta(values, bounds, pad=pad, valid=valid, gid=gid,
                       n_groups=n_groups, affine=affine, chunks=chunks)
    if cell_idx is None:
        rows = torch.arange(delta.shape[0], device=delta.device)
    else:
        rows = cell_idx.to(torch.int64)
        keep = (rows >= 0) & (rows < out_s.shape[0])
        rows, delta = rows[keep], delta[keep]
    out_s[rows] += delta[:, 0:4]
    out_l[rows] += delta[:, 4:8]
    if out_t is not None:
        out_t[rows] += delta[:, 8:11]


def _key_panes(key, pad, gid_panes, valid_panes) -> dict:
    return dict(pad=pad,
                valid=None if key.valid_slot < 0
                else valid_panes[key.valid_slot],
                gid=None if key.gid_slot < 0 else gid_panes[key.gid_slot],
                n_groups=key.n_groups)


def isla_fold_stack_ref(values: torch.Tensor, bounds: torch.Tensor,
                        out_s: torch.Tensor, out_l: torch.Tensor,
                        out_t: Optional[torch.Tensor] = None, *, keys,
                        pad: Optional[torch.Tensor] = None, gid_panes=(),
                        valid_panes=(),
                        cell_idx: Optional[torch.Tensor] = None,
                        chunks: Optional[Tuple[int, int, int]] = None
                        ) -> None:
    """Plain version of the stacked ``isla_fold`` launch: ``isla_fold_ref``
    key by key, each key on its own rows (``offset + g * R + r``, or
    those entries of ``cell_idx``), cuts row ``bound_row`` of ``bounds``
    (-1: per-row cuts) and its own affine and panes."""
    n_rows = values.shape[0]
    for k in keys:
        rows = slice(k.offset, k.offset + k.n_groups * n_rows)
        kw = dict(_key_panes(k, pad, gid_panes, valid_panes),
                  affine=k.affine, chunks=chunks)
        b = bounds if k.bound_row < 0 else bounds[k.bound_row]
        if cell_idx is None:
            isla_fold_ref(values, b, out_s[rows], out_l[rows],
                          None if out_t is None else out_t[rows], **kw)
        else:
            isla_fold_ref(values, b, out_s, out_l, out_t,
                          cell_idx=cell_idx[rows], **kw)


def isla_sketch_ref(bits: torch.Tensor, regs: torch.Tensor, *,
                    pad: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None,
                    gid: Optional[torch.Tensor] = None, n_groups: int = 1,
                    cell_idx: Optional[torch.Tensor] = None) -> None:
    """Plain version of the ``isla_sketch`` kernel: hash every live lane
    of the (R, Q) int64 bits pane (the torch limb twin of splitmix64),
    encode ``(j, rho)`` and merge ``regs[cell, j] = max(regs[cell, j],
    rho)`` in place, ``cell = gid * R + row`` or ``cell_idx[cell]``.  Dead
    lanes (pad or valid 0, an id outside ``[0, n_groups)``, a map entry
    outside ``regs``) carry rho = 0 onto cell 0 — the merge's neutral
    element, so nothing is gathered and nothing syncs."""
    from ..core.sketch import M, bits_limbs, encode_graph, splitmix64_graph

    j, rho = encode_graph(*splitmix64_graph(*bits_limbs(bits)))
    n_rows, q = bits.shape
    ok = torch.ones((n_rows, q), dtype=torch.bool, device=bits.device)
    if pad is not None:
        ok &= pad != 0
    if valid is not None:
        ok &= valid != 0
    cell = torch.arange(n_rows, device=bits.device)[:, None].expand(n_rows, q)
    if gid is not None:
        ok &= (gid >= 0) & (gid < n_groups)
        cell = torch.where(ok, gid.to(torch.int64), 0) * n_rows + cell
    if cell_idx is not None:
        cell = cell_idx.to(torch.int64)[cell]
        ok &= (cell >= 0) & (cell < regs.shape[0])
    flat = (torch.where(ok, cell, 0) * M + j).reshape(-1)
    regs.view(-1).scatter_reduce_(
        0, flat, torch.where(ok, rho, 0).reshape(-1), reduce="amax")


def isla_sketch_stack_ref(bits: torch.Tensor, regs: torch.Tensor, *, keys,
                          pad: Optional[torch.Tensor] = None, gid_panes=(),
                          valid_panes=(),
                          cell_idx: Optional[torch.Tensor] = None) -> None:
    """Plain version of the stacked ``isla_sketch`` launch:
    ``isla_sketch_ref`` key by key, each key on its own register rows
    (``offset + g * R + r``, or those entries of ``cell_idx``) with its
    own panes."""
    n_rows = bits.shape[0]
    for k in keys:
        rows = slice(k.offset, k.offset + k.n_groups * n_rows)
        kw = _key_panes(k, pad, gid_panes, valid_panes)
        if cell_idx is None:
            isla_sketch_ref(bits, regs[rows], **kw)
        else:
            isla_sketch_ref(bits, regs, cell_idx=cell_idx[rows], **kw)


def isla_sketch_tagged_ref(bits: torch.Tensor, seg: torch.Tensor,
                           regs: torch.Tensor) -> None:
    """Plain version of ``isla_sketch_tagged``: the merge of a one-row
    pane whose GROUP BY ids are the lanes' register rows (ids outside
    ``[0, N)`` drop)."""
    isla_sketch_ref(bits[None], regs, gid=seg[None], n_groups=regs.shape[0])


def segment_carry_sum(prior: torch.Tensor, rows: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """The carry-prepend segmented sum: ``prior`` (N, w) rows with ``rows``
    (m, w) added onto rows ``ids`` (int64 in ``[0, N)``), each row of the
    result the left fold ``((0 + prior) + a1) + a2 ...`` in stream order.
    On the CPU ``index_add_`` adds in index order, so this is the host
    ``np.bincount`` carry fold bit for bit."""
    n = prior.shape[0]
    all_ids = torch.cat([torch.arange(n, device=ids.device), ids])
    return torch.zeros_like(prior).index_add_(0, all_ids,
                                              torch.cat([prior, rows]))


class RunTableError(ValueError):
    """A run table that does not describe its tagged stream."""


def check_run_count(count: int) -> None:
    """Raise when a run-table fold found runs or samples out of place."""
    if count:
        raise RunTableError(f"the run table does not describe the tagged "
                            f"stream: {count} runs or samples out of place")


def tagged_run_count(seg: torch.Tensor, runs, n_cells: int) -> int:
    """What the run-table kernel counts out of place: each run whose
    entries are inconsistent (a start after its end or outside the
    stream, a key span that is not a positive multiple of ``n_blocks``,
    the first run not at 0, the last not ending the stream and the cells),
    else each sample whose id lies in ``[0, n_cells)`` but not among its
    run's cells (``runs``: a ``TaggedRuns``)."""
    n_b, n_k = runs.n_blocks, runs.n_keys
    n_runs = n_k * n_b
    m = seg.shape[0]
    t = runs.table.to(torch.int64)
    starts, key_off = t[:n_runs + 1], t[n_runs + 1:n_runs + n_k + 2]
    s, e = starts[:-1], starts[1:]
    r = torch.arange(n_runs, device=t.device)
    off, span = key_off[r // n_b], key_off[r // n_b + 1] - key_off[r // n_b]
    ok = (span > 0) & (span % n_b == 0) & (off >= 0) \
        & (off + span <= n_cells) & (s >= 0) & (s <= e) & (e <= m)
    ok &= (r != 0) | ((s == 0) & (off == 0))
    ok &= (r != n_runs - 1) | ((e == m) & (off + span == n_cells))
    if not bool(ok.all()):
        return int((~ok).sum())
    run = torch.repeat_interleave(r, e - s)
    ids = seg.to(torch.int64)
    rel = ids - off[run]
    placed = (rel >= 0) & (rel < span[run]) & (rel % n_b == run % n_b)
    return int(((ids >= 0) & (ids < n_cells) & ~placed).sum())


def isla_tagged_fold_ref(values: torch.Tensor, seg: torch.Tensor,
                         bounds: torch.Tensor, out_s: torch.Tensor,
                         out_l: torch.Tensor, out_t: torch.Tensor,
                         runs=None) -> None:
    """Plain version of the ``isla_tagged_fold`` kernel: for each of S, L
    and the totals, the samples it admits — in S (or L) by the cuts of
    their cell, or any sample of a cell in ``[0, N)`` — folded in stream
    order onto the rows by ``segment_carry_sum``, in place.  With a run
    table it first checks the table against the stream
    (``tagged_run_count``) and raises, folding nothing, on a mismatch;
    the fold is the same either way."""
    n = out_s.shape[0]
    if runs is not None:
        check_run_count(tagged_run_count(seg, runs, n))
    ids = seg.to(torch.int64)
    keep = (ids >= 0) & (ids < n)
    b = bounds.reshape(-1, 4)
    cuts = b if b.shape[0] == 1 else b[ids.clamp(0, b.shape[0] - 1)]
    v = values
    v2 = v * v
    v3 = v2 * v
    one = torch.ones_like(v)
    in_s = keep & (v > cuts[:, 0]) & (v < cuts[:, 1])
    in_l = keep & (v > cuts[:, 2]) & (v < cuts[:, 3])
    cols = torch.stack([one, v, v2, v3], dim=1)
    for out, m, w in ((out_s, in_s, cols), (out_l, in_l, cols),
                      (out_t, keep, cols[:, :3])):
        out.copy_(segment_carry_sum(out, w[m], ids[m]))


def pilot_stats_ref(values: torch.Tensor,
                    center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the ``pilot_stats`` kernel: ``(count, sum (x-c),
    sum (x-c)^2, min x)`` fp32 over a flat run, ``c`` 0 when absent."""
    v = values.to(F32).reshape(-1)
    d = v if center is None else v - center.to(F32).reshape(())
    return torch.stack([torch.tensor(float(v.shape[0]), dtype=F32,
                                     device=v.device),
                        d.sum(), (d * d).sum(), v.min()])


def pilot_moments_ref(values: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``pilot_moments`` kernel: ``(count, mean, M2,
    min, sigma)`` float64 of a flat run — the mean, then the sum of
    squared deviations from it, then the min, all in float64; ``sigma =
    sqrt(M2 / max(count - 1, 1))`` (ddof = 1)."""
    v = values.reshape(-1).to(torch.float64)
    n = v.shape[0]
    mean = v.sum() / n
    d = v - mean
    m2 = (d * d).sum()
    sigma = torch.sqrt(m2.clamp_min(0.0) / max(n - 1, 1))
    return torch.stack([torch.tensor(float(n), dtype=torch.float64,
                                     device=v.device),
                        mean, m2, v.min(), sigma])


def stats_from_moments(moments: torch.Tensor,
                       center: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """``pilot_stats``'s ``(count, sum (x-c), sum (x-c)^2, min)`` fp32 from
    a run's ``(count, mean, M2, min, ...)``: ``(n, n (mean - c), M2 + n
    (mean - c)^2, min)`` in float64, ``c`` 0 when absent."""
    n, mean, m2, mn = moments[:4].to(torch.float64).unbind()
    dm = mean if center is None else \
        mean - center.to(torch.float64).reshape(())
    return torch.stack([n, n * dm, m2 + n * dm * dm, mn]).to(F32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        groups: int = 1) -> torch.Tensor:
    """Plain version of the ``flash_attention`` kernel (the reference's
    ``ref.flash_attention_ref``): causal attention of q (BH, S, hd) over
    k, v (BH / groups, S, hd), each KV head serving ``groups`` consecutive
    q heads; fp32 scores of ``q * hd**-0.5``, masked to -1e30 above the
    diagonal, fp32 softmax and P.V, the output cast to ``q.dtype``."""
    if groups > 1:
        k = k.repeat_interleave(groups, dim=0)
        v = v.repeat_interleave(groups, dim=0)
    qf = q.to(F32)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqh,bkh->bqk", qf * scale, k.to(F32))
    n = q.shape[1]
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask[None], s, torch.full((), -1e30, dtype=F32,
                                              device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.to(F32)).to(q.dtype)
