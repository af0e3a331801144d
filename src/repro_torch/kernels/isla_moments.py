"""Wrappers and binding of the hand-written ISLA kernels (Hopper, sm_90a).

Four CUDA kernels live in ``csrc/isla_kernels.cu`` (the note there names
the TPU kernels or the reference code they replace, their bound and their
design):

* ``isla_fold`` — the Phase 1 fold: per output cell, the S/L region
  moments and the plain totals of its samples, added in place onto
  resident fp32 rows, or float64 rows for a float64 pane (shared or
  per-row cuts, optional per-key affine, 0/1 masks, GROUP BY ids, an
  index map whose out-of-range entries drop); one launch folds every key
  of a stack (``isla_fold_stack``), reading each sample once for all of
  them;
* ``pilot_stats`` — one pass over a flat fp32 run: its ``(count, mean,
  M2, min)``, returned as the device pilot's ``(count, mean, M2, min,
  sigma)`` (``pilot_moments``) or as the TPU kernel's ``(count, sum
  (x-c), sum (x-c)^2, min x)`` (``pilot_stats``);
* ``isla_sketch`` — the HLL COUNT DISTINCT register merge: splitmix64 of
  each live lane's raw float64 bits (one int64 pane), encoded to
  ``(j, rho)`` and maxed in place into resident uint8 register rows
  (GROUP BY ids, 0/1 masks, an index map whose out-of-range entries
  drop); one launch merges every key of a stack (``isla_sketch_stack``),
  hashing each lane once; its tagged entry (``isla_sketch_tagged``) merges
  a stream of lanes that each carry their register row;
* ``isla_tagged_fold`` — the tagged tick's Phase 1: a stream of samples,
  each tagged with its cell, folded onto resident float64 (or fp32) rows
  in stream order, each add rounded once — the host ``np.bincount``
  carry fold's bits; a block-major stream comes with its (key, block)
  run table (``TaggedRuns``) and is folded a block a run.

A stack's keys are ``StackKey`` entries, at most ``MAX_KEYS`` a launch:
they travel as a small table in the kernel's parameters.  ``isla_fold``
and ``isla_sketch`` are the one-key case of the same kernels.

This module also builds and loads every CUDA source of the port
(``SOURCES``: ``isla_kernels.cu`` and ``flash_attention.cu``, whose
wrapper is ``flash_attention.py``).  Each is compiled with ``nvcc`` at
first use into ``_build/`` beside this file (a plain C interface loaded
with ``ctypes``), so importing this module needs neither a compiler nor a
card.  A wrapper given CPU tensors runs the kernel's plain PyTorch
version (``ref.py``); given CUDA tensors it launches the kernel, or
raises — it never falls back.  Each kernel's
``launches`` counter (an attribute of its one-key wrapper) counts the
calls of either entry that launched the kernel on the card, one a call,
and nothing else (``isla_sketch_tagged`` keeps its own count, and the
fold's float64 launches count in ``isla_fold.launches_f64``, not in
``isla_fold.launches``).  An
``isla_sketch`` call is one ``__global__`` launch, an ``isla_tagged_fold``
call one (with a run table; without, one after a stable ``torch.sort`` of
its ids);
an ``isla_fold`` call is one, or two when its rows exceed ``FOLD_SLICE``
samples (per-slice partial rows, then their fixed-order combine); a
``pilot_stats`` or ``pilot_moments`` call is one at every run length
(``pilot_stats.launches`` counts both).

The Pallas-signature wrappers (``isla_moments_batched``, ``isla_moments``,
``isla_moments_grouped``, ``isla_fused``; ``isla_sketch_batched``,
``isla_fused_sketch``) keep the reference functions' shapes and checks
and run on the fold and sketch kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ref
from ..roofline.op_cost import is_fake, no_count, record_kernel
from ..trace import span
from .ops import fake_kernel, on_gpu

LANE = 128          # lane width of the (rows, 128) tile layout
DEFAULT_TM = 512    # rows per tile of the reference layout
FOLD_SLICE = 32768  # samples per fold block: longer rows are sliced
MAX_KEYS = 16       # stacked keys one fold or merge launch takes
STAGE_BYTES = 40 * 1024  # shared memory a fold block stages its row in
                         # (under the 48 KB a block gets without opting in)
TAGGED_TILE = 512  # samples a run block of the tagged fold stages at once
                   # (22 KB of shared memory at float64)
REG_ROWS = 32       # one cell's 4096 HLL registers as a (32, 128) tile
N_REGS = REG_ROWS * LANE

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("isla_kernels.cu", "flash_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    the toolkit's default location.  Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are compiled at first use and need the CUDA toolkit")


def _library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}-{tag[:16]}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source not built yet into its own shared library,
    one ``nvcc`` per source, all started together.  Returns each source's
    compiler log (``-Xptxas -v``: registers, shared memory, spills); a
    failed compile raises with its log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        out = _library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        jobs.append((src, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = {}
    for src, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        logs[src] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builds agree
    return logs


# Each source's C entry points and their argument types (a pointer or the
# stream as c_void_p, never as a 32-bit int); every one returns the CUDA
# error of its launches as an int.
SIGNATURES = {
    "isla_kernels.cu": {
        "isla_fold": [_P, _I, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _I, _P,
                      _I, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _I, _P, _P,
                      _P, _P, _LL, _I, _P, _I, _I, _P],
        "pilot_moments": [_P, _LL, _I, _P, _P, _I, _P, _P, _I, _P],
        "pilot_workspace_bytes": [_I],
        "isla_sketch": [_P, _LL, _LL, _LL, _P, _P, _I, _P, _I, _P, _P, _LL,
                        _I, _P, _P, _P],
        "isla_tagged_fold": [_P, _I, _P, _P, _LL, _P, _I, _P, _LL, _P, _LL,
                             _P, _LL, _LL, _P],
        "isla_tagged_fold_runs": [_P, _I, _P, _LL, _P, _I, _P, _LL, _P, _LL,
                                  _P, _LL, _LL, _P, _I, _I, _I, _P],
    },
    "flash_attention.cu": {
        "flash_attention": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P],
    },
}


@functools.lru_cache(maxsize=None)
def library(source: str = SOURCES[0]) -> ctypes.CDLL:
    """The loaded kernel library of ``source`` (built first if needed),
    argtypes set; a ``kernels.load`` span, whose ``built`` says whether
    ``nvcc`` ran."""
    path = _library_path(source)
    built = not path.exists()
    with span("kernels.load", source=source, built=built):
        if built:
            build([source])
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _check_cells(n_groups: int, n_rows: int, n_out: int,
                 cell_idx: Optional[torch.Tensor], what: str) -> int:
    """Validate a launch's cell grid and its optional cell -> row map;
    returns the cell count ``n_groups * n_rows``."""
    n_cells = n_groups * n_rows
    if n_cells >= 2 ** 31:
        raise ValueError(f"{n_cells} cells exceed one launch's grid")
    if cell_idx is not None:
        if cell_idx.dtype != torch.int32 or cell_idx.shape != (n_cells,) \
                or not cell_idx.is_contiguous():
            raise ValueError(f"cell_idx must be contiguous ({n_cells},) "
                             f"int32")
    elif n_out != n_cells:
        raise ValueError(f"{what} rows ({n_out}) must equal n_groups * R "
                         f"({n_cells}) without a cell_idx map")
    return n_cells


def _same_device(ref_t: torch.Tensor, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.device != ref_t.device:
            raise ValueError(f"{name} is on {t.device}, values on "
                             f"{ref_t.device}")


# ---------------------------------------------------------------------------
# Stacked keys.
# ---------------------------------------------------------------------------


class StackKey(NamedTuple):
    """One key of a stacked fold or register merge.

    Cell ``(g, r)`` of the key (group g of pane row r) lands on output row
    ``offset + g * R + r``, or on ``cell_idx[offset + g * R + r]`` when the
    launch has a map.  ``gid_slot`` and ``valid_slot`` name the key's
    GROUP BY and predicate panes (-1: none).  The fold also reads
    ``affine`` (``(ratio, off)`` or None) and ``bound_row``, the key's row
    of the cuts table (-1: per-row cuts, the table being (R, 4)); the
    register merge ignores both.
    """
    n_groups: int = 1
    gid_slot: int = -1
    valid_slot: int = -1
    offset: int = 0
    affine: Optional[Tuple[float, float]] = None
    bound_row: int = 0


def check_keys(keys: Sequence[StackKey], *, n_rows: int, n_gid: int,
               n_valid: int, n_targets: int, target: str,
               n_bound_rows: Optional[int] = None) -> Tuple[StackKey, ...]:
    """Validate a stack's key table: 1 to ``MAX_KEYS`` keys, every slot
    naming a pane (a GROUP BY key needs one), every bound row inside the
    cuts table (-1 only for an (R, 4) table), and every key's cells
    ``[offset, offset + n_groups * R)`` inside the ``n_targets`` output
    rows (or map entries).  Returns the keys with ``n_groups`` as ints."""
    keys = tuple(StackKey(*k) for k in keys)
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"a stacked launch takes 1 to {MAX_KEYS} keys, "
                         f"got {len(keys)}")
    out = []
    for i, k in enumerate(keys):
        g = int(k.n_groups)
        if g < 1:
            raise ValueError(f"key {i}: n_groups must be >= 1, got {g}")
        if not -1 <= k.gid_slot < n_gid:
            raise ValueError(f"key {i}: gid slot {k.gid_slot} names none "
                             f"of the {n_gid} gid panes")
        if g > 1 and k.gid_slot < 0:
            raise ValueError(f"key {i}: n_groups > 1 needs a gid pane")
        if not -1 <= k.valid_slot < n_valid:
            raise ValueError(f"key {i}: valid slot {k.valid_slot} names "
                             f"none of the {n_valid} predicate panes")
        if n_bound_rows is not None and not (
                0 <= k.bound_row < n_bound_rows
                or (k.bound_row == -1 and n_bound_rows == n_rows)):
            raise ValueError(f"key {i}: bound row {k.bound_row} is not a "
                             f"row of the ({n_bound_rows}, 4) cuts table")
        if k.offset < 0 or k.offset + g * n_rows > n_targets:
            raise ValueError(f"key {i}: cells [{k.offset}, "
                             f"{k.offset + g * n_rows}) run past the "
                             f"{n_targets} {target}")
        out.append(k._replace(n_groups=g))
    if sum(k.n_groups for k in out) * n_rows >= 2 ** 31:
        raise ValueError("the stack's cells exceed one launch's grid")
    return tuple(out)


def _check_panes(lead: torch.Tensor, what: str, pad, gid_panes,
                 valid_panes) -> None:
    for name, t, dt in ([("pad", pad, torch.float32)]
                        + [("gid", t, torch.int32) for t in gid_panes]
                        + [("valid", t, torch.float32) for t in valid_panes]):
        if t is None:
            continue
        if t.dtype != dt or t.shape != lead.shape \
                or t.stride() != lead.stride():
            raise ValueError(f"{name} must be {dt} laid out like {what}")


def _pane_slots(keys: Sequence[StackKey], panes, field: str):
    """The panes the keys use, in slot order, and each key's slot among
    them (-1: none): a launch stages only what its keys read."""
    used = sorted({getattr(k, field) for k in keys} - {-1})
    where = {s: i for i, s in enumerate(used)}
    return ([panes[s] for s in used],
            [where.get(getattr(k, field), -1) for k in keys])


def _ptr_array(tensors):
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[t.data_ptr() for t in tensors])


# ---------------------------------------------------------------------------
# Kernel A: the fold.
# ---------------------------------------------------------------------------


# The fold's C entry names the pane's value type by a code.
_FOLD_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_NAMES = {torch.float32: "fp32", torch.float64: "float64"}


def fold_dtype(values: torch.Tensor) -> torch.dtype:
    """The type the fold computes in for ``values``: float64 for a float64
    pane, else fp32 (bf16 values are folded as fp32).  Its cuts and
    resident rows are of this type."""
    return torch.float64 if values.dtype == torch.float64 else torch.float32


def _check_values(values: torch.Tensor) -> Tuple[int, int]:
    if values.dim() != 2:
        raise ValueError(f"values must be (R, Q), got {tuple(values.shape)}")
    if values.dtype not in _FOLD_TYPES:
        raise ValueError(f"values must be fp32, bf16 or float64, got "
                         f"{values.dtype}")
    n_rows, q = values.shape
    if q > 1 and values.stride(1) != 1:
        raise ValueError("values need unit stride along the sample axis")
    return n_rows, q


def isla_fold(values: torch.Tensor, bounds: torch.Tensor,
              out_s: torch.Tensor, out_l: torch.Tensor,
              out_t: Optional[torch.Tensor] = None, *,
              pad: Optional[torch.Tensor] = None,
              valid: Optional[torch.Tensor] = None,
              gid: Optional[torch.Tensor] = None, n_groups: int = 1,
              affine: Optional[Tuple[float, float]] = None,
              cell_idx: Optional[torch.Tensor] = None,
              chunks: Optional[Tuple[int, int, int]] = None) -> None:
    """Fold a (R, Q) sample pane into resident moment rows, in place: the
    one-key case of ``isla_fold_stack``.

    values : (R, Q) fp32, bf16 or float64, unit stride along Q (rows may
        be a strided view).  Row r's samples are its Q entries, or with
        ``chunks=(chunk_len, chunk_stride, n_chunks)`` the ``n_chunks``
        runs of ``chunk_len`` entries starting every ``chunk_stride``.
    bounds : (4,) shared cuts ``(s_lo, s_hi, l_lo, l_hi)`` or (R, 4)
        per-row cuts, in the frame after the affine, of the fold's type
        (``fold_dtype``: float64 for float64 values, else fp32).
    out_s, out_l : (N, 4) rows of the fold's type (unit column stride)
        receiving the S and L ``(count, s1, s2, s3)`` sums; ``out_t``
        (N, 3) the totals ``(count, s1, s2)``, skipped when None.
    pad, valid : optional (R, Q) fp32 0/1 masks (same layout as values).
    gid : optional (R, Q) int32 GROUP BY ids in ``[0, n_groups)`` (others
        match no group).  Cell ``g * R + r`` receives row r's group-g
        samples.
    affine : optional ``(ratio, off)``; samples become ``x * ratio + off``
        in the fold's type, rounded after the multiply and after the add.
    cell_idx : optional (n_groups * R,) int32 map from cell to output
        row; entries outside ``[0, N)`` drop.  Without it N must equal
        ``n_groups * R`` (pass row-sliced views to fold at an offset).
    """
    n_rows, _ = _check_values(values)
    n_groups = int(n_groups)
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    if gid is None and n_groups != 1:
        raise ValueError("n_groups > 1 needs a gid pane")
    if bounds.dtype != fold_dtype(values) or not bounds.is_contiguous():
        raise ValueError(f"bounds must be contiguous "
                         f"{_NAMES[fold_dtype(values)]}")
    if bounds.shape == (4,):
        table, row = bounds.reshape(1, 4), 0
    elif bounds.shape == (n_rows, 4):
        table, row = bounds, -1
    else:
        raise ValueError(f"bounds must be (4,) or ({n_rows}, 4), got "
                         f"{tuple(bounds.shape)}")
    _check_cells(n_groups, n_rows, out_s.shape[0], cell_idx, "out")
    key = StackKey(n_groups, -1 if gid is None else 0,
                   -1 if valid is None else 0, 0, affine, row)
    isla_fold_stack(values, table, out_s, out_l, out_t, keys=(key,),
                    pad=pad, gid_panes=() if gid is None else (gid,),
                    valid_panes=() if valid is None else (valid,),
                    cell_idx=cell_idx, chunks=chunks)


SORT_GROUPS = 256  # a GROUP BY pane of at most this many groups is bucketed
FOLD_WARPS = 4     # warps of a fold block


def fold_stage(n: int, keys: Sequence[StackKey],
               value_bytes: int = 4) -> Tuple[list, int, int]:
    """How a fold launch stages rows of ``n`` samples for ``keys``:
    ``(slot_groups, tile, smem_bytes)``; values are staged in the fold's
    type, ``value_bytes`` each (4, or 8 at float64).

    ``slot_groups`` lists, for each GROUP BY pane the keys read (in slot
    order), the groups the kernel buckets its ids by: the most its grouped
    keys have, or 0 (its keys scan the staged ids) when none is grouped or
    one has more than ``SORT_GROUPS``.  ``tile`` is the samples a block
    stages at once: a slice (at most ``FOLD_SLICE``) rounded up to 32,
    capped so the block's dynamic shared memory, ``smem_bytes``, fits
    ``STAGE_BYTES``: a value and a mask word (4 B) a sample, each pane's
    ids (4 B) and bucket order (2 B) a sample, each pane's bucket starts,
    and a counter and a peer mask a group for each warp."""
    used = sorted({k.gid_slot for k in keys} - {-1})
    groups = [0] * len(used)
    for k in keys:
        if k.n_groups > 1 and k.gid_slot >= 0:
            i = used.index(k.gid_slot)
            groups[i] = max(groups[i], k.n_groups)
    groups = [g if g <= SORT_GROUPS else 0 for g in groups]
    n_gid, top = len(used), max(groups, default=0)
    fixed = 4 * n_gid * (top + 1) + 8 * FOLD_WARPS * top
    per_sample = value_bytes + 4 + 6 * n_gid
    tile = min(-(-min(n, FOLD_SLICE) // 32) * 32,
               (STAGE_BYTES - fixed) // per_sample // 32 * 32)
    return groups, tile, tile * per_sample + fixed


def isla_fold_stack(values: torch.Tensor, bounds: torch.Tensor,
                    out_s: torch.Tensor, out_l: torch.Tensor,
                    out_t: Optional[torch.Tensor] = None, *,
                    keys: Sequence[StackKey],
                    pad: Optional[torch.Tensor] = None,
                    gid_panes: Sequence[torch.Tensor] = (),
                    valid_panes: Sequence[torch.Tensor] = (),
                    cell_idx: Optional[torch.Tensor] = None,
                    chunks: Optional[Tuple[int, int, int]] = None) -> None:
    """Fold a (R, Q) sample pane into the resident rows of every stacked
    key, in place, in one launch that reads each sample once for all keys.

    Key k (a ``StackKey``) reads the pane through its ``affine``,
    classifies against row ``bound_row`` of ``bounds`` ((n_b, 4) of the
    fold's type; -1: per-row cuts, ``bounds`` being (R, 4)), keeps the
    samples where ``pad`` and its predicate pane
    ``valid_panes[valid_slot]`` are nonzero and groups them by
    ``gid_panes[gid_slot]``; cell ``(g, r)`` adds onto
    output row ``offset + g * R + r``, or onto ``cell_idx[offset + g * R +
    r]`` (out-of-range entries drop).  ``values``, the panes, ``out_*``
    and ``chunks`` are as in ``isla_fold``.  At most ``MAX_KEYS`` keys.
    A float64 pane launches the kernel's float64 form (counted in
    ``isla_fold.launches_f64``); nothing is cast to fp32.
    """
    n_rows, q = _check_values(values)
    dt = fold_dtype(values)
    if bounds.dtype != dt or bounds.dim() != 2 \
            or bounds.shape[1] != 4 or not bounds.is_contiguous():
        raise ValueError(f"bounds must be a contiguous (n, 4) {_NAMES[dt]} "
                         f"table")
    if chunks is not None:
        if pad is not None or gid_panes or valid_panes:
            raise ValueError("chunked reads take no mask or gid panes")
        chunk_len, chunk_stride, n_chunks = (int(c) for c in chunks)
        if (n_chunks - 1) * chunk_stride + chunk_len > q:
            raise ValueError("chunks run past the end of the row")
    else:
        chunk_len, chunk_stride, n_chunks = q, q, 1
    _check_panes(values, "values", pad, gid_panes, valid_panes)
    n_out = out_s.shape[0]
    for name, t, w in (("out_s", out_s, 4), ("out_l", out_l, 4),
                       ("out_t", out_t, 3)):
        if t is None:
            continue
        if t.dtype != dt or t.dim() != 2 or t.shape[1] != w \
                or t.shape[0] != n_out or t.stride(1) != 1:
            raise ValueError(f"{name} must be ({n_out}, {w}) {_NAMES[dt]} "
                             f"with unit column stride")
    if cell_idx is not None and (cell_idx.dtype != torch.int32
                                 or cell_idx.dim() != 1
                                 or not cell_idx.is_contiguous()):
        raise ValueError("cell_idx must be a contiguous 1-D int32 map")
    keys = check_keys(keys, n_rows=n_rows, n_gid=len(gid_panes),
                      n_valid=len(valid_panes),
                      n_targets=n_out if cell_idx is None
                      else cell_idx.shape[0],
                      target="out rows" if cell_idx is None
                      else "cell_idx entries",
                      n_bound_rows=bounds.shape[0])
    _same_device(values, bounds=bounds, out_s=out_s, out_l=out_l,
                 out_t=out_t, pad=pad, cell_idx=cell_idx,
                 **{f"gid_panes[{i}]": t for i, t in enumerate(gid_panes)},
                 **{f"valid_panes[{i}]": t
                    for i, t in enumerate(valid_panes)})
    if is_fake(values):
        fake_kernel("isla_fold", (values, bounds, out_s, out_l, out_t, pad,
                                  cell_idx, *gid_panes, *valid_panes),
                    out_s, *fold_cost(values, bounds, (out_s, out_l, out_t),
                                      keys, n_chunks * chunk_len,
                                      (pad, cell_idx, *gid_panes,
                                       *valid_panes)), dt)
        return
    if not on_gpu(values):
        with no_count():
            ref.isla_fold_stack_ref(values, bounds, out_s, out_l, out_t,
                                    keys=keys, pad=pad, gid_panes=gid_panes,
                                    valid_panes=valid_panes,
                                    cell_idx=cell_idx, chunks=chunks)
        record_kernel("isla_fold", *fold_cost(
            values, bounds, (out_s, out_l, out_t), keys,
            n_chunks * chunk_len, (pad, cell_idx, *gid_panes,
                                   *valid_panes)), dt)
        return
    n = n_chunks * chunk_len
    if n_rows == 0 or n == 0:
        return
    gids, g_slot = _pane_slots(keys, gid_panes, "gid_slot")
    valids, v_slot = _pane_slots(keys, valid_panes, "valid_slot")
    # Rows longer than FOLD_SLICE samples are summed slice by slice (one
    # block each), then combined in slice order by a second kernel.  A
    # block stages its slice in tiles of at most STAGE_BYTES.
    n_slices = -(-n // FOLD_SLICE)
    if n_slices >= 2 ** 16:
        raise ValueError(f"{n} samples a row exceed one launch's grid")
    slot_groups, tile, _ = fold_stage(n, keys, dt.itemsize)
    vec = ((n_rows == 1 or values.stride(0) % 4 == 0)
           and (n_chunks == 1 or (chunk_len % 4 == 0
                                  and chunk_stride % 4 == 0))
           and values.data_ptr() % (4 * values.element_size()) == 0
           and all(t.data_ptr() % 16 == 0
                   for t in [*gids, *valids] + ([pad] if pad is not None
                                                 else [])))
    n_cells = sum(k.n_groups for k in keys) * n_rows
    slices = (torch.empty(n_cells * n_slices * 11, dtype=dt,
                          device=values.device) if n_slices > 1 else None)
    nk = len(keys)
    kint = (ctypes.c_int * (5 * nk))(*[
        v for k, gs, vs in zip(keys, g_slot, v_slot)
        for v in (k.n_groups, gs, vs, int(k.affine is not None),
                  k.bound_row)])
    kflt = (ctypes.c_double * (2 * nk))(*[
        float(v) for k in keys
        for v in ((1.0, 0.0) if k.affine is None else k.affine)])
    koff = (ctypes.c_longlong * nk)(*[k.offset for k in keys])
    with torch.cuda.device(values.device):
        err = library().isla_fold(
            _ptr(values), _FOLD_TYPES[values.dtype], n_rows,
            values.stride(0), n_chunks, chunk_len, chunk_stride,
            _ptr(bounds), _ptr(pad), _ptr_array(valids), len(valids),
            _ptr_array(gids), len(gids), _ptr(out_s), out_s.stride(0),
            _ptr(out_l), out_l.stride(0), _ptr(out_t),
            0 if out_t is None else out_t.stride(0), _ptr(cell_idx), n_out,
            nk, kint, kflt, koff,
            (ctypes.c_int * max(1, len(slot_groups)))(*slot_groups),
            FOLD_SLICE, n_slices, _ptr(slices), tile, int(vec),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "isla_fold")
    if dt == torch.float64:
        isla_fold.launches_f64 += 1
    else:
        isla_fold.launches += 1
    record_kernel("isla_fold", *fold_cost(
        values, bounds, (out_s, out_l, out_t), keys, n,
        (pad, cell_idx, *gid_panes, *valid_panes)), dt)


def fold_cost(values, bounds, outs, keys, n: int, panes
              ) -> Tuple[float, float]:
    """(operations, bytes) of one fold, the bound of ``PERF.md``'s kernel
    table: 17 operations a sample a key; each sample, mask, id and cut
    read once, each resident row read and written once."""
    samples = values.shape[0] * n
    nbytes = samples * values.element_size() + sum(
        t.numel() * t.element_size() for t in (bounds, *panes)
        if t is not None) + 2 * sum(t.numel() * t.element_size()
                                    for t in outs if t is not None)
    return 17.0 * samples * len(keys), float(nbytes)


isla_fold.launches = 0
isla_fold.launches_f64 = 0


# ---------------------------------------------------------------------------
# Kernel B: pilot statistics.
# ---------------------------------------------------------------------------

PILOT_BLOCKS_PER_SM = 4  # the pilot kernel's grid cap (its launch bounds)
_pilot_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, int, int]] = {}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _pilot_workspace(device: torch.device, stream: int) -> Tuple[int, int]:
    """``(pointer, max_blocks)`` of the pilot kernel's workspace for one
    stream of one card: a ticket counter and a state a block, zeroed once
    and kept.  Launches on one stream run in order, so they share it;
    another stream gets its own, so pilots on two streams never mix."""
    ws = _pilot_workspaces.get((device.index, stream))
    if ws is None:
        max_blocks = PILOT_BLOCKS_PER_SM * _sm_count(device.index)
        buf = torch.zeros(library().pilot_workspace_bytes(max_blocks),
                          dtype=torch.uint8, device=device)
        ws = _pilot_workspaces[(device.index, stream)] = (
            buf, buf.data_ptr(), max_blocks)
    return ws[1], ws[2]


def _check_run(values: torch.Tensor) -> int:
    if values.dtype != torch.float32 or values.dim() != 1 \
            or not values.is_contiguous():
        raise ValueError("the pilot kernel takes a contiguous 1-D fp32 run")
    n = values.shape[0]
    if not 0 < n < 2 ** 31:
        raise ValueError(f"the pilot kernel takes a non-empty run of fewer "
                         f"than 2^31 samples, got {n}")
    return n


def _launch_pilot(values: torch.Tensor, n: int,
                  center: Optional[torch.Tensor],
                  stats: Optional[torch.Tensor],
                  moments: Optional[torch.Tensor]) -> None:
    """One ``pilot_moments_kernel`` launch on the current stream of the
    run's own card (made current for the launch inside the C entry, with
    no ``torch.cuda.device`` context)."""
    dev = values.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws, max_blocks = _pilot_workspace(dev, stream)
    ptr = values.data_ptr()
    err = library().pilot_moments(
        ptr, n, int(ptr % 16 == 0), _ptr(center), ws, max_blocks,
        _ptr(stats), _ptr(moments), dev.index, stream)
    _raise_on(err, "pilot_stats")
    pilot_stats.launches += 1


def pilot_moments(values: torch.Tensor) -> torch.Tensor:
    """``(count, mean, M2, min, sigma)`` float64 (5,) of a flat fp32 run:
    ``M2 = sum (x - mean)^2``, ``sigma = sqrt(M2 / max(count - 1, 1))``
    (ddof = 1).  On the card one ``pilot_moments_kernel`` launch that reads
    each sample once (counted in ``pilot_stats.launches``); on the CPU its
    plain version ``ref.pilot_moments_ref``."""
    n = _check_run(values)
    if not on_gpu(values):
        return ref.pilot_moments_ref(values)
    out = torch.empty(5, dtype=torch.float64, device=values.device)
    _launch_pilot(values, n, None, None, out)
    return out


def pilot_stats(values: torch.Tensor,
                center: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(count, sum (x-c), sum (x-c)^2, min x)`` fp32 of a flat fp32 run
    (the TPU kernel's form); ``center`` is an optional one-element fp32
    tensor on the same device (read on the device — no host sync), 0 when
    absent.  Derived from the run's ``(count, mean, M2, min)`` as
    ``(n, n (mean - c), M2 + n (mean - c)^2, min)`` in float64: on the
    card by the same one launch as ``pilot_moments``, on the CPU from its
    plain version."""
    n = _check_run(values)
    if center is not None and (center.dtype != torch.float32
                               or center.numel() != 1):
        raise ValueError("center must be a one-element fp32 tensor")
    _same_device(values, center=center)
    if not on_gpu(values):
        return ref.stats_from_moments(ref.pilot_moments_ref(values), center)
    out = torch.empty(4, dtype=torch.float32, device=values.device)
    _launch_pilot(values, n, None if center is None else center.contiguous(),
                  out, None)
    return out


pilot_stats.launches = 0


# ---------------------------------------------------------------------------
# Kernel C: the HLL register merge.
# ---------------------------------------------------------------------------


def limbs_to_bits(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The int64 bits pane of ``(hi, lo)`` uint32 limb panes (int32 or
    uint32 tensors of the same shape): the two limbs side by side,
    reinterpreted (little endian) — no arithmetic, no overflow."""
    pair = torch.stack([lo.view(torch.int32), hi.view(torch.int32)], dim=-1)
    return pair.contiguous().view(torch.int64)[..., 0]


def isla_sketch(bits: torch.Tensor, regs: torch.Tensor, *,
                pad: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                gid: Optional[torch.Tensor] = None, n_groups: int = 1,
                cell_idx: Optional[torch.Tensor] = None) -> None:
    """Merge a (R, Q) hash pane into resident HLL register rows, in place:
    the one-key case of ``isla_sketch_stack``.

    bits : (R, Q) int64 — the RAW float64 measure values' bits
        (``values.view(int64)``), unit stride along Q.
    regs : (N, 4096) uint8, contiguous; row ``cell`` receives
        ``max(regs[cell, j], rho)`` for every live lane hashing to bucket
        ``j`` with rank ``rho``.
    pad, valid : optional (R, Q) fp32 0/1 masks laid out like ``bits``.
    gid : optional (R, Q) int32 GROUP BY ids in ``[0, n_groups)`` (others
        match no group).  Cell ``g * R + r`` receives row r's group-g
        lanes.
    cell_idx : optional (n_groups * R,) int32 map from cell to register
        row; entries outside ``[0, N)`` drop.  Without it N must equal
        ``n_groups * R`` (pass a row-sliced view to merge at an offset).

    ``isla_sketch.launches`` counts the kernel's launches on the card
    (one ``__global__`` launch per call of either entry).
    """
    n_rows = _check_bits(bits)
    n_groups = int(n_groups)
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    if gid is None and n_groups != 1:
        raise ValueError("n_groups > 1 needs a gid pane")
    _check_panes(bits, "bits", pad, () if gid is None else (gid,),
                 () if valid is None else (valid,))
    _check_regs(regs)
    _check_cells(n_groups, n_rows, regs.shape[0], cell_idx, "register")
    key = StackKey(n_groups, -1 if gid is None else 0,
                   -1 if valid is None else 0)
    isla_sketch_stack(bits, regs, keys=(key,), pad=pad,
                      gid_panes=() if gid is None else (gid,),
                      valid_panes=() if valid is None else (valid,),
                      cell_idx=cell_idx)


def _check_bits(bits: torch.Tensor) -> int:
    if bits.dim() != 2 or bits.dtype != torch.int64:
        raise ValueError(f"bits must be (R, Q) int64, got {bits.dtype} "
                         f"{tuple(bits.shape)}")
    if bits.shape[1] > 1 and bits.stride(1) != 1:
        raise ValueError("hash panes need unit stride along the lane axis")
    return bits.shape[0]


def _check_regs(regs: torch.Tensor) -> None:
    if regs.dtype != torch.uint8 or regs.dim() != 2 \
            or regs.shape[1] != N_REGS or not regs.is_contiguous():
        raise ValueError(f"regs must be contiguous (N, {N_REGS}) uint8")


def isla_sketch_stack(bits: torch.Tensor, regs: torch.Tensor, *,
                      keys: Sequence[StackKey],
                      pad: Optional[torch.Tensor] = None,
                      gid_panes: Sequence[torch.Tensor] = (),
                      valid_panes: Sequence[torch.Tensor] = (),
                      cell_idx: Optional[torch.Tensor] = None) -> None:
    """Merge a (R, Q) hash pane into the resident register rows of every
    stacked key, in place, in one launch that hashes each live lane once.

    Key k (a ``StackKey``; ``affine`` and ``bound_row`` are not read)
    keeps the lanes where ``pad`` and its predicate pane
    ``valid_panes[valid_slot]`` are nonzero, groups them by
    ``gid_panes[gid_slot]`` and merges cell ``(g, r)`` into register row
    ``offset + g * R + r``, or ``cell_idx[offset + g * R + r]``
    (out-of-range entries drop).  ``bits``, the panes and ``regs`` are as
    in ``isla_sketch``.  At most ``MAX_KEYS`` keys.
    """
    n_rows = _check_bits(bits)
    q = bits.shape[1]
    _check_panes(bits, "bits", pad, gid_panes, valid_panes)
    _check_regs(regs)
    n_out = regs.shape[0]
    if cell_idx is not None and (cell_idx.dtype != torch.int32
                                 or cell_idx.dim() != 1
                                 or not cell_idx.is_contiguous()):
        raise ValueError("cell_idx must be a contiguous 1-D int32 map")
    keys = check_keys(keys, n_rows=n_rows, n_gid=len(gid_panes),
                      n_valid=len(valid_panes),
                      n_targets=n_out if cell_idx is None
                      else cell_idx.shape[0],
                      target="register rows" if cell_idx is None
                      else "cell_idx entries")
    _same_device(bits, regs=regs, pad=pad, cell_idx=cell_idx,
                 **{f"gid_panes[{i}]": t for i, t in enumerate(gid_panes)},
                 **{f"valid_panes[{i}]": t
                    for i, t in enumerate(valid_panes)})
    if not on_gpu(bits):
        ref.isla_sketch_stack_ref(bits, regs, keys=keys, pad=pad,
                                  gid_panes=gid_panes,
                                  valid_panes=valid_panes, cell_idx=cell_idx)
        return
    if n_rows == 0 or q == 0:
        return
    if q > SKETCH_ROW_LANES:
        raise ValueError(f"{q} lanes a row exceed one launch's grid")
    _launch_sketch(bits, regs, keys, pad, gid_panes, valid_panes, cell_idx)
    isla_sketch.launches += 1


isla_sketch.launches = 0

SKETCH_ROW_LANES = 256 * (2 ** 16 - 1)  # lanes of a pane row one merge takes


def _launch_sketch(bits: torch.Tensor, regs: torch.Tensor, keys, pad,
                   gid_panes, valid_panes, cell_idx) -> None:
    """One ``isla_sketch_kernel`` launch over checked arguments."""
    if regs.data_ptr() % 4 != 0:
        raise ValueError("regs must be 4-byte aligned")
    n_rows, q = bits.shape
    gids, g_slot = _pane_slots(keys, gid_panes, "gid_slot")
    valids, v_slot = _pane_slots(keys, valid_panes, "valid_slot")
    nk = len(keys)
    kint = (ctypes.c_int * (3 * nk))(*[
        v for k, gs, vs in zip(keys, g_slot, v_slot)
        for v in (k.n_groups, gs, vs)])
    koff = (ctypes.c_longlong * nk)(*[k.offset for k in keys])
    with torch.cuda.device(bits.device):
        err = library().isla_sketch(
            _ptr(bits), n_rows, bits.stride(0), q, _ptr(pad),
            _ptr_array(valids), len(valids), _ptr_array(gids), len(gids),
            _ptr(regs), _ptr(cell_idx), regs.shape[0], nk, kint, koff,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "isla_sketch")


def _check_tagged(seg: torch.Tensor, m: int) -> None:
    if seg.dtype != torch.int32 or seg.shape != (m,) \
            or not seg.is_contiguous():
        raise ValueError(f"seg must be a contiguous ({m},) int32 stream of "
                         f"cell ids")


def isla_sketch_tagged(bits: torch.Tensor, seg: torch.Tensor,
                       regs: torch.Tensor) -> None:
    """Merge a tagged lane stream into resident HLL register rows, in
    place: the tagged tick's register merge (the reference's
    ``regs.at[seg, j].max(rho)`` in ``fused_tick_sketch``).

    bits : (m,) int64 — each sample's RAW float64 measure bits.
    seg : (m,) int32 — each sample's register row; ids outside ``[0, N)``
        (the drop segment ``N``) drop.
    regs : (N, 4096) uint8, contiguous.

    It is the ``isla_sketch`` kernel on a one-row pane whose GROUP BY ids
    are ``seg`` (one lane a sample, hashed once), in one launch a call —
    one per ``SKETCH_ROW_LANES`` lanes of a longer stream — counted in
    ``isla_sketch_tagged.launches``; on the CPU its plain version."""
    if bits.dim() != 1 or bits.dtype != torch.int64 \
            or not bits.is_contiguous():
        raise ValueError("bits must be a contiguous 1-D int64 stream")
    m = bits.shape[0]
    _check_tagged(seg, m)
    _check_regs(regs)
    _same_device(bits, seg=seg, regs=regs)
    if not on_gpu(bits):
        ref.isla_sketch_tagged_ref(bits, seg, regs)
        return
    if regs.shape[0] == 0:
        return
    key = (StackKey(n_groups=regs.shape[0], gid_slot=0),)
    for s in range(0, m, SKETCH_ROW_LANES):
        e = min(m, s + SKETCH_ROW_LANES)
        _launch_sketch(bits[None, s:e], regs, key, None, (seg[None, s:e],),
                       (), None)
        isla_sketch_tagged.launches += 1


isla_sketch_tagged.launches = 0


# ---------------------------------------------------------------------------
# Kernel D: the tagged fold.
# ---------------------------------------------------------------------------


class TaggedRuns(NamedTuple):
    """The (key, block) run table of a block-major tagged stream: key k's
    samples of block b are one contiguous run, run ``r = k * n_blocks + b``,
    and its samples' ids are the key's cells of that block,
    ``key_off[k] + g * n_blocks + b`` for each group g (or the drop
    segment).  ``table`` (int32, on the stream's device) holds the
    ``n_keys * n_blocks + 1`` run starts, the ``n_keys + 1`` key offsets
    (``tagged_run_table``), then a count of the runs and samples the fold
    found out of place.  ``deferred``: the fold does not read the count;
    the caller raises on it (``check_run_count``) after its own readback.
    """
    table: torch.Tensor
    n_keys: int
    n_blocks: int
    deferred: bool = False

    @property
    def count(self) -> torch.Tensor:
        """The (1,) count of runs and samples out of place."""
        return self.table[-1:]


def tagged_run_table(lengths, key_offsets) -> np.ndarray:
    """The host int32 table of ``TaggedRuns``: ``lengths`` (n_keys,
    n_blocks) are the runs' sample counts, ``key_offsets`` (n_keys + 1,)
    each key's first cell and the cell count; the count slot is 0."""
    lengths = np.asarray(lengths, dtype=np.int64)
    key_offsets = np.asarray(key_offsets, dtype=np.int64).reshape(-1)
    if lengths.ndim != 2 or key_offsets.shape != (lengths.shape[0] + 1,):
        raise ValueError("lengths must be (n_keys, n_blocks) and key_offsets "
                         "(n_keys + 1,)")
    starts = np.concatenate([[0], np.cumsum(lengths.reshape(-1))])
    if starts[-1] >= 2 ** 31 or key_offsets[-1] >= 2 ** 31:
        raise ValueError("a run table holds int32 starts and cells")
    return np.concatenate([starts, key_offsets, [0]]).astype(np.int32)


check_run_count = ref.check_run_count
RunTableError = ref.RunTableError


def _check_runs(runs: TaggedRuns, values: torch.Tensor) -> None:
    n = runs.n_keys * runs.n_blocks + runs.n_keys + 3
    t = runs.table
    if runs.n_keys < 1 or runs.n_blocks < 1 or t.dtype != torch.int32 \
            or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"a run table of {runs.n_keys} keys x "
                         f"{runs.n_blocks} blocks is a contiguous ({n},) "
                         f"int32 tensor")
    _same_device(values, runs=t)


def isla_tagged_fold(values: torch.Tensor, seg: torch.Tensor,
                     bounds: torch.Tensor, out_s: torch.Tensor,
                     out_l: torch.Tensor, out_t: torch.Tensor,
                     runs: Optional[TaggedRuns] = None) -> None:
    """Fold a tagged sample stream onto resident moment rows, in place, in
    stream order: the tagged tick's Phase 1 (the reference's carry-prepend
    ``_segment_carry_sum`` in ``_tick_core``).

    values : (m,) float64 (the exact mode) or fp32, contiguous.
    seg : (m,) int32 — each sample's cell; ids outside ``[0, N)`` (the
        drop segment ``N``) fold nowhere.
    bounds : (1, 4) cuts ``(s_lo, s_hi, l_lo, l_hi)`` shared by every cell,
        or (N + 1, 4) a row per cell (the last, the drop segment's, is not
        read), of the stream's type, contiguous.
    out_s, out_l : (N, 4) rows ``(count, s1, s2, s3)`` of the samples in S
        and in L; ``out_t`` (N, 3) ``(count, s1, s2)`` of every sample; of
        the stream's type, unit column stride.

    runs : optional ``TaggedRuns`` of a block-major stream.

    Every cell becomes ``((0 + row) + a1) + a2 ...`` over its samples in
    stream order, each add and multiply rounded once — the host
    ``np.bincount`` carry fold's bits.  On the card, with ``runs``, one
    ``isla_tagged_runs_kernel`` launch (a block a run, no sort); a table
    that does not describe the stream raises (at once, or through
    ``check_run_count`` when ``runs.deferred``).  Without, a stable
    ``torch.sort`` of the ids, then one ``isla_tagged_fold_kernel``
    launch.  Either is counted in ``isla_tagged_fold.launches``.  On the
    CPU its plain version, which raises on a wrong table before it
    folds."""
    if values.dim() != 1 or values.dtype not in (torch.float64,
                                                 torch.float32) \
            or not values.is_contiguous():
        raise ValueError("values must be a contiguous 1-D float64 or fp32 "
                         "stream")
    m = values.shape[0]
    _check_tagged(seg, m)
    n = out_s.shape[0]
    for name, t, w in (("out_s", out_s, 4), ("out_l", out_l, 4),
                       ("out_t", out_t, 3)):
        if t.dtype != values.dtype or t.dim() != 2 or t.shape != (n, w) \
                or t.stride(1) != 1:
            raise ValueError(f"{name} must be ({n}, {w}) {values.dtype} "
                             f"with unit column stride")
    if bounds.dtype != values.dtype or not bounds.is_contiguous() \
            or bounds.shape not in ((1, 4), (n + 1, 4)):
        raise ValueError(f"bounds must be a contiguous (1, 4) or "
                         f"({n + 1}, 4) {values.dtype} table")
    _same_device(values, seg=seg, bounds=bounds, out_s=out_s, out_l=out_l,
                 out_t=out_t)
    if runs is not None:
        _check_runs(runs, values)
    if not on_gpu(values):
        ref.isla_tagged_fold_ref(values, seg, bounds, out_s, out_l, out_t,
                                 runs=runs)
        return
    if n == 0:
        return
    if m >= 2 ** 31:
        raise ValueError(f"{m} samples exceed one tagged fold")
    if runs is not None:
        with torch.cuda.device(values.device):
            err = library().isla_tagged_fold_runs(
                _ptr(values), int(values.dtype == torch.float64), _ptr(seg),
                m, _ptr(bounds), int(bounds.shape[0] > 1), _ptr(out_s),
                out_s.stride(0), _ptr(out_l), out_l.stride(0), _ptr(out_t),
                out_t.stride(0), n, _ptr(runs.table), runs.n_keys,
                runs.n_blocks, TAGGED_TILE,
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "isla_tagged_fold")
        isla_tagged_fold.launches += 1
        if not runs.deferred:
            check_run_count(int(runs.count))
        return
    sorted_seg, perm = torch.sort(seg, stable=True)
    with torch.cuda.device(values.device):
        err = library().isla_tagged_fold(
            _ptr(values), int(values.dtype == torch.float64),
            _ptr(sorted_seg), _ptr(perm), m, _ptr(bounds),
            int(bounds.shape[0] > 1), _ptr(out_s), out_s.stride(0),
            _ptr(out_l), out_l.stride(0), _ptr(out_t), out_t.stride(0), n,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "isla_tagged_fold")
    isla_tagged_fold.launches += 1


isla_tagged_fold.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0 (the ISLA kernels' and
    ``flash_attention``'s)."""
    from .flash_attention import flash_attention

    isla_fold.launches = 0
    isla_fold.launches_f64 = 0
    pilot_stats.launches = 0
    isla_sketch.launches = 0
    isla_sketch_tagged.launches = 0
    isla_tagged_fold.launches = 0
    flash_attention.launches = 0


# ---------------------------------------------------------------------------
# The reference's Pallas signatures, on the fold kernel.
# ---------------------------------------------------------------------------


def _tile_chunks(rows: int, tm: int, stride: int) -> Tuple[int, int, int]:
    if rows % tm != 0:
        raise ValueError(f"rows {rows} not a multiple of tile rows {tm}")
    n_tiles = rows // tm
    n_sel = max(1, n_tiles // stride) if stride > 1 else n_tiles
    return tm * LANE, stride * tm * LANE, n_sel


def _as_bounds(bounds, device) -> torch.Tensor:
    return torch.as_tensor(bounds, dtype=torch.float32,
                           device=device).contiguous()


def isla_moments_batched(values3d: torch.Tensor, bounds, tm: int = DEFAULT_TM,
                         stride: int = 1,
                         prior: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Batched multi-cell ISLA moments (``isla_moments_batched_pallas``).

    values3d: (n, rows, 128), rows % tm == 0; bounds (4,) shared or (n, 4)
    per cell.  Reads every ``stride``-th (tm, 128) tile of each cell in
    place (no gather copy).  Returns (n, 2, 4) fp32 moments seeded from
    ``prior`` ((n, 2, 4); zeros when absent)."""
    n, rows, lane = values3d.shape
    if lane != LANE:
        raise ValueError(f"last dim must be {LANE}, got {lane}")
    chunks = _tile_chunks(rows, tm, stride)
    dev = values3d.device
    b = _as_bounds(bounds, dev)
    if b.dim() == 2 and b.shape != (n, 4):
        raise ValueError(f"per-cell bounds must be ({n}, 4), got "
                         f"{tuple(b.shape)}")
    if prior is None:
        out = torch.zeros((n, 2, 4), dtype=torch.float32, device=dev)
    else:
        if prior.shape != (n, 2, 4):
            raise ValueError(f"prior must be ({n}, 2, 4), got "
                             f"{tuple(prior.shape)}")
        out = prior.to(device=dev, dtype=torch.float32).clone()
    if not values3d.is_contiguous():
        values3d = values3d.contiguous()
    isla_fold(values3d.reshape(n, rows * LANE), b, out[:, 0, :],
              out[:, 1, :], chunks=chunks)
    return out


def isla_moments(values2d: torch.Tensor, bounds, tm: int = DEFAULT_TM,
                 stride: int = 1,
                 prior: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cell (``isla_moments_pallas``): (rows, 128) -> (2, 4)."""
    if values2d.dim() != 2:
        raise ValueError(f"need (rows, {LANE}), got {tuple(values2d.shape)}")
    if prior is not None and prior.shape != (2, 4):
        raise ValueError(f"prior must be (2, 4), got {tuple(prior.shape)}")
    return isla_moments_batched(
        values2d[None], bounds, tm=tm, stride=stride,
        prior=None if prior is None else prior[None])[0]


def isla_moments_grouped(values4d: torch.Tensor, bounds,
                         tm: int = DEFAULT_TM, stride: int = 1,
                         prior: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(group, block) cells (``isla_moments_grouped_pallas``): a reshape
    of (G, B) onto the batched cell axis, cell = group * B + block."""
    if values4d.dim() != 4:
        raise ValueError(f"need (n_groups, n_blocks, rows, {LANE}), got "
                         f"shape {tuple(values4d.shape)}")
    g, nb, rows, lane = values4d.shape
    b = _as_bounds(bounds, values4d.device)
    if b.dim() == 3:
        if b.shape != (g, nb, 4):
            raise ValueError(f"per-cell bounds must be ({g}, {nb}, 4), got "
                             f"{tuple(b.shape)}")
        b = b.reshape(g * nb, 4)
    if prior is not None:
        if prior.shape != (g, nb, 2, 4):
            raise ValueError(f"prior must be ({g}, {nb}, 2, 4), got "
                             f"{tuple(prior.shape)}")
        prior = prior.reshape(g * nb, 2, 4)
    out = isla_moments_batched(values4d.reshape(g * nb, rows, lane), b,
                               tm=tm, stride=stride, prior=prior)
    return out.reshape(g, nb, 2, 4)


def isla_fused(values3d: torch.Tensor, bounds, prior: torch.Tensor,
               sketch0, params, mode: str = "calibrated", geometry=None,
               tm: int = DEFAULT_TM, stride: int = 1,
               inv_scale: Optional[torch.Tensor] = None,
               active_cells: Optional[torch.Tensor] = None):
    """Fold + Phase 2 (``isla_fused_pallas``): the fold adds this round
    onto ``prior`` IN PLACE (the TPU version consumes the donated prior
    and returns its successor), then ``distributed.phase2`` solves every
    cell.  ``active_cells`` ((n_active,) int32 resident cell ids, pads out
    of range) is the compacted launch: ``values3d`` covers only those
    cells, their sums land on the mapped rows, pads drop, and pruned rows
    are never touched.  Returns ``(prior, partials)``."""
    from ..core.distributed import _scaled_solve_args, phase2

    n_all = prior.shape[0]
    if prior.shape != (n_all, 2, 4) or prior.dtype != torch.float32:
        raise ValueError("prior must be (n_cells, 2, 4) fp32")
    n, rows, lane = values3d.shape
    if lane != LANE:
        raise ValueError(f"last dim must be {LANE}, got {lane}")
    chunks = _tile_chunks(rows, tm, stride)
    dev = values3d.device
    b = _as_bounds(bounds, dev)
    if active_cells is None:
        if n != n_all:
            raise ValueError(f"values cover {n} cells, prior {n_all}")
        idx = None
    else:
        idx = active_cells.to(device=dev, dtype=torch.int32).contiguous()
        if idx.shape != (n,):
            raise ValueError(f"active_cells must be ({n},), got "
                             f"{tuple(idx.shape)}")
        if b.dim() == 2:  # per-cell cuts follow the compacted cells
            b = b[idx.long().clamp(0, n_all - 1)].contiguous()
    if not values3d.is_contiguous():
        values3d = values3d.contiguous()
    isla_fold(values3d.reshape(n, rows * LANE), b, prior[:, 0, :],
              prior[:, 1, :], cell_idx=idx, chunks=chunks)
    if geometry is not None:
        geometry = (float(geometry[0]), float(geometry[1]))
    thr, geometry = _scaled_solve_args(params, geometry, inv_scale)
    partials = phase2(prior[:, 0, :], prior[:, 1, :], sketch0, params,
                      mode=mode, geometry=geometry, thr=thr)
    return prior, partials


def _sketch_tiles(hash_hi3d: torch.Tensor, hash_lo3d: torch.Tensor,
                  valid3d: torch.Tensor, tm: int, regs3d: torch.Tensor
                  ) -> None:
    """Merge (n, rows, 128) limb panes, one cell each, into (n, 32, 128)
    uint8 registers in place."""
    n, rows, lane = hash_hi3d.shape
    if lane != LANE:
        raise ValueError(f"last dim must be {LANE}, got {lane}")
    if rows % tm != 0:
        raise ValueError(f"rows {rows} not a multiple of tile rows {tm}")
    if regs3d.shape != (n, REG_ROWS, LANE) or regs3d.dtype != torch.uint8 \
            or not regs3d.is_contiguous():
        raise ValueError(f"registers must be contiguous ({n}, {REG_ROWS}, "
                         f"{LANE}) uint8, got {regs3d.dtype} "
                         f"{tuple(regs3d.shape)}")
    flat = (n, rows * LANE)
    isla_sketch(limbs_to_bits(hash_hi3d, hash_lo3d).reshape(flat),
                regs3d.reshape(n, N_REGS),
                pad=(valid3d != 0).to(torch.float32).reshape(flat))


def isla_sketch_batched(hash_hi3d: torch.Tensor, hash_lo3d: torch.Tensor,
                        valid3d: torch.Tensor, tm: int = DEFAULT_TM,
                        prior: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Tiled HLL register merge (``isla_sketch_pallas``): one cell per
    (rows, 128) limb pane, rows % tm == 0; ``valid3d`` nonzero on real
    samples.  Returns (n_cells, 32, 128) uint8 registers seeded from
    ``prior`` (zeros when absent) — the (n_cells, 4096) plane, reshaped."""
    shape = (hash_hi3d.shape[0], REG_ROWS, LANE)
    if prior is None:
        out = torch.zeros(shape, dtype=torch.uint8, device=hash_hi3d.device)
    else:
        out = prior.to(device=hash_hi3d.device).clone()
    _sketch_tiles(hash_hi3d, hash_lo3d, valid3d, tm, out)
    return out


def isla_fused_sketch(values3d: torch.Tensor, bounds, prior: torch.Tensor,
                      prior_regs: torch.Tensor, hash_hi3d: torch.Tensor,
                      hash_lo3d: torch.Tensor, valid3d: torch.Tensor,
                      sketch0, params, mode: str = "calibrated",
                      geometry=None, tm: int = DEFAULT_TM, stride: int = 1,
                      inv_scale: Optional[torch.Tensor] = None):
    """``isla_fused`` with the register pane riding the tick
    (``isla_fused_sketch_pallas``): the fold adds this round onto
    ``prior`` and the sketch kernel merges it into ``prior_regs``
    ((n_cells, 32, 128) uint8), both IN PLACE, then Phase 2 solves every
    cell.  The hash panes carry the RAW measure bits, never the pane
    values.  Returns ``(prior, prior_regs, partials)``."""
    mom, partials = isla_fused(values3d, bounds, prior, sketch0, params,
                               mode=mode, geometry=geometry, tm=tm,
                               stride=stride, inv_scale=inv_scale)
    _sketch_tiles(hash_hi3d, hash_lo3d, valid3d, tm, prior_regs)
    return mom, prior_regs, partials
