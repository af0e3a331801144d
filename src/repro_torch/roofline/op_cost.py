"""Per-rank cost of an eagerly traced program: the port's counterpart of
``repro.roofline.hlo_parse``.

The reference parses the SPMD module XLA compiled for one device.  The
port compiles nothing: a step is a sequence of aten ops, and on DTensors
each rank runs its own local ops and the collectives that redistribute
between them.  ``CostCounter`` is a ``TorchDispatchMode`` that counts
**one rank's local work** as the ops go by, on real tensors or on fake
ones (``launch.dryrun`` traces rank 0 of a fake process group that way,
allocating nothing and launching nothing):

* flops: the matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``convolution``) at 2 * output elements * contracted size on their
  local shapes (``torch.utils.flop_counter``'s formulas, the rule of
  ``hlo_parse._dot_flops``), by the inputs' dtype; an einsum reaches the
  mode as the products it decomposes into.
* hbm bytes: each op's unique tensor inputs plus its outputs at their
  dtypes.  The port runs eagerly and fuses nothing, so this is counted
  per op (the reference's count is per fusion); view and metadata ops
  (an op whose outputs alias its inputs, or with no tensor output) are
  free, as ``hlo_parse._PLUMBING`` is.
* collectives: the ``_c10d_functional`` ops DTensor issues (and its
  ``_dtensor.shard_dim_alltoall``, an all-to-all on a card mesh), in
  ``hlo_parse``'s five kinds and wire-byte rules, n being the op's
  group size:
    all-reduce      2 * S * (n-1)/n      (S = the tensor)
    all-gather      S_out * (n-1)/n
    reduce-scatter  S_in * (n-1)/n
    all-to-all      S_out * (n-1)/n
    collective-permute  S_out
* hand-written kernels: a kernel wrapper records its own cost
  (``record_kernel``: its name, operations, bytes by the bound of
  ``PERF.md``'s kernel table) whether it launched on the card, ran its
  plain version on the CPU (whose ops are not counted) or took fake
  inputs, so a real run on either device and a fake trace of one step
  agree.

Two things the mode must not count: the DTensor-level op, whose shapes
are global (the mode returns ``NotImplemented`` for DTensor arguments,
so DTensor dispatches and the mode sees the local ops it runs), and the
shape inference DTensor's sharding propagator runs at global shapes on
the first call of each op and layout (paused while it runs).

``Cost.unknown_trip_whiles`` is kept for the reference's keys and is
always 0: an eager trace runs every loop, so no trip count is unknown.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# _c10d_functional op name prefix -> collective kind
_KINDS = (("all_reduce", "all-reduce"),
          ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"),
          ("permute", "collective-permute"))
_COLLECTIVE_NS = ("_c10d_functional",)

# ops that allocate without writing, only wait, or view without an alias
# annotation: no traffic
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "lift_fresh", "detach",
         "_unsafe_view"}

_PRODUCTS = ("mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution")

_ACTIVE: List["CostCounter"] = []


def _zero_kinds(kind=float):
    return {c: kind(0) for c in COLLECTIVES}


@dataclasses.dataclass
class Cost:
    """One rank's cost: ``hlo_parse.Cost``'s fields, and the flops by
    dtype (``flops_by_dtype``: "bfloat16", "float32", "float64")."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=_zero_kinds)
    coll_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: _zero_kinds(int))
    unknown_trip_whiles: int = 0
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        for c in COLLECTIVES:
            self.coll_bytes[c] += other.coll_bytes[c] * mult
            self.coll_counts[c] += int(other.coll_counts[c] * mult)
        self.unknown_trip_whiles += other.unknown_trip_whiles
        for k, v in other.flops_by_dtype.items():
            self.flops_by_dtype[k] = self.flops_by_dtype.get(k, 0.0) \
                + v * mult

    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    def add_flops(self, flops: float, dtype: torch.dtype) -> None:
        self.flops += flops
        key = str(dtype).replace("torch.", "")
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + flops


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def collective_kind(func) -> Optional[str]:
    """The collective kind of a ``_c10d_functional`` op (or of DTensor's
    ``shard_dim_alltoall``, an all-to-all), else None."""
    name = func._schema.name.split("::")[-1]
    if func.namespace == "_dtensor" and name == "shard_dim_alltoall":
        return "all-to-all"
    if func.namespace not in _COLLECTIVE_NS:
        return None
    for prefix, kind in _KINDS:
        if name.startswith(prefix):
            return kind
    return None


def wire_bytes(kind: str, in_bytes: float, out_bytes: float,
               n: int) -> float:
    """``hlo_parse``'s bytes a device puts on the wire for one
    collective of group size ``n``."""
    frac = (n - 1) / n if n > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * out_bytes * frac
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "reduce-scatter":
        return in_bytes * frac
    if kind == "all-to-all":
        return out_bytes * frac
    return out_bytes


class CostCounter(TorchDispatchMode):
    """While installed (``with CostCounter() as c:``), counts this
    process's local ops into ``c.cost`` (a ``Cost``), per op into
    ``c.ops`` (name -> count, flops, bytes, input bytes, wire bytes), the
    hand-written kernels' records into ``c.kernels``, and the peak of the
    bytes its program's own tensors hold into ``c.peak_bytes``."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.ops: Dict[str, Dict[str, float]] = {}
        self.kernels: List[dict] = []
        self._paused = 0
        # live bytes of the storages the counted program allocated (not
        # its arguments'), and their peak
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, list] = {}

    # -- the mode ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._track(args, kwargs, out)
            self._count(func, args, kwargs, out)
        return out

    def _track(self, args, kwargs, out) -> None:
        """Each output's storage: a new one (aliasing no input) adds its
        bytes to ``live_bytes`` until the last tensor on it is freed; a
        view or in-place result of a tracked one holds it too."""
        ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            rec = self._live.get(key)
            if rec is None:
                if key in ins:
                    continue        # a view of an argument's storage
                rec = self._live[key] = [st.nbytes(), 0]
                self.live_bytes += rec[0]
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            rec[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        rec = self._live.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self.live_bytes -= rec[0]
            del self._live[key]

    def _count(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        if not outs or _is_view(func):
            return
        name = func._schema.name.split("::")[-1]
        if name in _FREE:
            return
        seen, ins = set(), []
        for t in _tensors((args, kwargs)):
            if id(t) not in seen:
                seen.add(id(t))
                ins.append(t)
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        flops, wire = 0.0, 0.0
        kind = collective_kind(func)
        if kind is not None:
            wire = wire_bytes(kind, in_b, out_b, _group_size(args))
            self.cost.coll_bytes[kind] += wire
            self.cost.coll_counts[kind] += 1
        elif name in _PRODUCTS:
            from torch.utils.flop_counter import flop_registry
            flops = float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
            self.cost.add_flops(flops, ins[0].dtype)
        self.cost.hbm_bytes += in_b + out_b
        self._tally(f"{func.namespace}.{name}", flops, in_b + out_b, in_b,
                    wire)

    def _tally(self, key, flops, nbytes, in_b, wire) -> None:
        row = self.ops.setdefault(key, {"count": 0, "flops": 0.0,
                                        "bytes": 0.0, "in_bytes": 0.0,
                                        "wire_bytes": 0.0})
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        row["in_bytes"] += in_b
        row["wire_bytes"] += wire

    # -- kernels -----------------------------------------------------------

    def add_kernel(self, name: str, flops: float, nbytes: float,
                   dtype: torch.dtype, fake: bool) -> None:
        self.kernels.append({"name": name, "flops": float(flops),
                             "bytes": float(nbytes),
                             "dtype": str(dtype).replace("torch.", ""),
                             "fake": bool(fake)})
        self.cost.add_flops(float(flops), dtype)
        self.cost.hbm_bytes += float(nbytes)
        self._tally(f"kernel.{name}", float(flops), float(nbytes), 0.0, 0.0)

    # -- install -----------------------------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        self._unpatch = _pause_shape_inference(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()
            _ACTIVE.remove(self)

    def op_table(self) -> List[dict]:
        """Per-op rows, the largest (bytes, then flops) first."""
        rows = [dict(op=k, **v) for k, v in self.ops.items()]
        rows.sort(key=lambda r: (-r["bytes"], -r["flops"], r["op"]))
        return rows

    def write_ops(self, path: str) -> None:
        """The op table as gzipped JSON (the counterpart of the
        reference's ``.hlo.gz``)."""
        with gzip.open(path, "wt") as f:
            json.dump(self.op_table(), f)


def _pause_shape_inference(counter: CostCounter):
    """Counting paused while DTensor's sharding propagator infers an op's
    global output shape (it runs the op on fake global-shape inputs, once
    per op and layout).  Returns the undo."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    inner = getattr(ShardingPropagator, name)

    def paused(self, *a, **k):
        counter._paused += 1
        try:
            return inner(self, *a, **k)
        finally:
            counter._paused -= 1

    setattr(ShardingPropagator, name, paused)
    return lambda: setattr(ShardingPropagator, name, inner)


def active() -> Optional[CostCounter]:
    """The innermost installed counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def record_kernel(name: str, flops: float, nbytes: float,
                  dtype: torch.dtype, fake: bool = False) -> None:
    """A hand-written kernel's cost, into the innermost counter (nothing
    when none is installed)."""
    c = active()
    if c is not None:
        c.add_kernel(name, flops, nbytes, dtype, fake)


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (shapes and dtypes, no data)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


@contextlib.contextmanager
def no_count():
    """Counting paused (work that is not the traced program's)."""
    c = active()
    if c is not None:
        c._paused += 1
    try:
        yield
    finally:
        if c is not None:
            c._paused -= 1
