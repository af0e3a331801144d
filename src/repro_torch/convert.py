"""Carry state from the JAX reference into the port.

The reference's state crosses as plain numbers and numpy arrays — never as
reference objects — so a warm ``repro`` serving tier can be dumped
(``dataclasses.asdict`` of its ``IslaParams``, its store's arrays) and the
port continues it tick for tick:

>>> import numpy as np
>>> from repro_torch.convert import params_from, store_from
>>> p = params_from({"e": 0.5, "beta": 0.9})
>>> st = store_from({"n_blocks": 2, "n_groups": 1,
...                  "boundaries": [60.0, 90.0, 110.0, 140.0],
...                  "sketch0": 100.0, "shift": 0.0,
...                  "mom_s": np.zeros((2, 4)), "mom_l": np.zeros((2, 4)),
...                  "totals": np.zeros((2, 3)),
...                  "n_sampled": np.zeros(2, np.int64)})
>>> st.n_cells, p.e
(2, 0.5)

``DeviceMomentStore.from_host(store_from(...), sizes, device=...)`` then
puts a carried store on the device (``dtype=torch.float64`` continues a
float64 reference store tick for tick, bit for bit).  ``params_from`` also
carries an LM's param pytree into the port's ``models``, and
``opt_state_from`` its AdamW state into the port's ``train``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from .core.distributed import resolve_device
from .core.moment_store import MomentStore
from .core.sketch import M
from .core.types import Anchor, Boundaries, IslaParams


def params_from(fields: Mapping[str, Any], device="cuda"):
    """The port's parameters from the reference's, as numbers and arrays.

    * An LM param pytree (a mapping with ``"blocks"``, the reference's
      ``models.model.init_params`` layout with every leaf a numpy array —
      ``jax.tree_util.tree_map(np.asarray, params)``) becomes the same
      pytree of tensors on ``device`` — the card unless the caller asks
      for the CPU, like the port's other entry points (without a card it
      raises) — dtype kept (bfloat16 arrays cross bit for bit): the port's
      ``models`` take that layout as it is, the ``blocks`` leaves stacked
      over groups.
    * Otherwise ``fields`` are ``IslaParams`` field values (any subset; the
      rest keep their defaults), plain numbers on no device: ``device`` is
      not read.  Unknown fields raise.
    """
    if "blocks" in fields:
        return _tensors(fields, resolve_device(device))
    known = {f.name for f in dataclasses.fields(IslaParams)}
    extra = set(fields) - known
    if extra:
        raise ValueError(f"unknown IslaParams fields {sorted(extra)}")
    return IslaParams(**{k: type(getattr(IslaParams(), k))(v)
                         for k, v in fields.items()})


def opt_state_from(state, device="cuda"):
    """The port's ``train.optimizer.OptState`` from the reference's, as
    numpy (``jax.tree_util.tree_map(np.asarray, opt_state)``: anything
    with ``step``, ``m`` and ``v``, as attributes or keys), bit for bit,
    on ``device`` (the card unless the caller asks for the CPU)."""
    from .train.optimizer import OptState

    dev = resolve_device(device)
    get = (state.__getitem__ if isinstance(state, Mapping)
           else lambda k: getattr(state, k))
    return OptState(step=_tensor(get("step"), dev),
                    m=_tensors(get("m"), dev), v=_tensors(get("v"), dev))


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: cross the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _tensors(tree, device: torch.device):
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return _tensor(tree, device)


def boundaries_from(cuts: Sequence[float]) -> Boundaries:
    """``Boundaries`` from ``(s_lo, s_hi, l_lo, l_hi)``."""
    s_lo, s_hi, l_lo, l_hi = (float(c) for c in np.asarray(cuts).ravel())
    return Boundaries(s_lo=s_lo, s_hi=s_hi, l_lo=l_lo, l_hi=l_hi)


def anchor_from(boundaries: Sequence[float], sketch0: float, shift: float,
                sigma: float, support: int = 0, source: str = "global",
                skew: float = 0.0) -> Anchor:
    """An ``Anchor`` from its frame: the four cuts, ``sketch0``, ``shift``
    and ``sigma`` (plus the provenance fields, when known)."""
    return Anchor(boundaries=boundaries_from(boundaries),
                  sketch0=float(sketch0), shift=float(shift),
                  sigma=float(sigma), support=int(support),
                  source=str(source), skew=float(skew))


def store_from(fields: Mapping[str, Any],
               anchor: Optional[Anchor] = None) -> MomentStore:
    """A host ``MomentStore`` from the reference store's fields: the
    geometry (``n_blocks``, ``n_groups``), the frame (``boundaries`` as
    four cuts, ``sketch0``, ``shift``), the float64 state arrays
    (``mom_s``, ``mom_l``, ``totals``, int64 ``n_sampled``) and, when
    present, ``rounds``, ``has_regions``, ``has_totals`` and the COUNT
    DISTINCT plane (``has_sketch`` with ``regs``, uint8 ``(n_cells,
    4096)``)."""
    n_blocks, n_groups = int(fields["n_blocks"]), int(fields["n_groups"])
    n_cells = n_blocks * n_groups
    arrays = {}
    for name, width in (("mom_s", 4), ("mom_l", 4), ("totals", 3)):
        a = np.array(fields[name], dtype=np.float64)
        if a.shape != (n_cells, width):
            raise ValueError(f"{name} must be ({n_cells}, {width}), got "
                             f"{a.shape}")
        arrays[name] = a
    n_sampled = np.array(fields["n_sampled"], dtype=np.int64)
    if n_sampled.shape != (n_blocks,):
        raise ValueError(f"n_sampled must be ({n_blocks},), got "
                         f"{n_sampled.shape}")
    regs = fields.get("regs")
    has_sketch = bool(fields.get("has_sketch", regs is not None))
    if has_sketch:
        if regs is None:
            raise ValueError("has_sketch needs the regs plane")
        regs = np.array(regs)
        if regs.dtype != np.uint8 or regs.shape != (n_cells, M):
            raise ValueError(f"regs must be ({n_cells}, {M}) uint8, got "
                             f"{regs.dtype} {regs.shape}")
    elif regs is not None:
        raise ValueError("regs given for a store without a sketch plane")
    return MomentStore(
        n_blocks=n_blocks, n_groups=n_groups,
        boundaries=boundaries_from(fields["boundaries"]),
        sketch0=float(fields["sketch0"]), shift=float(fields["shift"]),
        n_sampled=n_sampled, rounds=int(fields.get("rounds", 0)),
        has_regions=bool(fields.get("has_regions", True)),
        has_totals=bool(fields.get("has_totals", True)), anchor=anchor,
        has_sketch=has_sketch, regs=regs, **arrays)
