"""The stacked fold and register merge on the CPU: ``isla_fold_stack``
and ``isla_sketch_stack`` (one launch for every key of a dense tick on
the card) against the same stack written out key by key through the
one-key ``isla_fold`` / ``isla_sketch`` calls, bit for bit, directly and
through ``distributed.fold_panes`` / ``sketch_panes``; and the key-table
checks.  The card's side is in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import distributed as D
from repro_torch.kernels import isla_moments as K
from _torch_stack_cases import (fold_key_by_key, fold_stacked,
                                sketch_key_by_key, sketch_stacked,
                                stack_case)

CASES = [dict(), dict(compacted=True), dict(bf16=True),
         dict(stack="loop", n_b=5, q=24),
         dict(stack="loop", n_b=6, q=24, compacted=True),
         dict(stack="wide", n_b=5, q=60)]
IDS = ["groups_1_1_3_3", "compacted", "bf16", "loop", "loop_compacted",
       "wide"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fold_panes_equals_key_by_key(case, rng):
    c = stack_case(rng, "cpu", **case)
    want, got = c["prior"].clone(), c["prior"].clone()
    fold_key_by_key(want, c["panes"], c["kw"])
    fold_stacked(got, c["panes"], c["kw"])
    assert torch.equal(got, want)
    assert not torch.equal(got, c["prior"])
    if c["kw"]["active_cells"] is not None:
        idx = c["kw"]["active_cells"][0].numpy()
        idle = np.setdiff1d(np.arange(len(got)), idx[idx < len(got)])
        assert idle.size and torch.equal(got[idle], c["prior"][idle])


@pytest.mark.parametrize("case", CASES[:2] + CASES[3:],
                         ids=IDS[:2] + IDS[3:])
def test_sketch_panes_equals_key_by_key(case, rng):
    c = stack_case(rng, "cpu", **case)
    want, got = c["regs0"].clone(), c["regs0"].clone()
    sketch_key_by_key(want, c["bits"], c["panes"], c["kw"])
    sketch_stacked(got, c["bits"], c["panes"], c["kw"])
    assert torch.equal(got, want)
    assert not torch.equal(got, c["regs0"])


def test_fold_stack_takes_per_row_cuts_and_chunks(rng):
    """A stack of one-table keys with per-row cuts (``bound_row=-1``) and
    an affine, over chunked reads, equals its keys one by one."""
    n_b, q = 7, 6 * 32
    x = torch.as_tensor(rng.normal(1.0, 0.2, (n_b, q)), dtype=torch.float32)
    cuts = torch.as_tensor(np.asarray([0.6, 0.9, 1.1, 1.4])[None]
                           + rng.uniform(-0.05, 0.05, (n_b, 1)),
                           dtype=torch.float32)
    keys = [K.StackKey(1, offset=0, bound_row=-1),
            K.StackKey(1, offset=n_b, affine=(1.3, -0.07), bound_row=-1)]
    chunks = (32, 64, 3)
    prior = torch.as_tensor(rng.uniform(0, 3, (2 * n_b, 11)),
                            dtype=torch.float32)
    got, want = prior.clone(), prior.clone()
    K.isla_fold_stack(x, cuts, got[:, 0:4], got[:, 4:8], got[:, 8:11],
                      keys=keys, chunks=chunks)
    for k in keys:
        rows = want[k.offset:k.offset + n_b]
        K.isla_fold(x, cuts, rows[:, 0:4], rows[:, 4:8], rows[:, 8:11],
                    affine=k.affine, chunks=chunks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_keys", [4, K.MAX_KEYS + 4])
def test_panes_take_one_launch_per_max_keys(n_keys, rng, monkeypatch):
    """``fold_panes`` and ``sketch_panes`` make one stacked call for up
    to ``MAX_KEYS`` keys (a call is one launch on the card), and split a
    longer stack, which still equals its keys one by one."""
    c = stack_case(rng, "cpu")
    keys = (list(zip(*[c["kw"][f] for f in ("n_groups_list", "gid_slots",
                                              "valid_slots", "key_affine",
                                              "bound_slots")])) * 6)[:n_keys]
    n_cells = sum(k[0] for k in keys) * c["n_b"]
    kw = dict(n_groups_list=tuple(k[0] for k in keys),
              gid_slots=tuple(k[1] for k in keys),
              valid_slots=tuple(k[2] for k in keys),
              key_affine=tuple(k[3] for k in keys),
              bound_slots=tuple(k[4] for k in keys), active_cells=None)
    prior = torch.as_tensor(rng.uniform(0, 5, (n_cells, 11)),
                            dtype=torch.float32)
    regs0 = torch.as_tensor(rng.integers(0, 12, (n_cells, K.N_REGS)),
                            dtype=torch.uint8)
    calls = []
    for name in ("isla_fold_stack", "isla_sketch_stack"):
        real = getattr(D, name)
        monkeypatch.setattr(D, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    got, want = prior.clone(), prior.clone()
    fold_stacked(got, c["panes"], kw)
    regs, regs_want = regs0.clone(), regs0.clone()
    sketch_stacked(regs, c["bits"], c["panes"], kw)
    per = -(-n_keys // K.MAX_KEYS)
    assert calls == ["isla_fold_stack"] * per + ["isla_sketch_stack"] * per
    fold_key_by_key(want, c["panes"], kw)
    sketch_key_by_key(regs_want, c["bits"], c["panes"], kw)
    assert torch.equal(got, want)
    assert torch.equal(regs, regs_want)


def _bad_tables(n_b):
    ok = K.StackKey(1)
    return {
        "keys": [ok] * (K.MAX_KEYS + 1),
        "gid slot": [K.StackKey(2, gid_slot=1)],
        "needs a gid": [K.StackKey(2)],
        "valid slot": [ok, K.StackKey(1, valid_slot=2, offset=n_b)],
        "n_groups": [K.StackKey(0)],
        "run past": [ok, K.StackKey(1, offset=n_b + 1)],
    }


@pytest.mark.parametrize("what", list(_bad_tables(1)))
@pytest.mark.parametrize("entry", ["fold", "sketch"])
def test_key_table_rejects_bad_stacks(entry, what):
    n_b, q = 3, 8
    table = _bad_tables(n_b)[what]
    pad = torch.ones((n_b, q))
    gid = torch.zeros((n_b, q), dtype=torch.int32)
    kw = dict(keys=table, pad=pad, gid_panes=(gid,), valid_panes=(pad,))
    with pytest.raises(ValueError, match=what):
        if entry == "fold":
            out = torch.zeros((2 * n_b, 4))
            K.isla_fold_stack(torch.zeros((n_b, q)), torch.zeros((1, 4)),
                              out, out.clone(), **kw)
        else:
            K.isla_sketch_stack(torch.zeros((n_b, q), dtype=torch.int64),
                                torch.zeros((2 * n_b, K.N_REGS),
                                            dtype=torch.uint8), **kw)


def test_fold_key_table_rejects_bad_bound_rows():
    n_b, q = 3, 8
    out = torch.zeros((n_b, 4))
    for row, table in ((2, torch.zeros((2, 4))), (-1, torch.zeros((2, 4)))):
        with pytest.raises(ValueError, match="bound row"):
            K.isla_fold_stack(torch.zeros((n_b, q)), table, out, out.clone(),
                              keys=[K.StackKey(1, bound_row=row)])
    with pytest.raises(ValueError, match="fp32 table"):
        K.isla_fold_stack(torch.zeros((n_b, q)), torch.zeros(4), out,
                          out.clone(), keys=[K.StackKey(1)])
