"""Mesh cases shared by the CPU tests (``test_torch_mesh.py``, and the
reference run they start in a subprocess) and the card test
(``test_torch_cuda.py``): a stack of three keys over B = 10 blocks, its
seeded draws, and each tick's payload, built with numpy from a seed.

B = 10 is divisible by neither 3 nor 4, so meshes of 3 and 4 shards carry
inert pad blocks.  The keys are (groups, WHERE): a GROUP BY key, a WHERE
key and a key with both, so the shards' local key offsets differ from
key to key.  The payload builders take either package's stacks and
stores (``key_seg``, ``shift``, ``scale``), so the port and the
reference tick on the same streams.
"""
import numpy as np

B, G = 10, 3
SIZES = [100 + 7 * i for i in range(B)]
SHARDS = (1, 2, 3, 4)
KEYS = ((G, False), (1, True), (G, True))
BASE = dict(shift=0.0, sketch0=3.0, bounds=(0.5, 2.0, 2.0, 8.0))
OTHER = dict(shift=0.5, sketch0=1.5, bounds=(0.2, 1.0, 1.0, 4.0))


def anchors(hetero: bool = False):
    """Each key's anchor: all ``BASE``, or the second key ``OTHER`` (a
    per-key refined anchor: the per-cell cuts table and key affines)."""
    return [OTHER if hetero and k == 1 else BASE for k in range(len(KEYS))]


def make_stores(fresh, boundaries, hetero=False, sketch=(), **kw):
    """One store a key: ``fresh`` is a package's
    ``DeviceMomentStore.fresh_device``, ``boundaries`` its ``Boundaries``;
    the keys whose index is in ``sketch`` carry a register plane."""
    return [fresh(B, boundaries(*a["bounds"]), sketch0=a["sketch0"],
                  shift=a["shift"], block_sizes=SIZES, n_groups=g,
                  has_sketch=k in sketch, **kw)
            for k, ((g, _), a) in enumerate(zip(KEYS, anchors(hetero)))]


def draw(rng, quotas=None):
    """One chunk of a block-major draw: raw values, block ids, GROUP BY
    codes, a WHERE mask and the per-block quotas."""
    if quotas is None:
        quotas = rng.integers(3, 9, size=B)
    quotas = np.asarray(quotas, dtype=np.int64)
    n = int(quotas.sum())
    return dict(vals=rng.lognormal(1.0, 0.7, size=n),
                bids=np.repeat(np.arange(B), quotas),
                gids=rng.integers(0, G, size=n), mask=rng.random(n) < 0.6,
                quotas=quotas)


def tagged_payload(stack, stores, d, limbs=None, runs=True, shuffle=None):
    """``tick`` keywords of a tagged pass: every key's matched slice in key
    order, block by block, in its own frame, placed by ``stack.key_seg``;
    with ``runs`` the (key, block) run lengths (``key_runs``), with a
    ``shuffle`` rng the stream permuted and no table.  ``limbs`` (a
    package's ``sketch.value_limbs``) gives a sketch stack its hash
    limbs."""
    segs, vals, his, los, lens = [], [], [], [], []
    hi = lo = None
    if limbs is not None:
        hi, lo = limbs(d["vals"])
    for k, (st, (g, where)) in enumerate(zip(stores, KEYS)):
        mask = d["mask"] if where else None
        keep = slice(None) if mask is None else mask
        segs.append(stack.key_seg(k, st, d["bids"],
                                  d["gids"] if g > 1 else None, mask))
        vals.append(((d["vals"] + st.shift) / st.scale)[keep])
        if hi is not None:
            his.append(hi[keep])
            los.append(lo[keep])
        if runs:
            lens.append(np.bincount(d["bids"][keep], minlength=B))
    kw = dict(values=np.concatenate(vals), seg=np.concatenate(segs),
              quotas=d["quotas"])
    if hi is not None:
        kw["hash_limbs"] = (np.concatenate(his), np.concatenate(los))
    if runs:
        kw["runs"] = np.stack(lens)
    if shuffle is not None:
        perm = shuffle.permutation(kw["values"].size)
        kw["values"], kw["seg"] = kw["values"][perm], kw["seg"][perm]
        if hi is not None:
            kw["hash_limbs"] = tuple(h[perm] for h in kw["hash_limbs"])
        kw.pop("runs", None)
    return kw


def dense_payload(d):
    """``tick`` keywords of a dense pass: the raw block-major stream and
    each key's GROUP BY codes and WHERE mask (shared arrays, so the panes
    dedupe)."""
    return dict(values=d["vals"], quotas=d["quotas"],
                dense=([d["gids"] if g > 1 else None for g, _ in KEYS],
                       [d["mask"] if where else None for _, where in KEYS]))


# Ways a stack-level run table can fail to describe its stream (the key
# offsets are the stack's own, so ``_torch_tagged_cases``' "offsets" has
# no stack-level form).
WRONG_TABLES = ("boundary", "foreign_id", "other_key", "short", "negative")


def spoil(kind, kw):
    """A tagged payload's ids or run lengths spoiled the ``kind`` way (one
    of ``WRONG_TABLES``), as a new keyword dict."""
    kw = dict(kw, seg=kw["seg"].copy(), runs=kw["runs"].copy())
    lens = kw["runs"].reshape(-1)
    if kind == "boundary":  # a run boundary one sample late
        r = np.flatnonzero(lens)[2]
        nxt = r + 1 + np.flatnonzero(lens[r + 1:])[0]
        lens[r] += 1
        lens[nxt] -= 1
    elif kind == "foreign_id":  # a sample tagged with another block
        kw["seg"][5] += 1
    elif kind == "other_key":  # a sample tagged with another key's cell
        kw["seg"][-1] = 0
    elif kind == "short":  # the runs end before the stream
        lens[np.flatnonzero(lens)[-1]] -= 1
    elif kind == "negative":  # a run that ends before it starts
        lens[np.flatnonzero(lens)[0]] *= -1
    return kw
