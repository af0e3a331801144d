"""Shared cases of the training parity tests: a reduced config in both
packages with the reference's params carried through
``convert.params_from``, a seeded numpy batch given to both, and one
loss-and-grad evaluation on each side.

In bf16 an MoE router logit may round apart, and over a layer or two a
token's competing gates can swap: each swap is counted, and must be a
near-tie of the port's own gates, and the port then takes the reference's
choice (read off the reference's dispatch product through a
``jax.debug.callback`` in the same jitted gradient run), so that the
gradients compare what both packages compute for the same routing."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models import model as RM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import moe as TMo
from repro_torch.core.tree import tree_leaves, tree_paths, tree_unflatten

B, S = 2, 64
# the CE in two chunks of 32 (the reduced configs' 512 exceeds S)
LOSS_CHUNK = 32


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def pair(arch, dtype, seed=0, **changes):
    """(reference cfg, params), (port cfg, params): the same weights."""
    cr = ref_config(arch, reduced=True).replace(param_dtype=dtype,
                                                **changes)
    ct = get_config(arch, reduced=True).replace(param_dtype=dtype,
                                                **changes)
    pr = RM.init_params(cr, jax.random.key(seed))
    pt = convert.params_from(jax.tree_util.tree_map(np.asarray, pr),
                             device="cpu")
    return (cr, pr), (ct, pt)


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def batch(cfg, b=B, s=S, seed=1):
    """A seeded numpy batch as (reference batch, port batch): S positions
    in all, the frontend prefix included."""
    rng = np.random.default_rng(seed)
    n = s - (cfg.frontend_len if cfg.frontend is not None else 0)
    toks = rng.integers(0, cfg.vocab, (b, n))
    labels = rng.integers(0, cfg.vocab, (b, n))
    br = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    bt = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    if cfg.frontend is not None:
        pre = (rng.normal(size=(b, cfg.frontend_len, cfg.d_model)) * 0.02
               ).astype(np.float32)
        br["prefix_embeds"] = jnp.asarray(pre).astype(cfg.param_dtype)
        bt["prefix_embeds"] = to_torch(np.asarray(br["prefix_embeds"]))
    return br, bt


@contextlib.contextmanager
def spied_reference_routes(routes: list):
    """Record, in call order, every reference MoE call's fp32 router
    logits (the softmax over the experts' axis) and dispatch (the operand
    of its dispatch product) from inside a jitted run: ``routes`` gets a
    ``{"logits", "dispatch"}`` a call."""
    einsum, softmax = jnp.einsum, jax.nn.softmax

    def record(name, x):
        if name == "logits":
            routes.append({})
        routes[-1][name] = np.array(x, np.float32)

    def spy_einsum(spec, *ops, **kw):
        if spec == "gtd,gtec->egcd":
            jax.debug.callback(functools.partial(record, "dispatch"), ops[1],
                               ordered=True)
        return einsum(spec, *ops, **kw)

    def spy_softmax(x, axis=-1, **kw):
        if x.ndim == 3 and axis == -1:   # the router's (G, Tg, E)
            jax.debug.callback(functools.partial(record, "logits"), x,
                               ordered=True)
        return softmax(x, axis=axis, **kw)

    jnp.einsum, jax.nn.softmax = spy_einsum, spy_softmax
    try:
        yield
    finally:
        jnp.einsum, jax.nn.softmax = einsum, softmax


def reference_run(cr, pr, br, routes=None):
    """The reference's (loss, aux, grads) from one jitted
    ``value_and_grad`` of ``train_loss``, as numpy."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: RM.train_loss(cr, p, b), has_aux=True))
    ctx = (spied_reference_routes(routes) if routes is not None
           else contextlib.nullcontext())
    with ctx:
        (loss, aux), grads = fn(pr, br)
        jax.effects_barrier()
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return to_np(loss), to_np(aux), to_np(grads)


@contextlib.contextmanager
def aligned_routes(ct, ref_routes: list, record: list):
    """The port's ``_route`` taking, call by call, the reference's choice
    where the two differ.  Each token whose experts differ is recorded as
    (call, group, token, the gap of the port's two competing router logits,
    the largest gap of that token's logits between the packages): a swap
    is a near-tie when the first is at most twice the second, as two
    gates that far apart cannot trade places."""
    real = TMo._route
    fac = TMo.virtual_expert_factor(ct)
    calls = iter(range(len(ref_routes)))

    def route(cfg, logits):
        dispatch, combine, aux = real(cfg, logits)
        i = next(calls)
        want = torch.from_numpy(ref_routes[i]["dispatch"][:, :, ::fac])
        if torch.equal(dispatch, want):
            return dispatch, combine, aux
        ref_logits = torch.from_numpy(ref_routes[i]["logits"])
        mine, theirs = dispatch.sum(-1), want.sum(-1)        # (G, Tg, E)
        for g, t in (mine != theirs).any(-1).nonzero().tolist():
            a = set(mine[g, t].nonzero()[:, 0].tolist())
            b = set(theirs[g, t].nonzero()[:, 0].tolist())
            if a - b and b - a:
                lg = logits[g, t].detach()
                record.append((i, g, t, float(
                    (lg[min(a - b)] - lg[min(b - a)]).abs()), float(
                    (lg - ref_logits[g, t]).abs().max())))
        # combine is the dispatch times each chosen expert's gate, as
        # _route builds it
        return want, want * torch.softmax(logits, -1)[..., None], aux

    TMo._route = route
    try:
        yield
    finally:
        TMo._route = real


def port_run(ct, pt, bt):
    """The port's (loss, aux, grads) by autograd, as numpy / tensors."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(pt)]
    loss, aux = TM.train_loss(ct, tree_unflatten(pt, leaves), bt)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree_unflatten(pt, list(grads)))


@functools.lru_cache(maxsize=None)
def parity_case(arch: str, dtype: str):
    """Both packages' loss, aux and grads on the same weights and batch
    (the CE in two chunks), and for an MoE config in bf16 the swapped
    choices (see ``aligned_routes``)."""
    (cr, pr), (ct, pt) = pair(arch, dtype, loss_chunk=LOSS_CHUNK)
    br, bt = batch(cr)
    align = cr.moe is not None and dtype == "bfloat16"
    routes, swaps = ([] if align else None), []
    ref = reference_run(cr, pr, br, routes)
    ctx = (aligned_routes(ct, routes, swaps) if align
           else contextlib.nullcontext())
    with ctx:
        port = port_run(ct, pt, bt)
    return dict(cfg=ct, ref=ref, port=port, swaps=swaps,
                grad_paths=[p for p, _ in tree_paths(port[2])])


def leaf_gaps(ref_grads, port_grads):
    """(path, max |port - ref| over the leaf's max |ref|, cosine) of every
    leaf, in the reference's order."""
    out = []
    for (path, a), b in zip(tree_paths(ref_grads), tree_leaves(port_grads)):
        a, b = np.asarray(a, np.float32), f32(b)
        scale = max(float(np.abs(a).max()), 1e-30)
        cos = float((a * b).sum()) / max(
            float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-30)
        out.append((path, float(np.abs(a - b).max()) / scale, cos))
    return out
