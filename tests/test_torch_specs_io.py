"""The port's ``launch/specs_io.py`` and ``abstract_cache`` against the
reference's, and the specs against real inputs.

Every arch at full width and every shape of ``SHAPES`` that
``shape_applicable`` allows: the port's ``meta`` tensors leaf by leaf
against the reference's ``ShapeDtypeStruct``s, shapes equal and dtypes
equal under the one deliberate map (token ids and positions ``int32`` in
the reference, ``int64`` in the port).  Nothing is allocated on either
side.  Then, at reduced configs and a small ``ShapeConfig``, zeros of each
spec's shape and dtype go through ``train_loss``, ``serve_prefill`` and
``serve_decode`` on the CPU."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import specs_io as RSI
from repro.models import model as RM
from repro_torch.configs import (SHAPES, ShapeConfig, get_config, list_archs,
                                 shape_applicable)
from repro_torch.core.tree import tree_map, tree_paths
from repro_torch.launch import specs_io as TSI
from repro_torch.models import model as TM

# the reference's dtype -> the port's, where they differ on purpose
DTYPE_MAP = {"int32": "int64"}

CASES = [(arch, name) for arch in list_archs() for name in SHAPES
         if shape_applicable(get_config(arch), SHAPES[name])[0]]


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]


def _same_specs(got, want, what):
    got, want = tree_paths(got), _ref_leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, w) in zip(got, want):
        assert g.device.type == "meta", (what, path)
        assert tuple(g.shape) == tuple(w.shape), (what, path)
        wd = str(jnp.dtype(w.dtype))
        assert str(g.dtype).replace("torch.", "") == DTYPE_MAP.get(wd, wd), \
            (what, path, g.dtype, w.dtype)


def test_every_arch_has_an_applicable_shape():
    assert {a for a, _ in CASES} == set(list_archs())
    assert len(CASES) >= 3 * len(list_archs())


@pytest.mark.parametrize("arch, shape", CASES)
def test_input_specs_match_reference(arch, shape):
    got = TSI.input_specs(get_config(arch), shape)
    want = RSI.input_specs(ref_config(arch), shape)
    assert got["kind"] == want["kind"] == SHAPES[shape].kind
    assert sorted(got) == sorted(want)
    for part in sorted(k for k in want if k != "kind"):
        _same_specs(got[part], want[part], f"{arch} {shape} {part}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", list_archs())
def test_abstract_cache_matches_reference(arch, dtype):
    """Attention positions' k/v in ``dtype``, Mamba positions' ``h`` fp32
    and ``conv`` in ``dtype``, at full width."""
    got = TM.abstract_cache(get_config(arch), 3, 40,
                            dtype=getattr(torch, dtype))
    want = RM.abstract_cache(ref_config(arch), 3, 40,
                             dtype=getattr(jnp, dtype))
    _same_specs(got, want, f"{arch} {dtype}")
    for path, leaf in tree_paths(got):
        assert leaf.dtype == (torch.float32 if path.endswith("['h']")
                              else getattr(torch, dtype)), path


def test_abstract_cache_is_init_caches_shapes():
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    real = TM.init_cache(cfg, 2, 16, device="cpu")
    ab = TM.abstract_cache(cfg, 2, 16)
    assert [(p, tuple(x.shape), x.dtype) for p, x in tree_paths(real)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in tree_paths(ab)]


# reduced configs at a small shape of each kind (the paligemma prefix is
# 16 of the 64 positions; mamba's 64 are two chunks of 32)
SMALL = ("olmo-1b", "paligemma-3b", "mamba2-130m", "jamba-1.5-large-398b",
         "grok-1-314b")


def _zeros(tree):
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), tree)


@pytest.mark.parametrize("arch", SMALL)
def test_specs_describe_real_inputs(arch):
    """Zeros made from each spec run through the model API on the CPU and
    give outputs of the expected shape; the cache specs are the cache
    those calls take and fill."""
    cfg = get_config(arch, reduced=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    B, S = 2, 64
    train = TSI.train_input_specs(cfg, ShapeConfig("t", S, B, "train"))
    loss, aux = TM.train_loss(cfg, params, _zeros(train))
    assert loss.dim() == 0 and torch.isfinite(loss)
    assert aux["per_token_loss"].shape == (B, S)

    batch, cache = TSI.prefill_input_specs(
        cfg, ShapeConfig("p", S, B, "prefill"))
    logits, cache = TM.serve_prefill(cfg, params, _zeros(batch),
                                     _zeros(cache))
    assert logits.shape[:2] == (B, 1)
    assert torch.isfinite(logits.float()).all()

    inputs, dcache = TSI.decode_input_specs(
        cfg, ShapeConfig("d", S, B, "decode"))
    assert [(p, tuple(x.shape), x.dtype) for p, x in tree_paths(dcache)] \
        == [(p, tuple(x.shape), x.dtype) for p, x in tree_paths(cache)]
    tok = _zeros(inputs)
    tok["pos"].fill_(S - 1)
    out, _ = TM.serve_decode(cfg, params, tok["token"], tok["pos"], cache)
    assert out.shape == logits.shape and torch.isfinite(out.float()).all()
