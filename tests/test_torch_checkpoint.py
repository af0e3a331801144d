"""The port's checkpoints (``repro_torch.train.checkpoint``) on the CPU: the
reference's own cases (round trip, async writes with garbage collection,
``.tmp`` cleanup) on the port, and the format shared with the reference:
a checkpoint the reference wrote restores in the port, and one the port
wrote restores in the reference, bit for bit, bf16 leaves and the
optimizer state included, with the same manifest."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as RC
from repro.train import optimizer as RO
from repro_torch import convert
from repro_torch.models import model as TM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as TO
from repro_torch.core.tree import tree_leaves, tree_paths

import _torch_train_cases as C


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as a flat uint8 array (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _same_bits(a_tree, b_tree):
    pa, pb = tree_paths(a_tree), tree_paths(b_tree)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, a), (_, b) in zip(pa, pb):
        assert np.array_equal(_bits(a), _bits(b)), path


def _trained_pair(dtype="bfloat16"):
    """The reference's bf16 params and a non-trivial optimizer state (one
    AdamW step), and the port's copy of both."""
    (cr, pr), (ct, pt) = C.pair("olmo-1b", dtype)
    grads = jax.tree_util.tree_map(lambda p: p * 0.5 + 0.01, pr)
    pr, orr, _ = RO.adamw_update(RO.OptimizerConfig(), pr, grads,
                                 RO.init_opt_state(pr))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    pt = convert.params_from(np_tree(pr), device="cpu")
    ot = convert.opt_state_from(np_tree(orr), device="cpu")
    return (cr, {"params": pr, "opt": orr}), (ct, {"params": pt, "opt": ot})


# The reference's cases (tests/test_train_substrate.py) on the port.

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, tree, extra={"note": 1}, fingerprint="fp1")
    assert ckpt.latest_step(d) == 3
    restored, manifest = ckpt.restore(d, 3, tree, device="cpu",
                                      fingerprint="fp1")
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert manifest["extra"]["note"] == 1
    with pytest.raises(ValueError):
        ckpt.restore(d, 3, tree, device="cpu", fingerprint="other")


def test_checkpoint_async_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    ac = ckpt.AsyncCheckpointer(d, keep=2)
    tree = {"w": torch.zeros((8,))}
    for s in (1, 2, 3, 4):
        ac.submit(s, tree)
        tree["w"] += 1.0      # the submitted copy is not touched
    ac.close()
    assert ckpt.latest_step(d) == 4
    kept = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    back, _ = ckpt.restore(d, 4, tree, device="cpu")
    assert torch.equal(back["w"], torch.full((8,), 3.0))


def test_checkpoint_tmp_cleanup(tmp_path):
    d = str(tmp_path / "ck")
    os.makedirs(os.path.join(d, "step_00000007.tmp"))
    assert ckpt.latest_step(d) is None
    assert ckpt.clean_tmp(d) == 1
    assert ckpt.clean_tmp(str(tmp_path / "none")) == 0


def test_restore_refuses_a_missing_leaf_or_shape(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match=r"\['b'\]"):
        ckpt.restore(d, 1, {"a": torch.zeros(3), "b": torch.zeros(2)},
                     device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 1, {"a": torch.zeros(4)}, device="cpu")


# The format shared with the reference.

def test_manifest_is_the_references(tmp_path):
    """The same tree saved by both packages: the same leaf paths (keystr,
    ``.step`` / ``.m`` / ``.v`` for the optimizer state), files, shapes
    and logical dtypes, and the same bytes in every leaf file."""
    (_, ref_tree), (_, port_tree) = _trained_pair()
    RC.save(str(tmp_path / "r"), 5, ref_tree, fingerprint="f")
    ckpt.save(str(tmp_path / "t"), 5, port_tree, fingerprint="f")
    man = [json.load(open(tmp_path / k / "step_00000005" / "manifest.json"))
           for k in ("r", "t")]
    assert man[0] == man[1]
    paths = [l["path"] for l in man[1]["leaves"]]
    assert "['opt'].step" in paths
    assert "['params']['blocks'][0]['attn']['wq']" in paths
    assert {l["dtype"] for l in man[1]["leaves"]} == {"bfloat16", "float32",
                                                      "int32"}
    for leaf in man[1]["leaves"]:
        a = np.load(tmp_path / "r" / "step_00000005" / leaf["file"])
        b = np.load(tmp_path / "t" / "step_00000005" / leaf["file"])
        assert a.dtype == b.dtype and np.array_equal(a, b), leaf["path"]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """Restored into the port's abstract shapes (``meta``), every leaf is
    the reference's bit for bit, in its dtype."""
    (cr, ref_tree), (ct, port_tree) = _trained_pair()
    d = str(tmp_path / "ck")
    RC.save(d, 7, ref_tree, fingerprint=ct.name)
    like = {"params": TM.abstract_params(ct),
            "opt": TO.abstract_opt_state(TM.abstract_params(ct))}
    got, manifest = ckpt.restore(d, 7, like, device="cpu",
                                 fingerprint=ct.name)
    assert manifest["step"] == 7
    assert isinstance(got["opt"], TO.OptState)
    assert got["opt"].step.dtype == torch.int32
    for leaf, want in zip(tree_leaves(got), tree_leaves(port_tree)):
        assert leaf.dtype == want.dtype and leaf.device.type == "cpu"
    _same_bits(got, port_tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The reference restores the port's checkpoint (bf16 stored as uint16
    bits, viewed back through ``ml_dtypes``) bit for bit."""
    (cr, ref_tree), (_, port_tree) = _trained_pair()
    d = str(tmp_path / "ck")
    ckpt.save(d, 9, port_tree, fingerprint="t")
    like = jax.eval_shape(lambda: ref_tree)
    got, _ = RC.restore(d, 9, like, fingerprint="t")
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref_tree)):
        assert a.dtype == b.dtype
    _same_bits(jax.tree_util.tree_map(np.asarray, got),
               jax.tree_util.tree_map(np.asarray, ref_tree))


def test_restore_casts_to_the_like_dtype(tmp_path):
    """As the reference's ``jnp.asarray(arr, dtype=like.dtype)``: a bf16
    leaf restored into an fp32 like is the exact fp32 value."""
    d = str(tmp_path / "ck")
    x = torch.randn(16, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    ckpt.save(d, 1, {"x": x})
    got, _ = ckpt.restore(d, 1, {"x": torch.empty(16, device="meta")},
                          device="cpu")
    assert got["x"].dtype == torch.float32
    assert torch.equal(got["x"], x.float())
    want, _ = RC.restore(d, 1, {"x": jax.ShapeDtypeStruct((16,),
                                                          jnp.float32)})
    np.testing.assert_array_equal(np.asarray(want["x"]), got["x"].numpy())
