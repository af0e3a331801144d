"""The port's training forward and its gradients against the reference on
the CPU in bf16, for every config of ``list_archs()`` (the fp32 cases and
the pieces on their own are ``test_torch_train_model.py``).

Both packages round the activations, logits and grads to bf16 at the same
places, but their matrix products round apart, so the port is held to the
reference's bf16 results at bf16 tolerances: the loss within rel 2e-2,
the per-token and MoE aux losses within 2e-2 of their scale; each leaf's
gradient at a cosine of at least 0.99 to the reference's and within 5e-2
of its scale (its max |g|), 0.25 in a config with a Mamba mixer, where
the small per-head and per-channel leaves (``A_log``, ``D``, the conv
biases) sum bf16-rounded SSD terms over every position (seen: 0.065 for
mamba2-130m, 0.113 for jamba; at most 0.024 elsewhere; cosines at least
0.995).  An MoE token that takes another expert is counted, and must be a
near-tie: see ``_torch_train_cases.aligned_routes``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import list_archs
from repro_torch.core.tree import tree_leaves, tree_paths

import _torch_train_cases as C

ARCHS = list_archs()
TOL = 2e-2
GRAD_COS = 0.99
GRAD_TOL = 5e-2
GRAD_TOL_MAMBA = 0.25


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_loss_matches_reference(arch):
    r = C.parity_case(arch, "bfloat16")
    (lr, ar, _), (lt, at, _) = r["ref"], r["port"]
    assert lt.dtype == torch.float32
    assert float(lt) == pytest.approx(float(lr), rel=TOL)
    want, got = ar["per_token_loss"], C.f32(at["per_token_loss"])
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    if r["cfg"].moe is not None:
        for k in ("moe_lb_loss", "moe_z_loss"):
            assert float(at[k]) == pytest.approx(float(ar[k]), rel=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_grads_match_jax_grad(arch):
    r = C.parity_case(arch, "bfloat16")
    cfg, ref_g, port_g = r["cfg"], r["ref"][2], r["port"][2]
    assert [p for p, _ in tree_paths(ref_g)] == r["grad_paths"]
    for leaf, want in zip(tree_leaves(port_g), tree_leaves(ref_g)):
        assert str(leaf.dtype).replace("torch.", "") == str(want.dtype)
        assert torch.isfinite(leaf.float()).all()
    tol = GRAD_TOL if cfg.mamba is None else GRAD_TOL_MAMBA
    for path, err, cos in C.leaf_gaps(ref_g, port_g):
        assert cos >= GRAD_COS, (path, cos)
        assert err <= tol, (path, err)


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if C.get_config(a).moe is not None])
def test_bf16_moe_swaps_are_near_ties(arch):
    """Every token whose experts differ between the packages (counted and
    printed) is a near-tie: its two competing router logits in the port
    lie within twice the largest gap of that token's logits between the
    packages (two gates further apart cannot trade places), and that gap
    is below 0.1 (the router logits are of order one; seen: up to 0.0625,
    in jamba after bf16 Mamba layers)."""
    r = C.parity_case(arch, "bfloat16")
    print(f"{arch}: {len(r['swaps'])} tokens took another expert in bf16")
    for call, g, t, gap, drift in r["swaps"]:
        assert gap <= 2 * drift, (call, g, t, gap, drift)
        assert drift <= 0.1, (call, g, t, drift)
