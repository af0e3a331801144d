"""The port's ``flash_attention`` (its plain version, on the CPU) against
the reference's Pallas kernel in interpret mode and its jnp oracle, on the
same seeded numpy inputs; and the wrapper's checks and dispatch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import isla_moments as K

# The reference sweep's tolerances (tests/test_kernels_flash.py).
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _qkv(rng, bh, s, hd, kv_heads=None):
    kv_heads = bh if kv_heads is None else kv_heads
    q = (rng.normal(size=(bh, s, hd)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(kv_heads, s, hd)) * 0.3).astype(np.float32)
    v = rng.normal(size=(kv_heads, s, hd)).astype(np.float32)
    return q, k, v


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# The two smallest shapes of the reference sweep: (BH, S, hd, bq, bk).
@pytest.mark.parametrize("shape", [(3, 512, 32, 128, 256),
                                   (4, 1024, 64, 256, 256),
                                   (2, 512, 256, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_pallas_kernel(shape, dtype):
    bh, s, hd, bq, bk = shape
    arrays = _qkv(np.random.default_rng(0), bh, s, hd)
    got = FA.flash_attention(*_port(arrays, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (bh, s, hd)
    pallas = flash_attention_pallas(*_jax(arrays, dtype), bq=bq, bk=bk,
                                    interpret=True)
    oracle = flash_attention_ref(*_jax(arrays, dtype))
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ragged_length_matches_oracle(dtype):
    """S = 200 divides no block size: the Pallas kernel refuses it; the
    port takes any S, held against the reference's oracle."""
    arrays = _qkv(np.random.default_rng(1), 2, 200, 64)
    got = FA.flash_attention(*_port(arrays, dtype))
    want = flash_attention_ref(*_jax(arrays, dtype))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])


def test_flash_gqa_matches_expanded_oracle():
    """Two batches of 6 q heads over 2 KV heads (G = 3): q head bh reads KV
    head bh // 3, i.e. (bh // H) * KV + (bh % H) // G."""
    q, k, v = _qkv(np.random.default_rng(2), 12, 160, 32, kv_heads=4)
    got = FA.flash_attention(*_port((q, k, v), "float32"), groups=3)
    want = flash_attention_ref(*_jax((q, np.repeat(k, 3, axis=0),
                                      np.repeat(v, 3, axis=0)), "float32"))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4)
    H, KV, G = 6, 2, 3
    for bh in range(12):
        assert bh // G == (bh // H) * KV + (bh % H) // G


def test_flash_mqa_hd256_matches_expanded_oracle():
    """paligemma's layout: one batch of 8 q heads of 256 over a single KV
    head (G = 8, MQA), at a ragged S, bf16 and fp32."""
    q, k, v = _qkv(np.random.default_rng(5), 8, 120, 256, kv_heads=1)
    for dtype in ("float32", "bfloat16"):
        got = FA.flash_attention(*_port((q, k, v), dtype), groups=8)
        want = flash_attention_ref(*_jax((q, np.repeat(k, 8, axis=0),
                                          np.repeat(v, 8, axis=0)), dtype))
        assert got.shape == (8, 120, 256)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype])


def test_flash_wrapper_checks_and_dispatch():
    q, k, v = _port(_qkv(np.random.default_rng(3), 2, 64, 32), "float32")
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        FA.flash_attention(*meta)
    # The head_dim check is the kernel's: on the CPU the plain version
    # takes hd 256 (and any other), as the reference does.
    q256, k256, v256 = _qkv(np.random.default_rng(6), 1, 8, 256)
    got = FA.flash_attention(*_port((q256, k256, v256), "float32"))
    want = flash_attention_ref(*_jax((q256, k256, v256), "float32"))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL["float32"])
    with pytest.raises(ValueError, match="must be contiguous"):
        FA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v)
    with pytest.raises(ValueError, match="groups"):
        FA.flash_attention(q, k, v, groups=3)
    with pytest.raises(ValueError, match="k must be"):
        FA.flash_attention(q, k[:1], v)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        FA.flash_attention(q.double(), k.double(), v.double())


def test_flash_counter_stays_zero_on_the_cpu():
    K.reset_launch_counts()
    q, k, v = _port(_qkv(np.random.default_rng(4), 2, 96, 32), "bfloat16")
    FA.flash_attention(q, k, v)
    assert FA.flash_attention.launches == 0
