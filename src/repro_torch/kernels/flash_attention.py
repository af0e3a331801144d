"""Wrapper and binding of the hand-written causal flash-attention kernel
(Hopper, sm_90a).

The CUDA kernel lives in ``csrc/flash_attention.cu`` (the note there
names the TPU kernel it replaces, its bound and its design); it is built
with the port's other sources by ``isla_moments.build`` and loaded with
``ctypes``.  ``flash_attention`` given CPU tensors runs the kernel's plain
PyTorch version (``ref.flash_attention_ref``); given CUDA tensors it
launches the kernel, or raises — it never falls back.
``flash_attention.launches`` counts the calls that launched the kernel on
the card (one ``__global__`` launch each), and nothing else.  Given fake
tensors (a dry-run trace) it returns an empty output of the right shape
(``ops.fake_kernel``).  A launch, a plain run on the CPU (its own ops
not counted) or a fake call records the kernel's operations and bytes in
an installed ``roofline.op_cost.CostCounter``, so the counter sees the
program the card runs on any device.
"""
from __future__ import annotations

import torch

from . import ref
from .isla_moments import _raise_on, _same_device, library
from ..roofline.op_cost import is_fake, no_count, record_kernel
from .ops import fake_kernel, on_gpu

SOURCE = "flash_attention.cu"
HEAD_DIMS = (32, 64, 128, 256)  # every head_dim of the repo's configs


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    groups: int = 1) -> torch.Tensor:
    """Causal attention of every (batch * head) slice, fp32 online softmax.

    q : (BH, S, hd) fp32 or bf16, contiguous; on the card ``hd`` is one
        of ``HEAD_DIMS`` (the plain version on the CPU takes any).
    k, v : (BH / groups, S, hd), contiguous, of q's type; q head ``bh``
        attends over KV head ``bh // groups`` (GQA with ``groups`` q heads
        per KV head; for q laid out as B x H heads this is
        ``(bh // H) * KV + (bh % H) // groups``).
    Returns (BH, S, hd) in q's type: row i is the softmax of
    ``(q[i] * hd**-0.5) . k[j]`` over ``j <= i`` applied to v.  S may be
    any length.
    """
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, hd), got {tuple(q.shape)}")
    bh, s, hd = q.shape
    groups = int(groups)
    if groups < 1 or bh % groups != 0:
        raise ValueError(f"groups ({groups}) must divide BH ({bh})")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be fp32 or bf16, got {q.dtype}")
    kv_shape = (bh // groups, s, hd)
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != kv_shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {kv_shape} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _same_device(q, k=k, v=v)
    if is_fake(q):
        return fake_kernel("flash_attention", (q, k, v), torch.empty_like(q),
                           *cost(q, k), q.dtype)
    if not on_gpu(q):
        with no_count():
            out = ref.flash_attention_ref(q, k, v, groups=groups)
        record_kernel("flash_attention", *cost(q, k), q.dtype)
        return out
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if s >= 2 ** 31:
        raise ValueError(f"sequence length {s} exceeds the kernel's int")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads it through TMA tensor maps)")
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    with torch.cuda.device(q.device):
        err = library(SOURCE).flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
            hd, groups, int(q.dtype == torch.bfloat16), float(hd ** -0.5),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "flash_attention")
    flash_attention.launches += 1
    record_kernel("flash_attention", *cost(q, k), q.dtype)
    return out


def cost(q: torch.Tensor, k: torch.Tensor) -> "tuple[float, float]":
    """(operations, bytes) of one call, the bound of ``PERF.md``'s kernel
    table: 4 * hd flops for each (query, key <= query) pair, S(S+1)/2 a
    head; q, k, v read once and the output written once."""
    bh, s, hd = q.shape
    return (4.0 * bh * hd * s * (s + 1) / 2,
            float((2 * bh + 2 * k.shape[0]) * s * hd * q.element_size()))


flash_attention.launches = 0
