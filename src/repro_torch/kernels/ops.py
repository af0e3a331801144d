"""Kernel dispatch and the arbitrary-shape public wrappers.

``on_gpu`` is the one dispatch rule every kernel wrapper follows: a CPU
tensor takes the kernel's plain PyTorch version, a CUDA tensor launches
the kernel, anything else raises.  There is no fallback from the card to
the CPU.
"""
from __future__ import annotations

import torch


def on_gpu(t: torch.Tensor) -> bool:
    """True when ``t`` lies on a CUDA device (launch the kernel), False on
    the CPU (run the plain version); other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def isla_moments(values: torch.Tensor, bounds, tm: int = 512,
                 stride: int = 1) -> torch.Tensor:
    """ISLA Phase 1 moments of an arbitrary-shaped value tensor.

    bounds: (4,) = (s_lo, s_hi, l_lo, l_hi).  Returns (2, 4) fp32: rows
    (S, L) x cols (count, s1, s2, s3).  ``stride > 1`` reads every
    stride-th (tm, 128) tile only (tile sampling at rate 1/stride); inputs
    smaller than one tile are read whole, as in the reference.
    """
    from .isla_moments import LANE, isla_fold, isla_moments as one_cell

    b = torch.as_tensor(bounds, dtype=torch.float32,
                        device=values.device).contiguous()
    flat = values.reshape(-1)
    if flat.dtype not in (torch.float32, torch.bfloat16):
        flat = flat.to(torch.float32)
    n = flat.shape[0]
    per_tile = tm * LANE
    if stride == 1 or n < per_tile:
        out = torch.zeros((2, 4), dtype=torch.float32, device=values.device)
        isla_fold(flat.contiguous()[None], b, out[0:1], out[1:2])
        return out
    # Tile sampling needs the tile layout: pad strictly inside N (pads
    # match neither region) and read every stride-th tile.
    padded = -(-n // per_tile) * per_tile
    pad_value = float((b[1] + b[2]) * 0.5)
    v = torch.full((padded,), pad_value, dtype=flat.dtype,
                   device=values.device)
    v[:n] = flat
    return one_cell(v.reshape(-1, LANE), b, tm=tm, stride=stride)


def pilot_stats(values: torch.Tensor) -> torch.Tensor:
    """(count, sum, sumsq, min) of a value tensor, fp32 (the reference's
    ``ops.pilot_stats``; the kernel masks its own tail)."""
    from .isla_moments import pilot_stats as kernel
    return kernel(values.reshape(-1).to(torch.float32).contiguous())
