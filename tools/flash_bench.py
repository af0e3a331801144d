#!/usr/bin/env python
"""Time the bf16 ``flash_attention`` kernel on the card at the LM paths'
shapes, beside PyTorch's ``scaled_dot_product_attention`` and the call's
bound.

    python3 tools/flash_bench.py [--src PATH] [--label NAME] [--reps N]

``--src`` is the ``src`` directory of the port to time (default: this
checkout's), so two trees of the port can be timed on one card in one
run, in turns (parent, change, change, parent).  Only the wrapper's
signature, which every tree of the port shares, is used.

The shapes are the prefill calls of ``chip_smoke.py``'s LM phases:
olmo-1b's longest and shortest prompts (16 heads, hd 128, MHA),
paligemma-3b's two prefills (hd 256, 8 q heads over one KV head),
grok-1-314b's and arctic-480b's longest (48 and 56 q heads over 8 KV
heads, hd 128) and reduced jamba's (4 q heads over 2, hd 32).  q, k and v
are drawn from a numpy seed (normal, q and k scaled by 0.3).  For each
shape it prints one JSON line: the card and its power limit, the tree's
label, the shape, ``ms`` (CUDA events over ``--reps`` calls, the card
held busy while the host enqueues them, so host time does not count),
``sdpa_ms`` (the same for ``scaled_dot_product_attention`` with
``enable_gqa``), ``bound_ms`` (the larger of the bytes q, k, v and o
move over 3.35 TB/s and the 4 hd flops of each (query, key <= query) pair
over 989 TFLOP/s), ``tflops`` (those flops over ``ms``), and the
agreement with the plain version run on the same card tensors:
``max_abs_err``, ``over`` (elements beyond max(2e-2, one bf16 ulp)) and
``repeat_equal`` (a second launch gives identical bits).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (name, BH, KV heads, S, hd): the LM phases' prefill calls.
SHAPES = (("olmo-1b", 16, 16, 1966, 128),
          ("olmo-1b", 16, 16, 442, 128),
          ("paligemma-3b", 16, 2, 1023, 256),
          ("paligemma-3b", 8, 1, 2047, 256),
          ("grok-1-314b", 48, 8, 1718, 128),
          ("arctic-480b", 56, 8, 1718, 128),
          ("jamba-reduced", 4, 2, 192, 32))
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
SLEEP_CYCLES_PER_S = 2.0e9   # above the H100's SM clock: sleeps err long
TOL = 2e-2


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean ms a call over ``reps`` warmed calls by CUDA events, the card
    spinning (``torch.cuda._sleep``) while the host enqueues them."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * reps * host_s, 0.5)
                          * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bench(name, bh, kv, s, hd, reps, label, card) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    groups = bh // kv
    rng = np.random.default_rng(bh * 100003 + s * 31 + hd)

    def t(heads, scale):
        return torch.as_tensor(rng.normal(size=(heads, s, hd)) * scale,
                               dtype=torch.bfloat16, device="cuda")

    q, k, v = t(bh, 0.3), t(kv, 0.3), t(kv, 1.0)
    got = FA.flash_attention(q, k, v, groups=groups)
    again = FA.flash_attention(q, k, v, groups=groups)
    want = ref.flash_attention_ref(q, k, v, groups=groups).double()
    torch.cuda.synchronize()
    diff = (got.double() - want).abs()
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
        torch.log2(want.abs().clamp_min(torch.finfo(torch.bfloat16).tiny))))
    ms = time_ms(lambda: FA.flash_attention(q, k, v, groups=groups), reps)
    q4, k4, v4 = (x[None] for x in (q, k, v))
    gqa = {"enable_gqa": True} if groups > 1 else {}
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, **gqa), reps)
    flops = 4.0 * bh * hd * s * (s + 1) / 2
    t_bytes = (2 * bh + 2 * kv) * s * hd * 2 / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return dict(card=card, label=label, name=name, shape=[bh, s, hd],
                kv_heads=kv, groups=groups, ms=ms, sdpa_ms=sdpa_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                gflop=flops / 1e9, tflops=flops / (ms * 1e-3) / 1e12,
                max_abs_err=float(diff.max()),
                over=int((diff > ulp.clamp_min(TOL)).sum()),
                repeat_equal=bool(torch.equal(got, again)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import isla_moments as K

    K.build([FA.SOURCE])
    card = card_line()
    for shape in SHAPES:
        print(json.dumps(bench(*shape, args.reps, args.label, card)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
