#!/usr/bin/env python
"""Run the training CLI twice, uninterrupted, on the card, and say how far
the two runs part: the repeatability that ``chip_smoke.py``'s "lm train
cli" phase sets its tolerance from.

    python3 tools/train_cli_repeat.py [--runs N]

Each run is ``python -m repro_torch.launch.train`` on olmo-1b at full
width and depth, at the phase's shape and flags (``chip_smoke.cli_argv``:
6 steps at 4 x 1024, checkpoints every 4 steps, the exact loss mean
beside the ISLA one), in a child process that sees this card alone, into
a directory of its own under the git-ignored ``_train_cli/``.  It prints
one JSON line: the card and its power limit, the free bytes under that
directory and the checkpoint tree's bytes, each run's wall seconds and
step seconds, and against the first run the largest relative gap of any
history value (every key but ``dt_s``) and of any leaf of the step-6
checkpoint (relative to the leaf's largest magnitude; 0 when every leaf
has the same bits).  Each run's step-4 checkpoint is removed once the run
ends, and the directory at the end.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as S  # noqa: E402


def main() -> int:
    import torch
    from repro_torch.configs import get_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_cli_repeat: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import isla_moments as K

    K.build()
    for src in K.SOURCES:
        K.library(src)
    base = S.CLI_DIR
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    tb = S.tree_bytes(get_config(S.CLI_ARCH))
    out = dict(card=S.card_line(), dir=str(base),
               free_bytes=shutil.disk_usage(base).free, tree_bytes=tb,
               runs=[])
    if out["free_bytes"] < 3 * tb:
        print(json.dumps(out))
        print("train_cli_repeat: fewer free bytes than three checkpoints",
              file=sys.stderr)
        return 1
    try:
        for i in range(args.runs):
            d = base / f"run{i}"
            res = base / f"run{i}.json"
            _, wall = S.run_cli(S.cli_argv(d, out=res), "cuda")
            hist = json.loads(res.read_text())["history"]
            run = dict(wall_s=wall, step_s=[r["dt_s"] for r in hist],
                       loss=[r["loss"] for r in hist])
            if i:
                first = json.loads((base / "run0.json").read_text())
                run["rows_max_rel_gap"] = max(
                    S.close_metrics(g, w, math.inf)
                    for g, w in zip(hist, first["history"]))
                run["checkpoint"] = S.compare_ckpts(
                    d / f"step_{S.CLI_STEPS:08d}",
                    base / "run0" / f"step_{S.CLI_STEPS:08d}", math.inf)
            # only the step-6 checkpoints are compared
            shutil.rmtree(d / f"step_{S.CLI_EVERY:08d}")
            out["runs"].append(run)
            print(json.dumps(run), flush=True)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
