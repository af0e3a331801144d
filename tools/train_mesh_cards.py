#!/usr/bin/env python
"""Run ``chip_smoke.py``'s "lm train mesh" phase alone: olmo-1b's
sharded train step (``repro_torch.launch.train.build_step``) at full
width and depth over a one-rank ``("data", "model")`` nccl mesh, held to
the meshless steps, and, where four cards are visible, over a (2, 2)
mesh of them with the elastic drill to (1, 2).

    python3 tools/train_mesh_cards.py [--cards-only]

``--cards-only`` skips the one-card part (it needs four cards).  It
builds the port's kernels first, prints the card line (name and power
limit of each card), the phase's figures as the smoke prints them, and
one JSON line of everything; the checkpoints live under the git-ignored
``_train_mesh/`` and are removed at the end.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as S  # noqa: E402


def main() -> int:
    import torch
    from repro_torch.kernels import isla_moments as K

    ap = argparse.ArgumentParser()
    ap.add_argument("--cards-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_mesh_cards: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(S.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    K.build()
    for src in K.SOURCES:
        K.library(src)
    if args.cards_only:
        out = dict(shape=list(S.MESH_SHAPE))
    else:
        out = S.train_mesh_path()
        out["folds"] = S.check_telemetry_folds(out.pop("panes"))
    if torch.cuda.device_count() >= S.MESH_CARDS:
        out["cards"] = S.train_mesh_cards()
    if not args.cards_only:
        S.print_train_mesh(out)
    elif "cards" in out:
        c = out["cards"]
        print(json.dumps({k: c[k] for k in ("grid", "peaks",
                                             "fold_launches", "wall_s")}))
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.SmokeFailure as exc:
        print(f"train_mesh_cards FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
