"""telemetry_ms.train (ms, program span) -- layer: train step
(train/train_step.py telemetry: core/metrics.loss_stats, Phase 1 on
isla_fold, Phase 2 in torch) -- moves train_tokens_per_s.

The mean card time (``device_ms``) of the ``telemetry`` span a step of
the measured window: ISLA's cost inside a step.  None without the
program's spans or their card times."""
from perfbench.lib import spans


def read(rec):
    if rec["kind"] != "train" or "spans" not in rec:
        return None
    return spans.device_ms_a_step(rec, "telemetry")
