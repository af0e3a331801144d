"""adamw_ms.train (ms, program span) -- layer: train step
(train/optimizer.py adamw_update, clip included) -- moves
train_tokens_per_s.

The mean card time (``device_ms``: CUDA events around the call) of the
``adamw`` span a step of the measured window.  The step is device-bound,
so this is the card's time in the update.  None without the program's
spans or their card times."""
from perfbench.lib import spans


def read(rec):
    if rec["kind"] != "train" or "spans" not in rec:
        return None
    return spans.device_ms_a_step(rec, "adamw")
