"""The LM training path (``repro.train`` in torch): AdamW, the
step-indexed synthetic stream, the train step with its ISLA loss
telemetry, checkpoints in the reference's format, elastic plans and
int8 gradient compression."""
from . import checkpoint, compression, data, elastic, optimizer, train_step

__all__ = ["checkpoint", "compression", "data", "elastic", "optimizer",
           "train_step"]
