"""The LM stack's serving path (``repro.models`` in torch): layers,
attention (prefill through the hand-written flash kernel), the layer
stack and the model API.  ``moe``, ``mamba2`` and ``frontends`` are not
ported yet (ROADMAP Queue A items 8-10)."""
from . import attention, layers, model, transformer

__all__ = ["attention", "layers", "model", "transformer"]
