"""The LM stack's serving path (``repro.models`` in torch): layers,
attention (prefill through the hand-written flash kernel), the layer
stack, the model API and the frontend stubs.  ``moe`` and ``mamba2`` are
not ported yet (ROADMAP Queue A items 8 and 9)."""
from . import attention, frontends, layers, model, transformer
from .frontends import frontend_embed_shape, synth_frontend_embeds

__all__ = ["attention", "frontends", "layers", "model", "transformer",
           "frontend_embed_shape", "synth_frontend_embeds"]
