"""The LM stack's serving path (``repro.models`` in torch): layers,
attention (prefill through the hand-written flash kernel), the MoE
channel, the layer stack, the model API and the frontend stubs.
``mamba2`` is not ported yet (ROADMAP Queue A item 9)."""
from . import attention, frontends, layers, model, moe, transformer
from .frontends import frontend_embed_shape, synth_frontend_embeds

__all__ = ["attention", "frontends", "layers", "model", "moe", "transformer",
           "frontend_embed_shape", "synth_frontend_embeds"]
