"""The LM stack (``repro.models`` in torch), serving and training: layers
and the chunked CE loss, attention (prefill through the hand-written
flash kernel, training through plain torch ops), the MoE channel, the
Mamba2 mixer, the layer stack, the model API and the frontend stubs."""
from . import attention, frontends, layers, mamba2, model, moe, transformer
from .frontends import frontend_embed_shape, synth_frontend_embeds

__all__ = ["attention", "frontends", "layers", "mamba2", "model", "moe",
           "transformer",
           "frontend_embed_shape", "synth_frontend_embeds"]
