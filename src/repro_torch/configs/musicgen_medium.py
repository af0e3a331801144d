"""musicgen-medium — decoder-only over EnCodec tokens; the audio frontend
(EnCodec) is a STUB: input_specs() provides precomputed frame embeddings.
[arXiv:2306.05284; hf]

head_dim = 1536/24 = 64; GQA kv == heads (MHA).
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab=2048, head_dim=64, norm="rmsnorm", mlp="gelu",
    frontend="audio_stub", frontend_len=64,
    source="[arXiv:2306.05284; hf]",
)

REDUCED = FULL.replace(
    name="musicgen-medium", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=256, head_dim=32, frontend_len=8, remat=False,
)

register(FULL, REDUCED)
