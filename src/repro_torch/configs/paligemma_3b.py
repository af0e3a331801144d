"""paligemma-3b — SigLIP (stub) + gemma decoder backbone, MQA (kv=1).
head_dim = 2048/8 = 256 (gemma-2b convention).  [arXiv:2407.07726; hf]

The SigLIP vision tower is a STUB: input_specs() provides 256 precomputed
patch embeddings as a prefix.
"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, head_dim=256, norm="rmsnorm_1p", mlp="gelu",
    tie_embeddings=True, frontend="vision_stub", frontend_len=256,
    source="[arXiv:2407.07726; hf]",
)

REDUCED = FULL.replace(
    name="paligemma-3b", n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
    d_ff=384, vocab=512, head_dim=32, frontend_len=16, remat=False,
)

register(FULL, REDUCED)
