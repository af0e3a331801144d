"""phi4-mini-3.8b — dense GQA, RoPE + SwiGLU; 200k vocab. [arXiv:2412.08905; hf]"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=200064, head_dim=128, norm="rmsnorm", mlp="swiglu",
    tie_embeddings=True,  # 4.45B untied vs the advertised 3.8B => tied
    source="[arXiv:2412.08905; hf]",
)

REDUCED = FULL.replace(
    name="phi4-mini-3.8b", n_layers=2, d_model=96, n_heads=3, n_kv_heads=1,
    d_ff=256, vocab=512, head_dim=32, remat=False,
)

register(FULL, REDUCED)
