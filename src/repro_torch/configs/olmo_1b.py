"""olmo-1b — dense GQA with non-parametric LayerNorm. [arXiv:2402.00838; hf]"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, head_dim=128, norm="ln_nonparam", mlp="swiglu",
    tie_embeddings=True, source="[arXiv:2402.00838; hf]",
)

REDUCED = FULL.replace(
    name="olmo-1b", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=384, vocab=512, head_dim=32, remat=False,
)

register(FULL, REDUCED)
