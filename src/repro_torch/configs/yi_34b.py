"""yi-34b — llama-family dense GQA. [arXiv:2403.04652; hf]"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, head_dim=128, norm="rmsnorm", mlp="swiglu",
    rope_theta=5e6, source="[arXiv:2403.04652; hf]",
)

REDUCED = FULL.replace(
    name="yi-34b", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=320, vocab=512, head_dim=32, remat=False,
)

register(FULL, REDUCED)
