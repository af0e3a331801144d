"""qwen2.5-32b — dense GQA with QKV bias. [hf:Qwen/Qwen2.5-*; hf]"""
from .base import ArchConfig, register

FULL = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab=152064, head_dim=128, norm="rmsnorm", mlp="swiglu", qkv_bias=True,
    rope_theta=1e6, source="[hf:Qwen/Qwen2.5-0.5B; hf]",
)

REDUCED = FULL.replace(
    name="qwen2.5-32b", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=352, vocab=512, head_dim=32, remat=False,
)

register(FULL, REDUCED)
