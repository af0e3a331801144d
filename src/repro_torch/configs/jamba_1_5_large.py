"""jamba-1.5-large-398b — hybrid Mamba + attention (1 attn per 8 blocks) with
MoE 16e top-2 every other block.  Sub-quadratic => runs long_500k.
[arXiv:2403.19887; hf]

72 layers = 9 groups x (7 mamba + 1 attention); MoE on odd block indices.
Mamba mixer: d_inner = 2*d_model = 16384, head_dim 64 -> 256 SSD heads.
"""
from .base import ArchConfig, MambaConfig, MoEConfig, register

FULL = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128, norm="rmsnorm", mlp="swiglu",
    moe=MoEConfig(n_experts=16, top_k=2, moe_every=2, group_size=256),
    # group_size=256 aligns MoE routing groups with the seq-shard grid
    # (S/tp) so dispatch/combine stay shard-local (§Perf A5).
    # chunk=256 (§Perf B2 measured chunk=128 as WORSE: doubled inter-chunk
    # scan carries outweigh the smaller Q^2 tiles)
    mamba=MambaConfig(d_inner=16384, d_state=128, head_dim=64, chunk=256),
    attn_every=8, subquadratic=True,
    source="[arXiv:2403.19887; hf]",
)

REDUCED = FULL.replace(
    name="jamba-1.5-large-398b", n_layers=8, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
    moe=MoEConfig(n_experts=4, top_k=2, moe_every=2, group_size=64),
    mamba=MambaConfig(d_inner=256, d_state=16, head_dim=32, chunk=32),
    attn_every=8, remat=False,
)

register(FULL, REDUCED)
