"""arctic-480b — 128-expert top-2 MoE with a dense residual FFN in parallel.
[hf:Snowflake/snowflake-arctic-base; hf]
"""
from .base import ArchConfig, MoEConfig, register

FULL = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_dim=128, norm="rmsnorm", mlp="swiglu",
    moe=MoEConfig(n_experts=128, top_k=2, moe_every=1, dense_residual=True, group_size=256),
    # group_size=256 aligns MoE routing groups with the seq-shard grid
    # (S/tp) so dispatch/combine stay shard-local (§Perf A5).
    source="[hf:Snowflake/snowflake-arctic-base; hf]",
)

REDUCED = FULL.replace(
    name="arctic-480b", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, head_dim=32,
    moe=MoEConfig(n_experts=4, top_k=2, moe_every=1, dense_residual=True,
                  group_size=64),
    remat=False,
)

register(FULL, REDUCED)
