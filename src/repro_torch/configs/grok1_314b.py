"""grok-1-314b — 8-expert top-2 MoE. [hf:xai-org/grok-1; unverified]

Gated MLP (3 matmuls) — that is what puts the total at ~314B:
8e * 64L * 3 * 6144 * 32768 = 309B + attention/embed ~ 317B.
"""
from .base import ArchConfig, MoEConfig, register

FULL = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, head_dim=128, norm="rmsnorm", mlp="swiglu",
    moe=MoEConfig(n_experts=8, top_k=2, moe_every=1, group_size=256),
    # group_size=256 aligns MoE routing groups with the seq-shard grid
    # (S/tp) so dispatch/combine stay shard-local (§Perf A5).
    source="[hf:xai-org/grok-1; unverified]",
)

REDUCED = FULL.replace(
    name="grok-1-314b", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=32,
    moe=MoEConfig(n_experts=4, top_k=2, moe_every=1, group_size=64),
    remat=False,
)

register(FULL, REDUCED)
