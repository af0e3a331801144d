"""mamba2-130m — attention-free SSD (state-space duality). d_ff=0: blocks are
pure Mamba2 mixers.  Sub-quadratic => runs long_500k.
[arXiv:2405.21060; unverified]
"""
from .base import ArchConfig, MambaConfig, register

FULL = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, norm="rmsnorm", tie_embeddings=True,
    mamba=MambaConfig(d_inner=1536, d_state=128, head_dim=64, chunk=256),
    subquadratic=True, seq_shard_activations=False, zero_opt=False,
    source="[arXiv:2405.21060; unverified]",
)

REDUCED = FULL.replace(
    name="mamba2-130m", n_layers=2, d_model=64, vocab=256,
    mamba=MambaConfig(d_inner=128, d_state=16, head_dim=32, chunk=32),
    remat=False,
)

register(FULL, REDUCED)
