"""Architecture configuration + registry (the port's own copy of
``repro.configs.base``, with the same values).

One ``ArchConfig`` describes everything the model stack needs: dimensions,
block pattern (dense / MoE / SSM / hybrid), norm & MLP flavors, frontend
stubs, and the sharding profile of the reference's dry-run.

``get_config(name, reduced=True)`` returns the same *family* at smoke-test
scale (small dims, few layers/experts) — used by the CPU tests; the port
serves the dense attention configs at full width on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    moe_every: int = 1          # every n-th block is MoE (jamba: 2)
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    group_size: int = 1024      # routing group (tokens) for dispatch einsum


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_inner: int                # channels in the SSM mixer
    d_state: int = 128          # N
    head_dim: int = 64          # P; n_heads = d_inner // head_dim
    d_conv: int = 4
    chunk: int = 256            # SSD chunk length
    n_groups: int = 1           # B/C groups (GVA-style)

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free
    n_kv_heads: int
    d_ff: int                   # 0 => no MLP block (pure mamba mixer)
    vocab: int

    head_dim: int = 128
    norm: str = "rmsnorm"       # rmsnorm | ln_nonparam | rmsnorm_1p
    mlp: str = "swiglu"         # swiglu | gelu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    attn_every: int = 1         # hybrid: 1 attention block per this many
    frontend: Optional[str] = None  # audio_stub | vision_stub
    frontend_len: int = 0       # prefix embedding positions from the stub
    param_dtype: str = "bfloat16"
    # sharding/runtime profile
    zero_opt: bool = True       # shard optimizer state over all mesh axes
    remat: bool = True
    remat_policy: str = "full"  # full (nothing saveable) | dots
    seq_shard_activations: bool = True
    subquadratic: bool = False  # eligible for long_500k
    loss_chunk: int = 512       # CE computed in seq chunks of this size
    source: str = ""            # provenance note [source; tier]

    # ---------------- derived ----------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over any mesh."""
        return int(math.ceil(self.vocab / 256) * 256)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def n_params(self) -> int:
        """Total parameter count (embedding included, padding excluded)."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        n = V * d                      # embed
        if not self.tie_embeddings:
            n += V * d                 # head
        per_attn = d * self.attn_dim + 2 * d * self.kv_dim \
            + self.attn_dim * d
        if self.qkv_bias:
            per_attn += self.attn_dim + 2 * self.kv_dim
        if self.mlp == "swiglu":
            per_mlp = 3 * d * f
        else:
            per_mlp = 2 * d * f
        per_moe = 0
        if self.moe is not None:
            e = self.moe.n_experts
            per_moe = d * e + e * per_mlp
            if self.moe.dense_residual:
                per_moe += per_mlp
        per_mamba = 0
        if self.mamba is not None:
            m = self.mamba
            conv_dim = m.d_inner + 2 * m.n_groups * m.d_state
            per_mamba = (d * (2 * m.d_inner + 2 * m.n_groups * m.d_state
                              + m.n_heads)
                         + m.d_conv * conv_dim + 3 * m.n_heads
                         + m.d_inner + m.d_inner * d)
        for i in range(self.n_layers):
            is_attn = self.block_is_attention(i)
            is_moe = self.block_is_moe(i)
            n += 2 * d if self.norm != "ln_nonparam" else 0  # 2 norms/blk
            if is_attn:
                n += per_attn
            elif self.mamba is not None:
                n += per_mamba
            if self.d_ff > 0 or self.moe is not None:
                n += per_moe if is_moe else (per_mlp if self.d_ff > 0 else 0)
        n += d if self.norm != "ln_nonparam" else 0  # final norm
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        per_mlp = (3 if self.mlp == "swiglu" else 2) * d * f
        e, k = self.moe.n_experts, self.moe.top_k
        inactive = 0
        for i in range(self.n_layers):
            if self.block_is_moe(i):
                inactive += (e - k) * per_mlp
        return self.n_params() - inactive

    def block_is_attention(self, i: int) -> bool:
        """Hybrid pattern: one attention block per ``attn_every`` blocks
        (jamba: position attn_every-1 of each group), else all attention
        unless the arch is attention-free."""
        if self.n_heads == 0:
            return False
        if self.mamba is None:
            return True
        return (i % self.attn_every) == (self.attn_every - 1)

    def block_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.moe_every) == (self.moe.moe_every - 1)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes assigned to the LM family (all 10 archs share these four).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "SKIP(full-attention): 512k dense-KV decode out of scope"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, "ArchConfig"] = {}
_REDUCED: Dict[str, "ArchConfig"] = {}


def register(cfg: ArchConfig, reduced: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    # import side-effect registration
    from . import all_archs  # noqa: F401
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_archs():
    from . import all_archs  # noqa: F401
    return sorted(_REGISTRY)
