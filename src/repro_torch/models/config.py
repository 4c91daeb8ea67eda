"""Model configuration covering every assigned architecture family (port of
`repro.models.config`, field for field).

`param_count` counts the parameters of `Model.init` on the meta device, the
counterpart of the reference's `jax.eval_shape`: shapes only, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "ShardingProfile",
    "ModelConfig",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int  # d_ff per routed expert
    num_shared: int = 0  # shared (always-on) experts
    capacity_factor: float = 1.25
    router: str = "topk"  # "topk" | "lp" (paper-solver balanced routing)
    lp_iters: int = 16  # dual-ascent iterations for router="lp"
    lp_gamma: float = 0.1
    # dispatch groups: 0 = one global group (baseline); >0 = group-local
    # routing (sort/rank/scatter stay within a group, which the step builders
    # align with the dp sharding so dispatch never crosses shards — only the
    # expert einsum communicates, via the canonical EP all-to-all).
    groups: int = 0
    group_size: int = 4096  # tokens per group when groups are derived


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block."""

    state_dim: int = 128  # N
    head_dim: int = 64  # P
    expand: int = 2  # d_inner = expand * d_model
    n_groups: int = 1  # B/C groups
    conv_width: int = 4
    chunk: int = 256  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ShardingProfile:
    """Logical->mesh sharding rules.

    tp_axis shards weights' feature dims (Megatron column/row split);
    fsdp=True additionally shards the other weight dim over the dp axes
    (FSDP / ZeRO-3 style, for >=70B archs).  dp axes shard the batch.
    Non-divisible dims silently drop the axis (see sharding_rules.maybe).
    """

    tp_axis: str = "model"
    dp_axes: tuple[str, ...] = ("data",)  # extended with "pod" on multi-pod
    fsdp: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # attention flavour
    qk_norm: bool = False  # qwen3
    qkv_bias: bool = False  # qwen2
    rope_theta: float = 1e4
    causal: bool = True
    # mlp flavour
    mlp_type: str = "swiglu"  # swiglu | geglu
    # optional submodules
    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0  # leading dense layers in MoE stacks
    dense_ff: int = 0  # their FFN width (0 -> d_ff)
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0  # hybrid: shared attention block every N layers
    # encoder-decoder
    encdec: bool = False
    enc_layers: int = 0
    # modality frontend stub (precomputed embeddings via input_specs)
    frontend: Optional[str] = None  # "patch" | "frame"
    frontend_len: int = 256
    # numerics / structure
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"  # master params
    remat: bool = True
    attn_chunk: int = 1024  # KV-chunked (flash-style) attention block
    # KV-cache storage: "bfloat16" (default) or "int8" (per-token-per-head
    # absmax scales stored alongside; halves decode cache HBM traffic)
    kv_cache_dtype: str = "bfloat16"
    # long-context capability marker (sub-quadratic sequence mixing)
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models.model import Model

        return Model(self).param_count()

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top-k routed only)."""
        from repro_torch.models.model import Model

        return Model(self).param_count(active_only=True)
