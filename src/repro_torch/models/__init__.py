"""Assigned architecture pool: 10 LM-family transformers as framework configs
(port of `repro.models`).

Families: dense GQA decoders, MoE (top-k + shared experts, optional LP router
from the paper's solver), MLA (DeepSeek), SSM (Mamba2 SSD), hybrid
(Mamba2 + shared attention), encoder-decoder (audio), VLM backbone.  This
slice carries the serving path (init, prefill, decode, caches); the training
half of `Model` comes with the training slice.  No kernel of the port is on
this path: its products are torch.matmul / torch.einsum, as the reference's
are XLA's, outside any Pallas kernel.
"""
from repro_torch.models.config import (
    ModelConfig,
    MoEConfig,
    MLAConfig,
    SSMConfig,
    ShardingProfile,
)
from repro_torch.models.model import Model

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "ShardingProfile",
    "Model",
]
