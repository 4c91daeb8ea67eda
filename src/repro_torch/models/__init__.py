"""Assigned architecture pool: 10 LM-family transformers as framework configs
(port of `repro.models`).

Families: dense GQA decoders, MoE (top-k + shared experts, optional LP router
from the paper's solver), MLA (DeepSeek), SSM (Mamba2 SSD), hybrid
(Mamba2 + shared attention), encoder-decoder (audio), VLM backbone: init,
the training loss (`repro_torch.training` differentiates it), prefill,
decode and the caches.  No kernel of the port is on these paths: its
products are torch.matmul / torch.einsum, as the reference's are XLA's,
outside any Pallas kernel.
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
