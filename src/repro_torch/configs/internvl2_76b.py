"""InternVL2-76B [vlm]: InternViT frontend (stub) + InternLM2-76B backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 [arXiv:2404.16821].
The ViT frontend is a STUB: input_specs() provides precomputed patch
embeddings [B, 256, d_model]; only the LM backbone is modelled.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="patch",
    frontend_len=256,
)

REDUCED = ModelConfig(
    name="internvl2-76b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    frontend="patch",
    frontend_len=4,
    remat=False,
)
