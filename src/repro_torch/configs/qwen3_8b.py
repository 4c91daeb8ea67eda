"""Qwen3-8B [dense]: qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
)

REDUCED = ModelConfig(
    name="qwen3-8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    remat=False,
)
