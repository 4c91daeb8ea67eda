"""SeamlessM4T-medium [audio]: encoder-decoder, multimodal [arXiv:2308.11596].

12L encoder + 12L decoder, d_model=1024, 16H, d_ff=4096, vocab=256206.
The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings [B, S, d_model] as the encoder input.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,
    enc_layers=12,
    encdec=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="frame",
)

REDUCED = ModelConfig(
    name="seamless-m4t-smoke",
    family="encdec",
    num_layers=2,
    enc_layers=2,
    encdec=True,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    frontend="frame",
    remat=False,
)
