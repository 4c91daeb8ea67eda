"""Zamba2-2.7B [hybrid]: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  54 Mamba2 layers (d_model=2560, ssm_state=64) with one
*shared* attention+MLP block (32H, d_ff=10240) applied every 6 layers.
Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=1, conv_width=4),
    attn_period=6,
    subquadratic=True,
)

REDUCED = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, n_groups=1, conv_width=4, chunk=32),
    attn_period=2,
    subquadratic=True,
    remat=False,
)
