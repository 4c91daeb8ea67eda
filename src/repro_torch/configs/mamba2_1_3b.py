"""Mamba2-1.3B [ssm]: SSD (state-space duality), attention-free
[arXiv:2405.21060].  48L d_model=2048, ssm_state=128, vocab=50280.
Sub-quadratic: runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,  # attention-free; SSD heads come from SSMConfig
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    head_dim=1,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1, conv_width=4),
    subquadratic=True,
)

REDUCED = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=512,
    head_dim=1,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, n_groups=1, conv_width=4, chunk=32),
    subquadratic=True,
    remat=False,
)
