"""Kimi-K2-1T-A32B [moe]: trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2, paper-table].  Assigned-table attention: 64H GQA kv=8.
First layer dense; 1 shared expert.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    moe=MoEConfig(num_experts=384, top_k=8, expert_ff=2048, num_shared=1),
    n_dense_layers=1,
    dense_ff=18432,
)

REDUCED = ModelConfig(
    name="kimi-k2-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=64, num_shared=1),
    n_dense_layers=1,
    dense_ff=128,
    remat=False,
)
