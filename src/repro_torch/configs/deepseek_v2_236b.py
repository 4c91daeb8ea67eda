"""DeepSeek-V2-236B [moe]: MLA (kv_lora=512), 2 shared + 160 routed top-6
[arXiv:2405.04434].  First layer dense (d_ff 12288), remaining 59 MoE.
`router="lp"` switches token->expert assignment to the paper's regularized
matching solver (see repro_torch.models.moe.lp_route).
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=192,  # qk_nope 128 + qk_rope 64
    d_ff=1536,
    vocab_size=102400,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(num_experts=160, top_k=6, expert_ff=1536, num_shared=2),
    n_dense_layers=1,
    dense_ff=12288,
)

REDUCED = ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=48,
    d_ff=64,
    vocab_size=512,
    mla=MLAConfig(
        kv_lora_rank=32,
        q_lora_rank=48,
        qk_nope_head_dim=32,
        qk_rope_head_dim=16,
        v_head_dim=32,
    ),
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=64, num_shared=2),
    n_dense_layers=1,
    dense_ff=128,
    remat=False,
)
