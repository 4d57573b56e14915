"""zamba2-7b — Mamba2 backbone + shared attention block
[arXiv:2411.15242; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    source="arXiv:2411.15242 (unverified tier)",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336,
    vocab=32000, head_dim=112, act="silu",
    ssm_state=64, d_inner=7168, ssm_head_dim=64, conv_width=4,
    hybrid_period=6,                 # 81 = 13×(5 mamba + shared attn) + 3
    rope_theta=10_000.0, norm_eps=1e-5,
    strategy="tp",                   # attn 32 heads | 16; 112 ssm heads | 16
    remat="full",
)

REDUCED = CONFIG.replace(
    n_layers=7, d_model=64, n_heads=4, n_kv=4, d_ff=160, vocab=512,
    head_dim=16, ssm_state=16, d_inner=128, ssm_head_dim=32,
    hybrid_period=3,
    param_dtype="float32", compute_dtype="float32", remat="none",
    loss_chunk=64,
)

register("zamba2-7b", CONFIG, REDUCED)
