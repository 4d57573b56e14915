"""grok-1-314b — 8-expert top-2 MoE, attention logit softcap
[hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    source="hf:xai-org/grok-1 (unverified tier)",
    n_layers=64, d_model=6144, n_heads=48, n_kv=8, d_ff=32768,
    vocab=131072, head_dim=128, act="gelu",
    n_experts=8, top_k=2, capacity_factor=1.25,
    attn_softcap=30.0,
    rope_theta=10_000.0, norm_eps=1e-5,
    strategy="tp",                   # 48 heads | 16
    remat="nested", microbatches=4, opt_state_dtype="int8",
)

REDUCED = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=192, vocab=512,
    head_dim=16, n_experts=4, top_k=2,
    param_dtype="float32", compute_dtype="float32",
    remat="none", microbatches=1, opt_state_dtype="float32", loss_chunk=64,
)

register("grok-1-314b", CONFIG, REDUCED)
