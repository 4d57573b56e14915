"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    source="arXiv:2401.04088; hf (verified)",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=32000, head_dim=128, act="silu",
    n_experts=8, top_k=2, capacity_factor=1.25,
    window=4096,                     # SWA → rolling KV ring buffer
    rope_theta=1_000_000.0, norm_eps=1e-5,
    strategy="tp", remat="full",
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=512,
    head_dim=16, n_experts=4, top_k=2, window=16,
    param_dtype="float32", compute_dtype="float32", remat="none",
    loss_chunk=64,
)

register("mixtral-8x7b", CONFIG, REDUCED)
