"""gemma3-1b — 5:1 local:global attention, 256k vocab, head_dim 256
[hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    source="hf:google/gemma-3-1b-pt (unverified tier)",
    n_layers=26, d_model=1152, n_heads=4, n_kv=1, d_ff=6912,
    vocab=262144, head_dim=256, act="gelu",
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    window=512, local_global_period=6,     # 5 local : 1 global
    qk_norm=True, sandwich_norm=True, embed_scale=True,
    tie_embeddings=True, norm_eps=1e-6,
    strategy="fsdp_cp",              # 4 heads ∤ 16
    remat="full",
)

REDUCED = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv=1, d_ff=160, vocab=512,
    head_dim=16, window=8, local_global_period=3,
    param_dtype="float32", compute_dtype="float32", remat="none",
    loss_chunk=64,
)

register("gemma3-1b", CONFIG, REDUCED)
