"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    source="arXiv:2407.21783 (unverified tier)",
    n_layers=126, d_model=16384, n_heads=128, n_kv=8, d_ff=53248,
    vocab=128256, head_dim=128, act="silu",
    rope_theta=500_000.0, norm_eps=1e-5,
    strategy="tp",                  # 128 heads | 16
    remat="nested", microbatches=4, # memory stress case
    opt_state_dtype="int8",         # 8-bit m/v for the ≥300b archs
)

REDUCED = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=8, n_kv=2, d_ff=192, vocab=512,
    head_dim=8, param_dtype="float32", compute_dtype="float32",
    remat="none", microbatches=1, opt_state_dtype="float32", loss_chunk=64,
)

register("llama3-405b", CONFIG, REDUCED)
