"""deepseek-coder-33b — dense llama-arch GQA [arXiv:2401.14196; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    source="arXiv:2401.14196; hf (verified)",
    n_layers=62, d_model=7168, n_heads=56, n_kv=8, d_ff=19200,
    vocab=32256, head_dim=128, act="silu",
    rope_theta=100_000.0, norm_eps=1e-6,
    strategy="fsdp_cp",            # 56 heads ∤ 16 → context-parallel attention
    remat="nested", microbatches=1,
    notes="llama-style trunk; CP attention because 56 % 16 != 0",
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=512,
    head_dim=16, param_dtype="float32", compute_dtype="float32",
    remat="none", loss_chunk=64,
)

register("deepseek-coder-33b", CONFIG, REDUCED)
