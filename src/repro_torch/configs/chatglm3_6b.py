"""chatglm3-6b — dense GQA(kv=2), RoPE on half the head dims
[arXiv:2406.12793; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    source="arXiv:2406.12793; hf (verified)",
    n_layers=28, d_model=4096, n_heads=32, n_kv=2, d_ff=13696,
    vocab=65024, head_dim=128, act="silu",
    rope_theta=10_000.0, rotary_pct=0.5,   # "RoPE 2d": rotary on half dims
    norm_eps=1e-5, strategy="tp", remat="full",
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=512,
    head_dim=16, param_dtype="float32", compute_dtype="float32",
    remat="none", loss_chunk=64,
)

register("chatglm3-6b", CONFIG, REDUCED)
