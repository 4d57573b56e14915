"""qwen2-vl-2b — VLM text trunk with M-RoPE; vision frontend stubbed
[arXiv:2409.12191; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    source="arXiv:2409.12191; hf (verified)",
    n_layers=28, d_model=1536, n_heads=12, n_kv=2, d_ff=8960,
    vocab=151936, head_dim=128, act="silu",
    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
    tie_embeddings=True, norm_eps=1e-6,
    frontend="vision", n_img_tokens=256,
    strategy="fsdp_cp",              # 12 heads ∤ 16
    remat="full",
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=512,
    head_dim=32, mrope_sections=(4, 6, 6), n_img_tokens=8,
    param_dtype="float32", compute_dtype="float32", remat="none",
    loss_chunk=64,
)

register("qwen2-vl-2b", CONFIG, REDUCED)
