"""rwkv6-3b "Finch" — attention-free, data-dependent decay
[arXiv:2404.05892; hf]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv",
    source="arXiv:2404.05892; hf (verified)",
    n_layers=32, d_model=2560, n_heads=0, n_kv=0, d_ff=8960,
    vocab=65536, act="relu", use_rope=False,
    rwkv_head_dim=64, norm_type="layer", norm_eps=1e-5,
    strategy="tp", remat="full",
    notes="O(1) state → runs long_500k",
)

REDUCED = CONFIG.replace(
    n_layers=3, d_model=64, d_ff=160, vocab=512, rwkv_head_dim=16,
    param_dtype="float32", compute_dtype="float32", remat="none",
    loss_chunk=64,
)

register("rwkv6-3b", CONFIG, REDUCED)
