"""whisper-small — enc-dec ASR backbone; conv frontend stubbed
[arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    source="arXiv:2212.04356 (unverified tier)",
    n_layers=24, n_enc_layers=12, n_dec_layers=12,
    d_model=768, n_heads=12, n_kv=12, d_ff=3072,
    vocab=51865,                      # padded to 51968 (vocab_padded)
    head_dim=64, act="gelu_nogate", use_rope=False,
    norm_type="layer", norm_eps=1e-5, max_target_len=448,
    frontend="audio",
    strategy="fsdp_cp",               # 12 heads ∤ 16
    remat="full",
)

REDUCED = CONFIG.replace(
    n_layers=4, n_enc_layers=2, n_dec_layers=2,
    d_model=64, n_heads=4, n_kv=4, d_ff=160, vocab=512,
    head_dim=16, max_target_len=32,
    param_dtype="float32", compute_dtype="float32", remat="none",
    loss_chunk=64,
)

register("whisper-small", CONFIG, REDUCED)
