"""Model configuration schema + registry for the assigned architectures.

A copy of the JAX package's ``repro/configs/base.py``, field for field:
the same defaults, derived sizes and parameter counts, and a registry the
port's own config modules fill (``_ensure_loaded`` imports them)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------------
    name: str
    family: str                    # dense | moe | ssm | rwkv | hybrid | encdec | vlm
    source: str = ""               # provenance tag from the assignment pool
    # trunk ------------------------------------------------------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: int = 0              # 0 → d_model // n_heads
    act: str = "silu"
    norm_eps: float = 1e-5
    norm_type: str = "rms"         # rms | layer
    tie_embeddings: bool = False
    sandwich_norm: bool = False    # gemma3 pre+post block norms
    # rope --------------------------------------------------------------------
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0     # gemma3 global layers use 1e6
    rotary_pct: float = 1.0            # chatglm applies RoPE to half the head
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w)
    use_rope: bool = True
    # attention extras ---------------------------------------------------------
    window: int = 0                # sliding window (0 = full attention)
    local_global_period: int = 0   # gemma3: every k-th layer is global
    attn_softcap: float = 0.0
    qk_norm: bool = False
    embed_scale: bool = False      # gemma: embeddings scaled by sqrt(d)
    # MoE ----------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0               # 0 → d_ff
    capacity_factor: float = 1.25
    moe_variant: str = "ep"        # ep (expert-parallel a2a) | gather (§Perf-2)
    # SSM / RWKV ----------------------------------------------------------------
    ssm_state: int = 0
    d_inner: int = 0               # 0 → 2 * d_model
    conv_width: int = 4
    ssm_head_dim: int = 64
    rwkv_head_dim: int = 64
    # hybrid (zamba2) ------------------------------------------------------------
    hybrid_period: int = 0         # every k-th layer = the shared attn block
    # enc-dec (whisper) ------------------------------------------------------------
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    max_target_len: int = 448
    # modality frontend (stubbed per assignment) -----------------------------------
    frontend: str = "none"         # none | audio | vision
    n_img_tokens: int = 0
    # numerics / memory --------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"            # none | full | nested
    scan_layers: bool = True
    microbatches: int = 1
    loss_chunk: int = 512          # tokens per chunked-CE block
    opt_state_dtype: str = "float32"   # float32 | bfloat16 | int8
    # sharding -----------------------------------------------------------------------
    strategy: str = "tp"           # tp | fsdp_cp (see DESIGN.md §6)
    layer_gather: bool = True      # §Perf-1: per-layer FSDP gather in-body
    # bookkeeping ----------------------------------------------------------------------
    notes: str = ""

    # ---- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def moe_dff_(self) -> int:
        return self.moe_dff or self.d_ff

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so TP over 16 (and lanes) always divides."""
        return self.vocab + ((-self.vocab) % 256)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (used for 6·N·D roofline sanity)."""
        d, hd = self.d_model, self.head_dim_
        attn = d * (self.n_heads + 2 * self.n_kv) * hd + self.n_heads * hd * d
        gated = 3 if self.act in ("silu", "gelu") else 2
        mlp = gated * d * self.d_ff
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        if self.family == "moe":
            mlp = self.n_experts * gated * d * self.moe_dff_
            per_layer = attn + mlp
            return self.n_layers * per_layer + emb
        if self.family == "rwkv":
            tmix = 6 * d * d + 6 * d  # r,k,v,g,o,w projections (+ mixes)
            cmix = 2 * d * self.d_ff
            return self.n_layers * (tmix + cmix) + emb
        if self.family == "ssm":
            din = self.d_inner_
            mix = d * din * 2 + din * d + din * self.conv_width
            return self.n_layers * (mix + mlp) + emb
        if self.family == "hybrid":
            din = self.d_inner_
            n_attn = self.n_layers // max(self.hybrid_period, 1)
            n_mamba = self.n_layers - n_attn
            mamba = d * din * 2 + din * d + din * self.conv_width
            return n_mamba * mamba + 1 * (attn + mlp) + emb  # attn block shared
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp)
            dec = self.n_dec_layers * (2 * attn + mlp)
            return enc + dec + emb
        return self.n_layers * (attn + mlp) + emb

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.head_dim_
        attn = d * (self.n_heads + 2 * self.n_kv) * hd + self.n_heads * hd * d
        gated = 3 if self.act in ("silu", "gelu") else 2
        mlp_active = self.top_k * gated * d * self.moe_dff_
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + mlp_active) + emb


_REGISTRY: dict[str, "ArchEntry"] = {}


@dataclass
class ArchEntry:
    config: ModelConfig
    reduced: ModelConfig


def register(arch_id: str, config: ModelConfig, reduced: ModelConfig) -> None:
    _REGISTRY[arch_id] = ArchEntry(config=config, reduced=reduced)


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    e = _REGISTRY[arch_id]
    return e.reduced if reduced else e.config


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import importlib

    for mod in (
        "deepseek_coder_33b",
        "chatglm3_6b",
        "llama3_405b",
        "gemma3_1b",
        "zamba2_7b",
        "mixtral_8x7b",
        "grok1_314b",
        "rwkv6_3b",
        "qwen2_vl_2b",
        "whisper_small",
        "paper_lw",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")
