"""Token embedding / unembedding.

The port of the JAX package's ``repro/models/embedding.py`` for serving:
``embedding_specs``, ``embed``, ``final_norm`` and ``logits_fn``.  The
chunked cross-entropy loss belongs to training and is not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, layer_norm, rms_norm, upcast


def embedding_specs(cfg: ModelConfig) -> dict:
    V, d = cfg.vocab_padded, cfg.d_model
    specs = {
        "embedding": ParamSpec((V, d), ("p_vocab", "p_embed"), "embed"),
        "final_norm": ParamSpec((d,), ("p_none",),
                                "zeros" if cfg.norm_type == "rms" else "ones"),
    }
    if cfg.norm_type == "layer":
        specs["final_norm_bias"] = ParamSpec((d,), ("p_none",), "zeros")
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, V), ("p_embed", "p_vocab"), "scaled")
    return specs


def embed(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embedding"][tokens]
    x = x.to(getattr(torch, cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def final_norm(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layer":
        return layer_norm(x, params["final_norm"], params["final_norm_bias"], cfg.norm_eps)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_fn(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    """hidden (..., d) → logits (..., V) in float32, as the reference's
    ``preferred_element_type`` asks.

    The unembedding stays in its storage dtype.  On a CUDA device a bf16
    (or fp16) pair takes one GEMM with a float32 output,
    ``torch.mm(..., out_dtype=torch.float32)``: float32 accumulation, no
    float32 copy of the weight (for gemma3-1b's 262144 × 1152 table that
    copy would be 1.2 GB a decode step).  The CPU has no such GEMM, so there
    low-precision operands are cast to float32 first; float32 (and float64)
    operands multiply as they are on either device."""
    w = params["embedding"].T if cfg.tie_embeddings else params["lm_head"]
    lead, d = hidden.shape[:-1], hidden.shape[-1]
    low = (hidden.dtype, w.dtype) in ((torch.bfloat16, torch.bfloat16),
                                      (torch.float16, torch.float16))
    if low and hidden.device.type == "cuda":
        out = torch.mm(hidden.reshape(-1, d), w, out_dtype=torch.float32)
    else:
        out = upcast(hidden.reshape(-1, d)) @ upcast(w)
    return out.reshape(*lead, w.shape[-1])
