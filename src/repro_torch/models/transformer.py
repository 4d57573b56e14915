"""Dense decoder-only transformer trunk.

The port of the JAX package's ``repro/models/transformer.py`` for the
dense family — deepseek-coder-33b, chatglm3-6b (partial rotary),
llama3-405b, gemma3-1b (5:1 local:global, per-layer RoPE theta, sandwich
norms) — in ``train``, ``prefill`` and ``decode`` modes.  The weights live
in :class:`DenseTransformer`, an ``nn.Module`` with a ``ModuleList`` of
:class:`DenseBlock`\\ s; every parameter keeps the reference's name and
shape (``wq`` (d, h, hd), ``wo`` (h, hd, d), …), so the reference's tree,
whose layers are stacked on axis 0, carries across a layer at a time
(:func:`set_leaf`).  The qwen2-vl trunk (M-RoPE, the vision stub) and the
MoE MLP wait for the other families.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import embedding as emb
from repro_torch.models.attention import (
    attention_specs,
    decode_attention,
    multihead_attention,
    project_out,
    project_qkv,
)
from repro_torch.models.common import (
    ParamSpec,
    TensorSpec,
    apply_rope,
    layer_norm,
    mlp_apply,
    mlp_specs,
    rms_norm,
    rope_cos_sin,
)
from repro_torch.models.stack import scan_blocks, stack_specs


def _norm(cfg: ModelConfig, params, name: str, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type == "layer":
        return layer_norm(x, params[name], params[f"{name}_bias"], cfg.norm_eps)
    return rms_norm(x, params[name], cfg.norm_eps)


def _norm_specs(cfg: ModelConfig, *names: str) -> dict:
    d = cfg.d_model
    specs: dict = {}
    for n in names:
        if cfg.norm_type == "layer":
            specs[n] = ParamSpec((d,), ("p_none",), "ones")
            specs[f"{n}_bias"] = ParamSpec((d,), ("p_none",), "zeros")
        else:
            specs[n] = ParamSpec((d,), ("p_none",), "zeros")
    return specs


# ---------------------------------------------------------------------------
# one decoder layer
# ---------------------------------------------------------------------------


def dense_layer_specs(cfg: ModelConfig) -> dict:
    specs = {
        **attention_specs(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim_,
                          qk_norm=cfg.qk_norm),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.act),
        **_norm_specs(cfg, "attn_norm", "mlp_norm"),
    }
    if cfg.sandwich_norm:
        specs.update(_norm_specs(cfg, "post_attn_norm", "post_mlp_norm"))
    return specs


def _layer_rope(cfg: ModelConfig, positions, theta, precomputed):
    """cos/sin for this layer — precomputed unless theta is per-layer."""
    if precomputed is not None:
        return precomputed
    rotary_dim = int(cfg.head_dim_ * cfg.rotary_pct)
    return rope_cos_sin(positions, rotary_dim, theta)


def dense_block(cfg: ModelConfig, lp, x: torch.Tensor, *, positions: torch.Tensor, theta,
                window, cos_sin, mode: str, cache_kv=None,
                kv_pos=None) -> tuple[torch.Tensor, Any]:
    """One pre-norm attention + MLP block.  Returns (x, ys): the layer's
    (k, v) in prefill and decode, None in train."""
    rotary_dim = int(cfg.head_dim_ * cfg.rotary_pct)
    h = _norm(cfg, lp, "attn_norm", x)
    q, k, v = project_qkv(lp, h, cfg.norm_eps)
    if cfg.use_rope:
        cos, sin = _layer_rope(cfg, positions, theta, cos_sin)
        q = apply_rope(q, cos, sin, rotary_dim)
        k = apply_rope(k, cos, sin, rotary_dim)

    if mode == "decode":
        ck, cv = cache_kv
        attn = decode_attention(q, ck, cv, positions, kv_pos, window=window,
                                softcap=cfg.attn_softcap, self_kv=(k, v))
        ys = (k, v)
    else:
        attn = multihead_attention(q, k, v, positions, positions, causal=True, window=window,
                                   softcap=cfg.attn_softcap)
        ys = (k, v) if mode == "prefill" else None

    a = project_out(lp, attn)
    if cfg.sandwich_norm:
        a = _norm(cfg, lp, "post_attn_norm", a)
    x = x + a

    h2 = _norm(cfg, lp, "mlp_norm", x)
    m = mlp_apply(lp["mlp"], h2, cfg.act)
    if cfg.sandwich_norm:
        m = _norm(cfg, lp, "post_mlp_norm", m)
    return x + m, ys


# ---------------------------------------------------------------------------
# per-layer static metadata (gemma3 local/global pattern)
# ---------------------------------------------------------------------------


def layer_meta(cfg: ModelConfig, n_layers: int) -> tuple[np.ndarray, np.ndarray]:
    """(theta, window) arrays of shape (L,): float32 and int32."""
    theta = np.full(n_layers, cfg.rope_theta, np.float32)
    window = np.zeros(n_layers, np.int32)         # 0 → full attention
    if cfg.window and not cfg.local_global_period:
        window[:] = cfg.window                    # uniform SWA (mixtral)
    if cfg.local_global_period:
        for layer in range(n_layers):
            is_global = (layer + 1) % cfg.local_global_period == 0
            window[layer] = 0 if is_global else cfg.window
            if cfg.rope_theta_global and is_global:
                theta[layer] = cfg.rope_theta_global
    return theta, window


def _per_layer_rope(cfg: ModelConfig) -> bool:
    return bool(cfg.rope_theta_global and cfg.local_global_period)


def _window_arg(cfg: ModelConfig, w):
    """None (no window math) when the arch never uses windows."""
    return w if (cfg.window or cfg.local_global_period) else None


# ---------------------------------------------------------------------------
# the trunk's parameters as modules
# ---------------------------------------------------------------------------


def _parameter(spec: ParamSpec, dtype, device) -> nn.Parameter:
    # serving needs no gradients; training turns them on
    return nn.Parameter(torch.empty(spec.shape, dtype=spec.dtype or dtype, device=device),
                        requires_grad=False)


class DenseBlock(nn.Module):
    """One decoder layer's parameters, by the reference's names (the MLP's
    under ``mlp``), uninitialized until loaded."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        for name, spec in dense_layer_specs(cfg).items():
            if name == "mlp":
                self.mlp = nn.ParameterDict({k: _parameter(s, dtype, device)
                                             for k, s in spec.items()})
            else:
                self.register_parameter(name, _parameter(spec, dtype, device))

    def tree(self) -> dict:
        """The reference's per-layer parameter tree: name → tensor, and
        ``"mlp"`` → the MLP's."""
        return dict(self.named_parameters(recurse=False), mlp=self.mlp)

    def forward(self, x: torch.Tensor, **kw) -> tuple[torch.Tensor, Any]:
        return dense_block(self.cfg, self.tree(), x, **kw)


class DenseTransformer(nn.Module):
    """The dense trunk's parameters: the embedding, the final norm and the
    untied head at the top, ``blocks`` below.  ``forward`` is
    :func:`dense_apply`."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        for name, spec in emb.embedding_specs(cfg).items():
            self.register_parameter(name, _parameter(spec, dtype, device))
        self.blocks = nn.ModuleList(DenseBlock(cfg, device) for _ in range(cfg.n_layers))

    def tree(self) -> dict:
        """The top of the reference's parameter tree, without ``layers``."""
        return dict(self.named_parameters(recurse=False))

    def forward(self, batch: dict, mode: str, cache: dict | None = None):
        return dense_apply(self.cfg, self, batch, mode, cache)


@torch.no_grad()
def set_leaf(model: DenseTransformer, path: tuple, value: torch.Tensor) -> None:
    """Copy one leaf of the reference's parameter tree into ``model``: a
    top-level leaf as it is, a ``("layers", ...)`` leaf (stacked on axis
    0) one layer a block."""
    if path[0] != "layers":
        (name,) = path
        getattr(model, name).copy_(value)
        return
    for layer, block in enumerate(model.blocks):
        target = block.mlp[path[2]] if path[1] == "mlp" else getattr(block, path[1])
        target.copy_(value[layer])


# ---------------------------------------------------------------------------
# full trunk
# ---------------------------------------------------------------------------


def dense_specs(cfg: ModelConfig) -> dict:
    return {
        **emb.embedding_specs(cfg),
        "layers": stack_specs(dense_layer_specs(cfg), cfg.n_layers),
    }


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Rolling ring buffer iff *every* layer is windowed (mixtral SWA)."""
    if cfg.window and not cfg.local_global_period:
        return min(seq_len, cfg.window)
    return seq_len


def init_cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Shapes and dtypes of the decode cache."""
    S = cache_len(cfg, seq_len)
    L, n, hd = cfg.n_layers, cfg.n_kv, cfg.head_dim_
    dt = getattr(torch, cfg.compute_dtype)
    return {
        "k": TensorSpec((L, batch, S, n, hd), dt),
        "v": TensorSpec((L, batch, S, n, hd), dt),
        "kv_pos": TensorSpec((batch, S), torch.int32),
        "cur": TensorSpec((), torch.int32),
    }


def dense_apply(cfg: ModelConfig, params: DenseTransformer, batch: dict, mode: str,
                cache: dict | None = None):
    """Run the trunk.

    train   → hidden states (b, s, d) after final norm
    prefill → (last-position logits (b, V) float32, fresh cache of s slots)
    decode  → (logits (b, V) float32, the cache advanced one token: ``k``,
              ``v`` and ``kv_pos`` written in place at slot ``cur % S``,
              as the reference's donated cache; ``cur`` a new tensor)

    ``cache["cur"]`` is a 0-d int32 tensor on the model's device, so the
    decode loop reads nothing back.
    """
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family waits for A9.3")
    tokens = batch["tokens"]
    b, s = tokens.shape
    top = params.tree()
    x = emb.embed(cfg, top, tokens)

    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one token a sequence, got {s}")
        positions = cache["cur"].to(torch.int32).expand(b, s)
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)

    # rope tables (precomputed unless per-layer theta)
    cos_sin = None
    if cfg.use_rope and not _per_layer_rope(cfg):
        cos_sin = rope_cos_sin(positions, int(cfg.head_dim_ * cfg.rotary_pct), cfg.rope_theta)

    theta_l, window_l = layer_meta(cfg, cfg.n_layers)

    def body(x, xs):
        if mode == "decode":
            block, th, w, ck, cv = xs
            cache_kv, kv_pos = (ck, cv), cache["kv_pos"]
        else:
            block, th, w = xs
            cache_kv, kv_pos = None, None
        return block(x, positions=positions, theta=float(th), window=_window_arg(cfg, int(w)),
                     cos_sin=cos_sin, mode=mode, cache_kv=cache_kv, kv_pos=kv_pos)

    xs: tuple = (params.blocks, theta_l, window_l)
    if mode == "decode":
        xs = xs + (cache["k"], cache["v"])
    x, ys = scan_blocks(body, x, zip(*xs))
    x = emb.final_norm(cfg, top, x)

    if mode == "train":
        return x

    dt = getattr(torch, cfg.compute_dtype)
    k_all = torch.stack([y[0] for y in ys]).to(dt)   # (L, b, s, n, hd)
    v_all = torch.stack([y[1] for y in ys]).to(dt)
    if mode == "prefill":
        S = cache_len(cfg, s)
        if S != s:                               # rolling ring: last S tokens
            slots = torch.arange(S, device=tokens.device)
            pos_of_slot = s - S + torch.remainder(slots - s, S)
            k_all = k_all.index_select(2, pos_of_slot)
            v_all = v_all.index_select(2, pos_of_slot)
            kv_pos = pos_of_slot.to(torch.int32).expand(b, S).contiguous()
        else:
            kv_pos = positions.contiguous()
        new_cache = {"k": k_all, "v": v_all, "kv_pos": kv_pos,
                     "cur": torch.full((), s, dtype=torch.int32, device=tokens.device)}
        return emb.logits_fn(cfg, top, x[:, -1]), new_cache

    # decode: write the new kv into the ring once, outside the layer loop
    cur = cache["cur"]
    S = cache["k"].shape[2]
    write_idx = torch.remainder(cur, S).to(torch.int64).reshape(1)
    cache["k"].index_copy_(2, write_idx, k_all.to(cache["k"].dtype))
    cache["v"].index_copy_(2, write_idx, v_all.to(cache["v"].dtype))
    cache["kv_pos"].index_copy_(1, write_idx, positions[:, :1])
    new_cache = dict(cache, cur=cur + 1)
    return emb.logits_fn(cfg, top, x[:, -1]), new_cache
