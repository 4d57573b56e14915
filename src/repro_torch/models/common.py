"""Shared model building blocks: parameter specs, norms, rotary embeddings,
activations and MLPs.

The port of the JAX package's ``repro/models/common.py``, op for op.  The
logical-axis constraints of the reference are no-ops without a mesh and the
port runs its models on one device, so none is applied here; the specs keep
their axes for the sharded slice.  ``cast_cotangent_bf16`` belongs to
training and is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# parameter specs / init
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape + logical axes + initializer."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | scaled | embed
    scale: float | None = None    # stddev override / fan-in scale
    dtype: Any = None             # None → model param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


@dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, allocating nothing (the counterpart of
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_leaves(spec_tree, prefix: tuple = ()) -> list[tuple[tuple, ParamSpec]]:
    """``(path, spec)`` of every leaf of a nested dict of specs, depth
    first with keys sorted, the order ``jax.tree.flatten`` gives a dict."""
    if is_spec(spec_tree):
        return [(prefix, spec_tree)]
    out = []
    for key in sorted(spec_tree):
        out.extend(spec_leaves(spec_tree[key], prefix + (key,)))
    return out


def _leaf_seed(seed: int, i: int) -> int:
    """The seed of leaf ``i``'s own stream (splitmix64 of the pair), so that
    a leaf's values depend on the generator's seed and its index alone."""
    z = (seed * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) % 2**64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2**64
    return (z ^ (z >> 31)) % 2**63


def init_leaf(spec: ParamSpec, generator: torch.Generator, i: int,
              param_dtype=torch.float32) -> torch.Tensor:
    """Leaf ``i`` of a spec tree, drawn on the generator's device from a
    stream of its own (the reference folds ``i`` into its key).  Normal
    draws are made in float32 and cast, as the reference does."""
    dt = spec.dtype or param_dtype
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=dev)
    if spec.init == "scaled":  # fan-in scaled (1/sqrt(fan_in))
        fan_in = max(1, spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[0])
        std = (spec.scale or 1.0) / math.sqrt(fan_in)
    else:                      # normal | embed
        std = spec.scale or 0.02
    g = torch.Generator(device=dev).manual_seed(_leaf_seed(generator.initial_seed(), i))
    x = torch.randn(spec.shape, generator=g, dtype=torch.float32, device=dev)
    return x.mul_(std).to(dt)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, the reference's upcast, unless it is wider: a
    float64 model computes in float64 throughout, which is how a float32
    gap between two paths is told from a fault in one of them."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 scaled by ``1 + w`` (the reference's, not
    ``nn.RMSNorm``'s ``w``), cast back to ``x``'s dtype."""
    dt = x.dtype
    x = upcast(x)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + upcast(w))).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = upcast(x)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * upcast(w) + upcast(b)).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # the reference's jax.nn.gelu(approximate=True); torch's default is exact
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "gelu_nogate": _gelu_tanh,  # plain MLP
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# rotary position embeddings (1d / partial / M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(rotary_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (rotary_dim // 2,), float32 (gemma3
    selects theta 10k vs 1M per layer).  ``theta`` enters the float32
    power as a Python scalar: no host-to-device copy, which on a CUDA
    stream would wait for the work queued before it."""
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=device) / rotary_dim
    return 1.0 / torch.pow(float(theta), exponent)


def rope_cos_sin(positions: torch.Tensor, rotary_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (b, s) → cos/sin (b, s, rotary_dim // 2)."""
    inv = rope_freqs(rotary_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions_3d: torch.Tensor, rotary_dim: int, theta: float,
                  sections: tuple[int, int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL M-RoPE: positions (3, b, s); frequency slots are split into
    (temporal, height, width) sections, each driven by its own position
    stream.  Returns cos/sin (b, s, rotary_dim // 2)."""
    if sum(sections) != rotary_dim // 2:
        raise ValueError(f"sections {sections} do not fill rotary_dim {rotary_dim} // 2")
    dev = positions_3d.device
    inv = rope_freqs(rotary_dim, theta, dev)                               # (hd/2,)
    sel = torch.repeat_interleave(torch.arange(3, device=dev),
                                  torch.as_tensor(sections, device=dev))   # (hd/2,) in {0,1,2}
    pos_sel = positions_3d.float()[sel]                                    # (hd/2, b, s)
    ang = torch.movedim(pos_sel, 0, -1) * inv                              # (b, s, hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: int) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` dims of ``x`` (b, s, h, hd), NeoX
    style, in float32; the rest stays as it is, in ``x``'s dtype."""
    dt = x.dtype
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    x1, x2 = upcast(rot[..., :half]), upcast(rot[..., half:])
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_specs(d_model: int, d_ff: int, act: str = "silu") -> dict:
    gated = act in ("silu", "gelu")
    specs = {
        "w_up": ParamSpec((d_model, d_ff), ("p_embed", "p_mlp"), "scaled"),
        "w_down": ParamSpec((d_ff, d_model), ("p_mlp", "p_embed"), "scaled"),
    }
    if gated:
        specs["w_gate"] = ParamSpec((d_model, d_ff), ("p_embed", "p_mlp"), "scaled")
    return specs


def mlp_apply(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """(b, s, d) → (b, s, d): ``act(x @ w_gate) * (x @ w_up)``, then
    ``@ w_down`` (ungated: ``act(x @ w_up) @ w_down``)."""
    fn = ACTIVATIONS[act]
    h = x @ params["w_up"]
    if "w_gate" in params:
        h = fn(x @ params["w_gate"]) * h
    else:
        h = fn(h)
    return h @ params["w_down"]
