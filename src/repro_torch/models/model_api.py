"""Unified model API: family dispatch for specs / apply / cache / init.

The port of the JAX package's ``repro/models/model_api.py``.  Every
architecture exposes the same entry points regardless of family:

* ``param_specs(cfg)``            — ParamSpec tree (layers stacked)
* ``apply(cfg, params, batch, mode, cache)`` — mode ∈ train|prefill|decode
* ``cache_specs(cfg, batch, seq)`` — decode-cache shapes and dtypes
* ``init_cache(cfg, batch, seq)`` / ``init_params(cfg, generator)``

The dense family runs; ``moe``, ``rwkv``, ``hybrid``, ``encdec`` and
``vlm`` raise ``NotImplementedError`` until A9.3, and ``loss`` waits for
training (A9.2).  ``params`` is the family's module
(:class:`~repro_torch.models.transformer.DenseTransformer`).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import init_leaf, spec_leaves

#: Families the reference runs and the port does not yet.
LATER_FAMILIES = ("moe", "rwkv", "hybrid", "encdec", "vlm")


def _dense(cfg: ModelConfig) -> None:
    if cfg.family in LATER_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (A9.3); "
            "the port runs the dense family")
    if cfg.family != "dense":
        raise ValueError(f"unknown family {cfg.family!r}")


def param_specs(cfg: ModelConfig) -> dict:
    _dense(cfg)
    return transformer.dense_specs(cfg)


def apply(cfg: ModelConfig, params, batch: dict, mode: str, cache: dict | None = None):
    _dense(cfg)
    return transformer.dense_apply(cfg, params, batch, mode, cache)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    _dense(cfg)
    return transformer.init_cache_specs(cfg, batch, seq_len)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None) -> dict:
    """Zero-initialized cache on ``device``, CUDA unless told otherwise
    (kv_pos slots marked −1 = unwritten)."""
    dev = resolve_device(device)
    specs = cache_specs(cfg, batch, seq_len)
    cache = {k: torch.zeros(s.shape, dtype=s.dtype, device=dev) for k, s in specs.items()}
    cache["kv_pos"].fill_(-1)
    return cache


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """The family's module on the generator's device, leaf ``i`` of the
    spec tree drawn from a stream of its own
    (:func:`~repro_torch.models.common.init_leaf`), one leaf at a time: the
    peak is the model and one stacked leaf in float32."""
    specs = param_specs(cfg)
    model = transformer.DenseTransformer(cfg, generator.device)
    for i, (path, spec) in enumerate(spec_leaves(specs)):
        transformer.set_leaf(model, path,
                             init_leaf(spec, generator, i, getattr(torch, cfg.param_dtype)))
    return model
