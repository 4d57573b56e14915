"""Step builders for serving: ``make_prefill_step`` and ``make_decode_step``.

The port of the JAX package's ``repro/launch/steps.py`` without a mesh
(the builders take none): each returns a plain function over the model's
module that runs without autograd.  The sharded steps (parameter, batch
and cache shardings from the logical-axis rules) and the train step wait
for the training slice (A9.2).

The prefill step honours ``seq_len``: it returns a cache of
``cache_len(cfg, seq_len)`` slots, the prompt's K/V in the first ``s`` and
``kv_pos`` −1 beyond them, so that decode writes each new token into a slot
of its own.  (The reference's step uses ``seq_len`` only for its shardings
and returns the prompt-length cache of ``model_api.apply(..., "prefill")``,
whose decode overwrites the prompt's first slot from the second new token
on.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_api
from repro_torch.models.transformer import cache_len


def pad_cache(cfg: ModelConfig, cache: dict, seq_len: int) -> dict:
    """``cache`` widened to ``cache_len(cfg, seq_len)`` slots: its slots
    first, then zero K/V at position −1."""
    s = cache["k"].shape[2]
    S = cache_len(cfg, seq_len)
    if S < s:
        raise ValueError(f"seq_len {seq_len} holds {S} cache slots, fewer than the {s} filled")
    if S == s:
        return cache
    out = {key: F.pad(cache[key], (0, 0, 0, 0, 0, S - s)) for key in ("k", "v")}
    out["kv_pos"] = F.pad(cache["kv_pos"], (0, S - s), value=-1)
    out["cur"] = cache["cur"]
    return out


def make_prefill_step(cfg: ModelConfig, *, seq_len: int):
    """``step(params, batch) -> (last-position logits (b, V), cache)`` with a
    cache of ``cache_len(cfg, seq_len)`` slots."""

    @torch.no_grad()
    def step(params, batch: dict):
        logits, cache = model_api.apply(cfg, params, batch, "prefill")
        return logits, pad_cache(cfg, cache, seq_len)

    return step


def make_decode_step(cfg: ModelConfig):
    """``step(params, cache, batch) -> (logits (b, V), cache)``: one token a
    sequence, the cache's K/V and positions written in place."""

    @torch.no_grad()
    def step(params, cache: dict, batch: dict):
        return model_api.apply(cfg, params, batch, "decode", cache)

    return step
