"""Carry loop state between the JAX package and the port.

Clustering has no weights: what crosses over is the problem and the
merge-loop state.  :func:`lwstate_from_numpy` builds the port's
:class:`~repro_torch.core.engine.LWState` from the numpy arrays of a JAX
``LWState`` (its ``(rmin, rarg)`` cache included), and
:func:`summaries_from_numpy` the matrix-free chain's
:class:`~repro_torch.core.nnchain.NNState` from a JAX chain's geometric
summaries, so both packages can resume from the same mid-run state;
:func:`to_numpy` turns the port's states and results back into numpy.
The streaming labeler's ``AssignIndex`` and the landmark tier's results
hold numpy arrays in both packages, so they need no conversion.

The LM stack has weights: :func:`lm_params_from_numpy` loads the JAX
package's parameter tree (numpy arrays, layers stacked on axis 0) into the
port's module, and :func:`lm_cache_from_numpy` a decode cache.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import LWState, resolve_device
from repro_torch.core.nnchain import NNState
from repro_torch.models import model_api, transformer
from repro_torch.models.common import spec_leaves


def lwstate_from_numpy(D, alive, sizes, merges, n_merges, cand, cache=(),
                       device=None) -> LWState:
    """The port's loop state from numpy arrays: ``D`` ``(n, n)``, ``alive``
    ``(n,)`` bool, ``sizes`` ``(n,)``, ``merges`` ``(n_steps, 4)``, the
    merge count, the candidate ``(r, c, dmin)`` and the cache: ``()``, or
    the cached variants' per-row ``(rmin, rarg)``.  The arrays are copied
    onto ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    def i64(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=dev)

    r, c, dmin = cand
    return LWState(
        D=f32(D),
        alive=torch.tensor(np.asarray(alive), dtype=torch.bool, device=dev),
        sizes=f32(sizes),
        merges=f32(merges),
        n_merges=int(n_merges),
        cand=(i64(r), i64(c), f32(dmin)),
        cache=tuple(f(a) for f, a in zip((f32, i64), cache)),
    )


def summaries_from_numpy(W, u, sizes, alive, device=None) -> NNState:
    """The matrix-free chain's state from numpy arrays: summaries ``W``
    ``(n, d)`` and ``u`` ``(n,)``, cluster ``sizes`` ``(n,)`` and ``alive``
    ``(n,)`` bool, copied onto ``device`` (CUDA unless told otherwise) as
    float32 (bool for ``alive``)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    return NNState(rep=(f32(W), f32(u)), sizes=f32(sizes),
                   alive=torch.tensor(np.asarray(alive), dtype=torch.bool, device=dev))


def lm_params_from_numpy(cfg: ModelConfig, tree: dict, device=None):
    """The family's module for ``cfg`` on ``device`` (CUDA unless told
    otherwise), its weights copied from ``tree``: the reference's parameter
    tree as numpy arrays (or anything ``np.asarray`` takes, bf16 included),
    layers stacked on axis 0, cast to ``cfg.param_dtype``."""
    dev = resolve_device(device)
    model = transformer.DenseTransformer(cfg, dev)
    for path, spec in spec_leaves(model_api.param_specs(cfg)):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        value = torch.tensor(np.asarray(leaf, np.float32))
        if tuple(value.shape) != spec.shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(value.shape)}, spec {spec.shape}")
        transformer.set_leaf(model, path, value)
    return model


def lm_cache_from_numpy(cfg: ModelConfig, cache: dict, device=None) -> dict:
    """A decode cache from the reference's (``k``, ``v``, ``kv_pos``,
    ``cur`` as numpy arrays) on ``device`` (CUDA unless told otherwise):
    ``k`` and ``v`` in ``cfg.compute_dtype``, ``kv_pos`` and ``cur`` int32."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.compute_dtype)
    out = {key: torch.tensor(np.asarray(cache[key], np.float32), dtype=dt, device=dev)
           for key in ("k", "v")}
    for key in ("kv_pos", "cur"):
        out[key] = torch.tensor(np.asarray(cache[key]), dtype=torch.int32, device=dev)
    return out


def to_numpy(value):
    """Tensors → numpy arrays, through tuples and named tuples (``LWState``,
    ``LWResult``); everything else is returned as it is."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple):
        items = [to_numpy(v) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
    return value
