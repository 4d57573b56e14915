"""Carry loop state between the JAX package and the port.

Clustering has no weights: what crosses over is the problem and the
merge-loop state.  :func:`lwstate_from_numpy` builds the port's
:class:`~repro_torch.core.engine.LWState` from the numpy arrays of a JAX
``LWState``, so both engines can resume from the same mid-run state;
:func:`to_numpy` turns the port's states and results back into numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import LWState, resolve_device


def lwstate_from_numpy(D, alive, sizes, merges, n_merges, cand, device=None) -> LWState:
    """The port's loop state from numpy arrays: ``D`` ``(n, n)``, ``alive``
    ``(n,)`` bool, ``sizes`` ``(n,)``, ``merges`` ``(n_steps, 4)``, the
    merge count and the candidate ``(r, c, dmin)``.  The arrays are copied
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
        cache=(),
    )


def to_numpy(value):
    """Tensors → numpy arrays, through tuples and named tuples (``LWState``,
    ``LWResult``); everything else is returned as it is."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple):
        items = [to_numpy(v) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
    return value
