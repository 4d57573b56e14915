"""Sharding rules of the clustering engines' data.

Counterpart of the clustering part of :mod:`repro.distributed.sharding`:
rank ``r`` of a ring of ``p`` (:class:`repro_torch.core.distributed.Ring`)
owns rows ``[r·m/p, (r+1)·m/p)`` of an array's leading dimension (the LW
engine's ``(n, n)`` matrix rows, the points of the distance build), and
bookkeeping arrays are replicated on every rank.
"""

from __future__ import annotations

import torch


def shard_rows(arr, mesh) -> torch.Tensor:
    """This rank's block of rows of ``arr``, ``[r·m/p, (r+1)·m/p)``, on the
    ring's device (a view where ``arr`` is a tensor there already).  The
    leading dimension ``m`` must divide by the ring's size
    (:func:`repro_torch.core.distributed.pad_to_mesh` pads it)."""
    m = len(arr)
    if m % mesh.size:
        raise ValueError(f"{m} rows do not split over {mesh.size} ranks; pad them with "
                         "repro_torch.core.distributed.pad_to_mesh first")
    rows = m // mesh.size
    block = arr[mesh.rank * rows:(mesh.rank + 1) * rows]
    return torch.as_tensor(block, device=mesh.device)


def replicate(arr, mesh) -> torch.Tensor:
    """``arr`` on the ring's device: every rank holds the whole of it (the
    engines' replicated liveness, sizes and merge record)."""
    return torch.as_tensor(arr, device=mesh.device)
