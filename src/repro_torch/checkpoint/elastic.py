"""Elastic re-sharding: check that a smaller ring can hold a sharded state,
then move the state's rows onto it.

Counterpart of :mod:`repro.checkpoint.elastic` for what the sharded
matrix-free chain's elastic shrink needs.  :func:`validate_mesh_for_tree`
reports every leaf whose sharded dimension does not divide on the target
ring, naming the leaf, its logical axis and the ring's axis, so
that a shrink fails before any state moves; :func:`reshard_rows` moves a
row-sharded tensor from one ring to another.  The reference's
``restore_elastic`` restores a checkpoint onto a new mesh and waits for the
checkpoint manager (ROADMAP.md A9).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import shard_rows

#: The one axis of the paper's processor ring, as the JAX package names it.
RING_AXIS = "p"


@dataclass(frozen=True)
class ParamSpec:
    """A leaf of a sharded state: its shape and one logical axis name (or
    ``None``, replicated) a dimension."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _leaves_with_paths(tree, path: str = ""):
    """``(path, spec)`` for every :class:`ParamSpec` in ``tree`` (dicts by
    sorted key, named tuples by field, sequences by index), the path
    written as ``jax.tree_util.keystr`` writes it; ``None`` holds no leaf."""
    if tree is None:
        return
    if hasattr(tree, "axes"):
        yield path, tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_paths(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, sub in zip(tree._fields, tree):
            yield from _leaves_with_paths(sub, f"{path}.{name}")
    else:
        for k, sub in enumerate(tree):
            yield from _leaves_with_paths(sub, f"{path}[{k}]")


def validate_mesh_for_tree(spec_tree, rules, ring) -> list[str]:
    """The leaves of ``spec_tree`` whose sharded dimensions do not divide on
    ``ring`` (:class:`repro_torch.core.distributed.Ring`, one axis ``"p"``
    of its size; empty: the ring can hold the tree), each as ``"<path>: dim
    <d> (logical axis <a> -> mesh axes <axes>, size <s>) does not divide"``,
    the JAX package's words.

    Each leaf's logical axes map through ``rules`` (logical name → tuple of
    axes) directly, so a dimension that does not divide is reported, never
    quietly replicated.
    """
    problems = []
    sizes = {RING_AXIS: ring.size}
    for path, spec in _leaves_with_paths(spec_tree):
        used: set[str] = set()
        for dim, ax in zip(spec.shape, spec.axes):
            phys = rules.get(ax) if ax else None
            keep = tuple(a for a in (phys or ()) if a in sizes and a not in used)
            if not keep:
                continue
            total = 1
            for a in keep:
                total *= int(sizes[a])
            if dim % total:
                problems.append(
                    f"{path or '<root>'}: dim {dim} (logical axis {ax!r} -> mesh axes "
                    f"{keep}, size {total}) does not divide"
                )
            else:
                used.update(keep)
    return problems


def reshard_rows(block: torch.Tensor, ring, new_ring) -> torch.Tensor | None:
    """This rank's block of rows on ``new_ring``, from its block on ``ring``:
    one ``all_gather`` on ``ring`` (every rank of ``ring`` calls it), then
    each rank of ``new_ring`` keeps its ``1/p'`` of the rows.  A rank
    outside ``new_ring`` (rank -1) gets ``None``.  The row count must divide
    by ``new_ring``'s size (:func:`validate_mesh_for_tree` checks first)."""
    whole = ring.all_gather(block)
    if new_ring.rank < 0:
        return None
    return shard_rows(whole, new_ring).clone()
