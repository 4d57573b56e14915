"""Baselines the paper compares against (conceptually): K-means and
MST-based single linkage, in torch.

Counterpart of :mod:`repro.core.baselines`; both run on the CUDA device
unless the caller asks for the CPU.

* :func:`kmeans` — the partitional method the paper positions LW against
  (its §2/§3 discussion: K-means is cheap but needs a pre-set k and gives
  no hierarchy).  k-means++ seeding, then Lloyd iterations, as eager
  device ops that read nothing back to the host.  A ``torch.Generator``
  of the device takes the place of the reference's key.

* :func:`mst_single_linkage` — the specialized single-linkage algorithm the
  paper points to (Hendrix et al. 2013 / Prim's MST): O(n²) total instead
  of LW's O(n³).  Prim's loop runs on the device in float64, the Kruskal
  replay on the host; the merges are the reference's bit for bit, and its
  dendrogram equals LW(single).

Neither holds a kernel: the reference runs both as jnp and numpy, and its
k-means computes its distances in the Gram form of
:func:`repro_torch.core.distance.pairwise_sq_euclidean` (B4's plain
version, called here without recording distance queries, as the
reference's jit'd calls record none).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.distance import full_fp32_matmul
from repro_torch.core.engine import resolve_device
from repro_torch.kernels.pairwise import pairwise_sq_euclidean_plain


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (k, d)
    labels: torch.Tensor     # (n,) int64
    inertia: torch.Tensor    # scalar — sum of squared distances to centroids


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis, as numpy's and
    jnp's ``argmin`` give it whatever order the device reduces in: the
    ``min``, then the first index where ``== min`` (the first NaN where
    there is one)."""
    m = x.amin(-1, keepdim=True)
    ks = torch.arange(x.shape[-1], device=x.device)
    return torch.where((x == m) | x.isnan(), ks, x.shape[-1]).amin(-1)


def _kmeans_pp_init(gen: torch.Generator, X: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding (greedy D² sampling): the reference's masked full
    ``(n, k)`` distance each step, the next seed drawn by inverse CDF
    (cumsum, one uniform from ``gen``, ``searchsorted``), as
    ``jax.random.choice`` draws it; where every point is already a seed
    (all probabilities 0) that gives index 0, as the reference does."""
    n, dev = X.shape[0], X.device
    first = torch.randint(n, (1,), generator=gen, device=dev)
    cents = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=dev)
    cents[0:1] = X.index_select(0, first)
    for c in range(1, k):
        d2 = pairwise_sq_euclidean_plain(X, cents)          # (n, k)
        dmin = torch.where(torch.arange(k, device=dev) < c, d2, torch.inf).amin(1)
        cdf = torch.cumsum(dmin / torch.clamp_min(dmin.sum(), 1e-12), 0)
        u = torch.rand(1, generator=gen, device=dev, dtype=cdf.dtype)
        nxt = torch.searchsorted(cdf, cdf[-1:] * (1 - u))
        cents[c:c + 1] = X.index_select(0, nxt)
    return cents


def _centroids(X: torch.Tensor, labels: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Lloyd's update: each of ``cents`` moved to the mean of the points
    ``labels`` gives it; an empty cluster keeps its centroid."""
    k = cents.shape[0]
    one_hot = (labels[:, None] == torch.arange(k, device=X.device)).to(X.dtype)   # (n, k)
    counts = one_hot.sum(0)                                                   # (k,)
    with full_fp32_matmul():
        sums = one_hot.T @ X                                                  # (k, d)
    new = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where((counts > 0)[:, None], new, cents)


def _lloyd_step(X: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration: assign each point to its nearest centroid
    (first on ties), then :func:`_centroids`."""
    return _centroids(X, _first_argmin(pairwise_sq_euclidean_plain(X, cents)), cents)


def _lloyd(X: torch.Tensor, cents: torch.Tensor, iters: int) -> KMeansResult:
    """``iters`` Lloyd iterations from the centroids ``cents``, then the
    final assignment and inertia (the reference's body)."""
    for _ in range(iters):
        cents = _lloyd_step(X, cents)
    d2 = pairwise_sq_euclidean_plain(X, cents)
    return KMeansResult(cents, _first_argmin(d2), d2.amin(1).sum())


def kmeans(gen: torch.Generator, X, k: int, iters: int = 50, *, device=None) -> KMeansResult:
    """k-means++ seeding from ``gen`` (a generator of the run's device),
    then ``iters`` Lloyd iterations, on the CUDA device unless ``device``
    names another.  Nothing is read back to the host: the result's
    tensors stay on the device."""
    X = torch.as_tensor(X, dtype=torch.float32, device=resolve_device(device))
    return _lloyd(X, _kmeans_pp_init(gen, X, k), iters)


def _prim_edges(D: torch.Tensor):
    """Prim's MST on the symmetric float64 ``D``, from vertex 0: the
    ``n - 1`` tree edges ``(w, u, v)`` in the order Prim adds them, as
    device tensors.  Each step writes its vertex and weight into
    preallocated tensors and reads nothing back; an edge's source is final
    once its vertex joins the tree, so the sources are gathered after the
    loop.  ``cand`` is the reference's ``where(~in_tree, best, inf)``."""
    n, dev = D.shape[0], D.device
    ks = torch.arange(n, device=dev)
    out = ks != 0                                   # not yet in the tree
    cand = torch.where(out, D[0], torch.inf)
    src = torch.zeros(n, dtype=torch.int64, device=dev)
    w = torch.empty(max(n - 1, 0), dtype=torch.float64, device=dev)
    v = torch.empty(max(n - 1, 0), dtype=torch.int64, device=dev)
    for t in range(n - 1):
        m = cand.amin(0, keepdim=True)
        nxt = torch.where((cand == m) | cand.isnan(), ks, n).amin(0, keepdim=True)
        w[t:t + 1] = m
        v[t:t + 1] = nxt
        out.index_fill_(0, nxt, False)
        cand.index_fill_(0, nxt, torch.inf)
        row = D.index_select(0, nxt)[0]
        upd = (row < cand) & out
        cand = torch.where(upd, row, cand)
        src = torch.where(upd, nxt, src)
    return w, src.index_select(0, v), v


def mst_single_linkage(D, *, device=None) -> np.ndarray:
    """Single-linkage merges via Prim's MST (Hendrix-style), O(n²).

    Returns an ``(n-1, 4)`` float64 merge list in the same slot convention
    as the LW engines: sorting the MST edges by weight and union-finding
    yields exactly the single-linkage dendrogram.  The O(n²) part (the
    triangle check, ``0.5·(D + Dᵀ)`` and Prim's loop) runs on the CUDA
    device unless ``device`` names another; the Kruskal replay runs on
    the host.  Bit for bit the JAX package's merges.
    """
    D = torch.as_tensor(D, device=resolve_device(device)).to(torch.float64)
    lower = torch.tril(D, -1).ne(0).any()
    D = torch.where(lower, D, torch.triu(D, 1))
    D = 0.5 * (D + D.T)
    w, u, v = (t.cpu().numpy() for t in _prim_edges(D))

    # --- Kruskal replay: sorted MST edges == single-linkage merges --------
    n = D.shape[0]
    parent = np.arange(n)
    rep = np.arange(n)       # slot representative (min original index)
    sizes = np.ones(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    merges = np.zeros((n - 1, 4))
    # the reference's stable list sort on the same float64 keys: the same
    # order, NaN weights included
    for t, e in enumerate(sorted(range(n - 1), key=w.__getitem__)):
        ru, rv = find(u[e]), find(v[e])
        si, sj = rep[ru], rep[rv]
        i, j = min(si, sj), max(si, sj)
        parent[rv] = ru
        sizes[ru] += sizes[rv]
        rep[ru] = i
        merges[t] = (i, j, w[e], sizes[ru])
    return merges
