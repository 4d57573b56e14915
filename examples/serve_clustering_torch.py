"""Serving clustering traffic on the port: micro-batching service + streaming assignment.

The PyTorch/CUDA twin of ``examples/serve_clustering.py``, end to end:

1. start a :class:`ClusteringService` on the device and **warm up** its
   declared shape buckets — every bucket program steady-state traffic can
   touch (static device buffers, and on the kernel engine each stage's
   captured CUDA graph) is built before the first request;
2. submit a burst of ragged requests (each a future) — the batcher packs
   them into buckets and runs one program a bucket, building nothing and
   capturing nothing during traffic;
3. take one user's finished dendrogram, export the k-cut's **exemplars**,
   and label new points with one pairwise-distance call — no
   re-clustering.

The users are the JAX example's (the same seed).  Where the JAX package is
installed too, the users go through its service with the JAX example's
configuration and through this one's, and every user's merges are held
against it: the same slots, heights within rtol 1e-4 / atol 1e-5.  For
that comparison each user is sent as a Euclidean matrix built once here,
in float64 (as ``examples/batch_dedup_torch.py`` does): each service
builds a points request's matrix in the Gram form, and the two packages'
builds round differently (by up to ~1e-4 here), enough to swap two
merges that lie that close.

    PYTHONPATH=src python examples/serve_clustering_torch.py                 # on the CUDA device
    PYTHONPATH=src python examples/serve_clustering_torch.py --device cpu
    PYTHONPATH=src python examples/serve_clustering_torch.py --engine kernel
"""

import argparse
import importlib.util

import numpy as np

from repro_torch.service import (
    ClusteringService,
    ServiceConfig,
    assign,
    build_index,
    engine_jit_cache_size,
)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None, help="torch device (default: CUDA)")
parser.add_argument("--engine", default="serial", choices=("serial", "kernel"))
args = parser.parse_args()

rng = np.random.default_rng(0)

# --- 1. a warmed service --------------------------------------------------
config = ServiceConfig(
    method="complete",
    engine=args.engine,
    max_batch=8,            # batching window closes at 8 requests …
    max_delay_ms=2.0,       # … or after 2 ms, whichever comes first
    bucket_ns=(8, 16, 32),  # the declared steady-state traffic mix
)
service = ClusteringService(config, device=args.device)
print(f"warmup built {service.warmup()} bucket programs on {service.device} "
      f"({len(config.bucket_ns)} buckets x padded batch sizes 1,2,4,8)")

# --- 2. a burst of ragged user requests -----------------------------------
compiles_before = service.cache.stats.compiles
built_before = engine_jit_cache_size()


def user_library(rng, n_groups=3, dim=8):
    """Ragged per-user library with real cluster structure: a few widely
    separated topics, several documents around each (the JAX example's)."""
    centers = rng.normal(scale=12.0, size=(n_groups, dim))
    docs = [c + rng.normal(size=(int(rng.integers(2, 9)), dim)) for c in centers]
    return np.concatenate(docs).astype(np.float32)


users = [user_library(rng) for _ in range(40)]
# is_distance=False: a user with n points in n dimensions would otherwise
# be misread as a pre-built distance matrix (the square-input ambiguity)
futures = [service.submit(X, is_distance=False) for X in users]
results = [f.result(timeout=120) for f in futures]

snap = service.metrics.snapshot(service.cache)
print(f"served {snap.n_requests} requests in {snap.n_batches} engine batches "
      f"(mean batch {snap.mean_batch_size:.2f}, pad waste {snap.pad_waste:.0%})")
print(f"latency p50={snap.p50_ms:.2f} ms p99={snap.p99_ms:.2f} ms; "
      f"cache hit rate {snap.cache_hit_rate:.0%}")
built = service.cache.stats.compiles - compiles_before
captured = engine_jit_cache_size() - built_before
print(f"built during traffic: programs={built} programs+graphs={captured}   "
      "<- the zero-build invariant")
assert built == captured == 0

# --- 3. streaming assignment: label new points without re-fitting ---------
result = results[0]                     # ClusterResult (kept its points)
k = 3
index = build_index(result, k)          # k medoid exemplars of the cut
print(f"\nuser 0: n={result.n} items, exported {index.k} exemplars ({index.metric})")

new_points = result.points[:5] + rng.normal(scale=0.2, size=(5, 8)).astype(np.float32)
labels = assign(index, new_points, device=args.device)    # ONE pairwise-distance call
base_labels = result.labels(k)
match = (labels == base_labels[:5]).all()
print(f"streamed labels {labels.tolist()} vs their originals "
      f"{base_labels[:5].tolist()} (match={match}) — no re-cluster needed")
assert match

service.close()

# --- the JAX example's merges, where that package is installed -----------
if importlib.util.find_spec("jax") is not None:
    from repro.service import ClusteringService as JaxService
    from repro.service import ServiceConfig as JaxConfig

    mats = [np.sqrt(((X[:, None].astype(np.float64) - X[None]) ** 2).sum(-1)).astype(np.float32)
            for X in users]
    with ClusteringService(config, device=args.device) as service:
        got = [f.result(timeout=120) for f in service.submit_many(mats, is_distance=True)]
    with JaxService(JaxConfig(method="complete", engine=args.engine, max_batch=8,
                              max_delay_ms=2.0, bucket_ns=(8, 16, 32))) as jax_service:
        want = [f.result(timeout=120) for f in jax_service.submit_many(mats, is_distance=True)]
    for user, (g, ref) in enumerate(zip(got, want)):
        ref = np.asarray(ref.merges)
        assert np.array_equal(g.merges[:, :2], ref[:, :2]), f"user {user}: slots differ"
        np.testing.assert_allclose(g.merges[:, 2], ref[:, 2], rtol=1e-4, atol=1e-5)
    print(f"merges equal the JAX example's service's for all {len(users)} users")
