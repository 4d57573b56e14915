"""Many-user embedding dedup with the port's batched clustering engine.

The PyTorch/CUDA twin of ``examples/batch_dedup.py``: the same fleet of
users with ragged document libraries (the same seed), clustered in one
``repro_torch.core.cluster_batch`` call (shape buckets, one batched
engine call a bucket), then deduplicated per user at each dendrogram's
height gap.  Each user's Euclidean distance matrix is built once here, in
float64 from the differences (the Gram form that either package builds
the matrix with carries relative errors near 1e-3 at a near-duplicate's
distance, far below the points' norms, and the two packages' builds round
differently).  Where the JAX package is installed too, the same matrices
go through its ``cluster_batch`` as the JAX example calls it, and every
user's merges are held against it: the same slots, heights within
rtol 1e-4 / atol 1e-5.

    PYTHONPATH=src python examples/batch_dedup_torch.py                 # on the CUDA device
    PYTHONPATH=src python examples/batch_dedup_torch.py --device cpu
    PYTHONPATH=src python examples/batch_dedup_torch.py --backend kernel
"""

import argparse
import importlib.util

import numpy as np

from repro_torch.core import cluster_batch

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None, help="torch device (default: CUDA)")
parser.add_argument("--backend", default="auto", choices=("auto", "serial", "kernel"))
args = parser.parse_args()

rng = np.random.default_rng(0)

# --- a fleet of users, each with their own embedded document library ------
# (exactly the JAX example's draw: a handful of distinct documents plus
# near-duplicates within eps of their original embedding)
N_USERS, DIM = 48, 32
libraries, truths = [], []
for u in range(N_USERS):
    n_docs = int(rng.integers(4, 13))            # ragged: 4..12 originals
    n_dups = int(rng.integers(1, 3))             # 1..2 dups per original
    originals = rng.normal(scale=4.0, size=(n_docs, DIM))
    docs, truth = [], []
    for d in range(n_docs):
        docs.append(originals[d])
        truth.append(d)
        for _ in range(n_dups):
            docs.append(originals[d] + rng.normal(scale=0.05, size=DIM))
            truth.append(d)
    libraries.append(np.asarray(docs, np.float32))
    truths.append(np.asarray(truth))

matrices = [np.sqrt(((lib[:, None].astype(np.float64) - lib[None]) ** 2).sum(-1))
            .astype(np.float32) for lib in libraries]
sizes = [len(lib) for lib in libraries]
print(f"{N_USERS} users, {sum(sizes)} documents total, "
      f"library sizes {min(sizes)}..{max(sizes)}")

# --- one call clusters every user's library -------------------------------
batch = cluster_batch(matrices, method="complete", backend=args.backend, device=args.device)
print(f"engine={batch.stats.engine}; shape buckets used: "
      f"{dict(batch.stats.buckets)} (bucket_n -> n_users); pad waste "
      f"{batch.stats.pad_waste:.3f}")

# --- per-user dedup: cut each dendrogram at its height gap ----------------
n_groups_ok = 0
purities = []
for res, truth in zip(batch, truths):
    h = res.heights()
    gap = int(np.argmax(np.diff(h))) + 1 if res.n > 2 else 1
    labels = res.labels(max(res.n - gap, 1))
    n_found = labels.max() + 1
    n_groups_ok += int(n_found == truth.max() + 1)
    purities.append(sum(np.bincount(truth[labels == c]).max()
                        for c in range(n_found) if (labels == c).any()) / len(truth))

print(f"group-count recovered exactly for {n_groups_ok}/{N_USERS} users")
print(f"mean dedup purity: {np.mean(purities):.3f} (min {np.min(purities):.3f})")
assert np.mean(purities) > 0.95
assert n_groups_ok >= int(0.9 * N_USERS)

# --- the JAX example's merges, where that package is installed -----------
if importlib.util.find_spec("jax") is not None:
    from repro.core import cluster_batch as jax_cluster_batch

    want = jax_cluster_batch(matrices, method="complete")
    for user, (got, ref) in enumerate(zip(batch, want)):
        ref = np.asarray(ref.merges)
        assert np.array_equal(got.merges[:, :2], ref[:, :2]), f"user {user}: slots differ"
        np.testing.assert_allclose(got.merges[:, 2], ref[:, 2], rtol=1e-4, atol=1e-5)
    print(f"merges equal the JAX example's for all {N_USERS} users")
