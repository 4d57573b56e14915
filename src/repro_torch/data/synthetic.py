# Copy of src/repro/data/synthetic.py (numpy only). The port keeps its own copy because
# importing anything under repro.* imports jax.
"""Deterministic synthetic data generators.

Everything is a pure function of (seed, step) — the pipeline needs no
stored state beyond the step counter, which makes checkpoint/resume exact
and lets every host generate only its own shard (the data-parallel
equivalent of the paper's "send each processor its portion").

Generators:
* token batches (zipf-ish LM stream with a repeated-ngram structure so the
  loss actually falls during the example training runs)
* gaussian-mixture embeddings (clusterable; ground-truth labels returned)
* protein-like conformations (a base fold + per-cluster deformations) for
  the paper's RMSD pipeline
"""

from __future__ import annotations

import numpy as np


def token_batch(seed: int, step: int, batch: int, seq_len: int,
                vocab: int) -> dict:
    """(batch, seq_len+1) int32 tokens → {tokens, labels} shifted pair."""
    rng = np.random.default_rng((seed * 1_000_003 + step) % (2**63))
    # zipf-ish marginal + short repeated motifs (learnable structure)
    base = rng.zipf(1.3, size=(batch, seq_len + 1)).astype(np.int64)
    toks = (base - 1) % vocab
    motif = rng.integers(0, vocab, size=(batch, 8))
    for b in range(0, batch, 2):               # half the rows carry motifs
        pos = rng.integers(0, max(1, seq_len - 16))
        reps = (seq_len + 1 - pos) // 8
        if reps > 0:
            toks[b, pos:pos + reps * 8] = np.tile(motif[b], reps)
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def gaussian_mixture(seed: int, n: int, dim: int, k: int = 8,
                     spread: float = 6.0, *, return_labels: bool = True):
    """Clusterable embeddings: (points (n, dim), true labels (n,)).

    Pure function of ``seed`` — the same seed returns bit-identical
    points *and* labels (the quality harness diffs approximate tiers
    against ground truth, so determinism is load-bearing and tested).
    ``return_labels=False`` returns just the points; the draw is
    identical either way, so the two forms describe one dataset.
    """
    if not 1 <= k <= n:
        raise ValueError(
            f"gaussian_mixture needs 1 <= k <= n components, got k={k}, n={n}"
        )
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=spread, size=(k, dim))
    labels = rng.integers(0, k, size=n)
    pts = centers[labels] + rng.normal(size=(n, dim))
    if not return_labels:
        return pts.astype(np.float32)
    return pts.astype(np.float32), labels


def conformations(seed: int, n: int, atoms: int, k: int = 6,
                  noise: float = 0.15) -> tuple[np.ndarray, np.ndarray]:
    """Protein-like conformations (n, atoms, 3): k base folds + thermal
    noise + random rigid-body motion (so only RMSD recovers the folds)."""
    rng = np.random.default_rng(seed)
    folds = rng.normal(size=(k, atoms, 3)).cumsum(axis=1)  # chain-like walks
    folds -= folds.mean(axis=1, keepdims=True)
    labels = rng.integers(0, k, size=n)
    out = np.empty((n, atoms, 3), np.float32)
    for i in range(n):
        conf = folds[labels[i]] + rng.normal(scale=noise, size=(atoms, 3))
        # random rotation (QR of a gaussian) + translation
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        out[i] = conf @ q.T + rng.normal(scale=3.0, size=(1, 3))
    return out, labels
