"""Quickstart: hierarchical clustering with the port's public API in ~20 lines.

The PyTorch/CUDA twin of ``examples/quickstart.py``: the same data (the
same seed), the same calls, on the CUDA device unless ``--device`` names
another.

    PYTHONPATH=src python examples/quickstart_torch.py                 # on the CUDA device
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.core import cluster
from repro_torch.data.synthetic import gaussian_mixture

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None, help="torch device (default: CUDA)")
args = parser.parse_args()

# 1. clusterable data: 200 points from 5 gaussian blobs
X, truth = gaussian_mixture(seed=0, n=200, dim=16, k=5)

# 2. complete-linkage Lance-Williams (the paper's configuration);
#    backend='auto' → distributed over the ranks of a process group, if one is up
result = cluster(X, method="complete", device=args.device)
print(f"backend={result.backend}; {result.n - 1} merges")

# 3. the dendrogram can be cut at ANY level after the fact —
#    the advantage the paper highlights over K-means
for k in (2, 5, 10):
    labels = result.labels(k)
    print(f"k={k:2d}: cluster sizes = {np.bincount(labels).tolist()}")

# 4. with ground truth available, check purity at the true k
labels = result.labels(5)
purity = sum(np.bincount(truth[labels == c]).max()
             for c in range(5) if (labels == c).any()) / len(truth)
print(f"purity @ k=5: {purity:.3f}")
assert purity > 0.9
