"""The paper's end-to-end application on the port: cluster candidate
protein conformations by pairwise RMSD.

The PyTorch/CUDA twin of ``examples/protein_clustering.py`` (the same
conformations, the same seed).  Pipeline (paper §1, §5): conformations →
parallel RMSD distance matrix (born row-sharded over the ranks of a
``torch.distributed`` group) → distributed Lance-Williams complete-linkage
→ dendrogram → pick any cut level.  One process is a world-size-1 group;
under ``torchrun`` every rank runs it (one GPU a rank, gloo for
``--device cpu``) and rank 0 prints.

    PYTHONPATH=src python examples/protein_clustering_torch.py               # on the CUDA device
    PYTHONPATH=src python examples/protein_clustering_torch.py --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 examples/protein_clustering_torch.py
"""

import argparse
import time

import numpy as np
import torch.distributed as dist

from repro_torch.core import cluster
from repro_torch.core.distributed import distributed_pairwise, group_size, make_cluster_mesh
from repro_torch.data.synthetic import conformations
from repro_torch.launch.cluster_run import init_ranks

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None, help="torch device (default: CUDA)")
args = parser.parse_args()

N_CONF, ATOMS, K_TRUE = 96, 24, 6

device = init_ranks(args.device)
say = print if not dist.is_initialized() or dist.get_rank() == 0 else (lambda *a: None)
say(f"devices: {group_size()}")
confs, truth = conformations(seed=0, n=N_CONF, atoms=ATOMS, k=K_TRUE,
                             noise=0.08)
say(f"{N_CONF} conformations × {ATOMS} atoms "
    f"(each randomly rotated+translated — only RMSD sees the folds)")

try:
    # --- phase 1: parallel RMSD matrix (the paper's parallelized-RMSD step) ---
    mesh = make_cluster_mesh(device)
    t0 = time.time()
    D = distributed_pairwise(confs, kind="rmsd", mesh=mesh).gather().cpu().numpy()
    say(f"RMSD matrix build: {time.time() - t0:.2f}s  "
        f"(sharded over {mesh.size} devices)")

    # --- phase 2: distributed Lance-Williams over the same ring ---------------
    t0 = time.time()
    result = cluster(D, method="complete", mesh=mesh,
                     backend="distributed" if mesh.size > 1 else "serial")
    say(f"clustering: {time.time() - t0:.2f}s (backend={result.backend})")
finally:
    dist.destroy_process_group()

# --- inspect the tree ----------------------------------------------------------
labels = result.labels(K_TRUE)
purity = sum(np.bincount(truth[labels == c]).max()
             for c in range(K_TRUE) if (labels == c).any()) / N_CONF
say(f"purity @ k={K_TRUE}: {purity:.3f}")
h = result.heights()
say(f"merge heights: first={h[0]:.3f} last={h[-1]:.3f} "
    f"(the big jump marks the natural cluster count)")
gaps = np.diff(h)
say(f"largest height jump before merge #{int(np.argmax(gaps)) + 1} "
    f"→ suggests k≈{N_CONF - 1 - int(np.argmax(gaps))}")
assert purity > 0.9
