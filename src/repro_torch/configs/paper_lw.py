"""Paper workload config — the clustering experiment grid.

The paper's experiment (its Figure 2): complete-linkage Lance-Williams over
n ≈ 1968 items, swept over processor counts.  A copy of the JAX package's
``repro/configs/paper_lw.py``, field for field; its sizes are the
defaults of :mod:`repro_torch.launch.cluster_run`'s paper runs.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ClusterConfig:
    name: str = "paper-lw"
    n_items: int = 1968          # the paper's average problem size
    dim: int = 64                # synthetic embedding dim for matrix builds
    atoms: int = 24              # protein-conformation mode: atoms per chain
    method: str = "complete"     # the paper's experimental linkage
    metric: str = "euclidean"
    backend: str = "distributed"
    variant: str = "baseline"    # baseline | rowmin (beyond-paper engine)
    seed: int = 0
    # the paper's processor sweep (Fig. 2 x-axis, adapted to powers of two)
    proc_sweep: tuple[int, ...] = (1, 2, 4, 8, 16)


CONFIG = ClusterConfig()
REDUCED = ClusterConfig(n_items=96, dim=8, atoms=8, proc_sweep=(1, 2, 4))
