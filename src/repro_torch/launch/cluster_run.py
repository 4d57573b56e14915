"""Distributed clustering driver — the paper's workload as a launchable job.

The port's twin of ``python -m repro.launch.cluster_run``: the same flags,
plus ``--device`` (default: the CUDA device).

    PYTHONPATH=src python -m repro_torch.launch.cluster_run --n 512 --method complete
    PYTHONPATH=src python -m repro_torch.launch.cluster_run --mode rmsd --n 256 --atoms 24
    PYTHONPATH=src python -m repro_torch.launch.cluster_run --device cpu --n 96

Under ``torchrun --nproc-per-node p`` every rank runs it (SPMD): the ranks
form the default process group from torchrun's environment (NCCL with one
GPU a rank, gloo for ``--device cpu``), ``backend="auto"`` then means the
distributed engine over them, and rank 0 prints.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import cluster
from repro_torch.core.distributed import distributed_pairwise, group_size, make_cluster_mesh
from repro_torch.core.engine import resolve_device
from repro_torch.data.synthetic import conformations, gaussian_mixture


def init_ranks(device=None) -> torch.device:
    """This process's device (CUDA unless told otherwise).  Under torchrun
    (``WORLD_SIZE`` set), first bring up the default process group from its
    environment, one GPU a rank (``LOCAL_RANK``) for CUDA, gloo for the
    CPU."""
    dev = resolve_device(device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--atoms", type=int, default=24)
    ap.add_argument("--k", type=int, default=8, help="ground-truth clusters")
    ap.add_argument("--method", default="complete")
    ap.add_argument("--mode", choices=("embed", "rmsd"), default="embed")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--variant", default="baseline",
                    choices=("baseline", "rowmin", "lazy"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args()

    dev = init_ranks(args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[cluster] devices={group_size()} n={args.n} method={args.method} "
        f"backend={args.backend} variant={args.variant}")

    try:
        if args.mode == "rmsd":
            data, truth = conformations(args.seed, args.n, args.atoms, k=args.k)
            mesh = make_cluster_mesh(dev)
            t0 = time.time()
            D = distributed_pairwise(data, kind="rmsd", mesh=mesh).gather().cpu().numpy()
            t_build = time.time() - t0
            say(f"[cluster] RMSD matrix build: {t_build:.2f}s "
                f"({args.n}×{args.n}, {args.atoms} atoms)")
            t0 = time.time()
            res = cluster(D, method=args.method, backend=args.backend,
                          variant=args.variant, device=dev)
        else:
            data, truth = gaussian_mixture(args.seed, args.n, args.dim, k=args.k)
            t0 = time.time()
            res = cluster(data, method=args.method, backend=args.backend,
                          variant=args.variant, device=dev)
        t_cluster = time.time() - t0

        labels = res.labels(args.k)
        # clustering accuracy vs ground truth (purity)
        purity = 0
        for c in range(args.k):
            members = truth[labels == c]
            if len(members):
                purity += np.bincount(members).max()
        purity /= len(truth)
        say(f"[cluster] {res.n - 1} merges in {t_cluster:.2f}s "
            f"(backend={res.backend}); purity@k={args.k}: {purity:.3f}")
        heights = res.heights()
        say(f"[cluster] merge heights: min={heights.min():.3f} "
            f"max={heights.max():.3f}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
