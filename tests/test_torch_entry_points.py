"""The port's entry points against the JAX package's, as a user starts them:
``examples/quickstart_torch.py``, ``examples/protein_clustering_torch.py``
and ``python -m repro_torch.launch.cluster_run`` in both modes, each with
``--device cpu`` in a process of its own.  Each must exit 0 (its own
asserts pass) and print the cluster sizes, purity and heights its JAX
counterpart prints on the same seed.  ``repro_torch.configs`` holds the
paper's configuration field for field.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import paper_lw as jpaper  # noqa: E402
from repro_torch.configs import CONFIG, REDUCED, ClusterConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

#: (the port's command, the JAX package's command): arguments after ``python``.
ENTRY_POINTS = {
    "quickstart": (["examples/quickstart_torch.py", "--device", "cpu"],
                   ["examples/quickstart.py"]),
    "protein": (["examples/protein_clustering_torch.py", "--device", "cpu"],
                ["examples/protein_clustering.py"]),
    "cluster_run embed": (["-m", "repro_torch.launch.cluster_run", "--device", "cpu",
                           "--n", "96"],
                          ["-m", "repro.launch.cluster_run", "--n", "96"]),
    "cluster_run rmsd": (["-m", "repro_torch.launch.cluster_run", "--device", "cpu",
                          "--n", "96", "--mode", "rmsd"],
                         ["-m", "repro.launch.cluster_run", "--n", "96", "--mode", "rmsd"]),
}

#: What a run prints that does not depend on the clock: the device count,
#: the backend, the cluster sizes, the purity, the heights.
RESULT_WORDS = ("devices", "backend=", "cluster sizes", "purity", "heights", "height jump",
                "conformations")


def run(args: list) -> list:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, f"{args} exit code {proc.returncode}:\n{proc.stderr[-3000:]}"
    return proc.stdout.splitlines()


def results(lines: list) -> list:
    """The lines that report results, with any timing cut out."""
    out = []
    for line in lines:
        if any(word in line for word in RESULT_WORDS):
            # "[cluster] 95 merges in 0.05s (backend=serial); ..." -> the parts after the time
            out.append(" ".join(w for w in line.split() if not w.rstrip(",)").endswith("s")
                                or not w[:1].isdigit()))
    return out


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_prints_the_reference_results(name):
    port, reference = ENTRY_POINTS[name]
    got = results(run(port))
    assert any("purity" in line for line in got)
    assert got == results(run(reference))


def test_results_ignore_only_times():
    assert results(["[cluster] 95 merges in 0.05s (backend=serial); purity@k=8: 1.000"]) == \
        ["[cluster] 95 merges in (backend=serial); purity@k=8: 1.000"]
    assert results(["clustering: 0.03s (backend=serial)", "RMSD matrix build: 0.38s"]) == \
        ["clustering: (backend=serial)"]


@pytest.mark.parametrize("name", ("CONFIG", "REDUCED"))
def test_paper_config_matches_reference(name):
    got, want = {"CONFIG": CONFIG, "REDUCED": REDUCED}[name], getattr(jpaper, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(ClusterConfig)] == \
        [f.name for f in dataclasses.fields(jpaper.ClusterConfig)]
    assert dataclasses.asdict(ClusterConfig()) == dataclasses.asdict(jpaper.ClusterConfig())
