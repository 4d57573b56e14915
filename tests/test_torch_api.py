"""Port public API vs the JAX package's ``cluster(..., algorithm="lw",
backend="kernel")``, plus the port's own package rules."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build_distance_matrix as jbuild  # noqa: E402
from repro.core import cluster as jcluster  # noqa: E402
from repro_torch.core import build_distance_matrix, cluster  # noqa: E402
from repro_torch.data.synthetic import gaussian_mixture  # noqa: E402
from tests.conftest import SRC, random_distance_matrix  # noqa: E402


def test_quickstart_flow():
    X, truth = gaussian_mixture(seed=0, n=200, dim=16, k=5)
    result = cluster(X, method="complete", device="cpu")
    assert (result.backend, result.algorithm, result.n) == ("kernel", "lw", 200)
    labels = result.labels(5)
    purity = sum(np.bincount(truth[labels == c]).max()
                 for c in range(5) if (labels == c).any()) / len(truth)
    assert purity > 0.9


@pytest.mark.parametrize("method,as_matrix", [("complete", False), ("ward", False),
                                              ("average", True), ("centroid", True)])
def test_result_matches_reference(method, as_matrix, rng):
    X, _ = gaussian_mixture(seed=3, n=60, dim=8, k=4)
    data = random_distance_matrix(rng, 60, squared=method == "centroid") if as_matrix else X
    got = cluster(data, method, device="cpu")
    want = jcluster(data, method, algorithm="lw", backend="kernel")
    lm, wlm = got.linkage_matrix, want.linkage_matrix
    np.testing.assert_array_equal(lm[:, [0, 1, 3]], wlm[:, [0, 1, 3]])
    np.testing.assert_allclose(lm[:, 2], wlm[:, 2], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.heights(), want.heights(), rtol=1e-4, atol=1e-5)
    assert got.metric == want.metric
    for k in (1, 4, 9):
        np.testing.assert_array_equal(got.labels(k), want.labels(k))
        np.testing.assert_array_equal(got.exemplars(k), want.exemplars(k))
    if not as_matrix:
        np.testing.assert_allclose(got.centroids(4), want.centroids(4), rtol=1e-6)


def test_stop_at_k_result(rng):
    D = random_distance_matrix(rng, 30)
    got = cluster(D, "single", stop_at_k=6, device="cpu")
    want = jcluster(D, "single", algorithm="lw", backend="kernel", stop_at_k=6)
    assert got.n_merges == want.n_merges == 24 and got.n == 30
    np.testing.assert_array_equal(got.labels(6), want.labels(6))


def test_compaction_off_equals_auto(rng):
    D = random_distance_matrix(rng, 30)
    auto = cluster(D, "average", device="cpu")
    np.testing.assert_array_equal(cluster(D, "average", compaction=False, device="cpu").merges,
                                  auto.merges)


@pytest.mark.parametrize("metric", ("euclidean", "sqeuclidean"))
def test_build_distance_matrix_matches_reference(metric, rng):
    X = rng.normal(size=(50, 7)).astype(np.float32)
    got = build_distance_matrix(X, metric, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jbuild(X, metric)), rtol=1e-4, atol=1e-4)
    assert (np.diag(got.numpy()) == 0).all()
    assert torch.backends.cuda.matmul.allow_tf32 is False     # left as the caller had it


@pytest.mark.parametrize("knobs", [
    dict(variant="rowmin"), dict(variant="lazy"), dict(distance_threshold=1.0),
    dict(compaction=True), dict(algorithm="nnchain"), dict(algorithm="twophase"),
    dict(algorithm="landmark"), dict(backend="serial"), dict(backend="distributed"),
    dict(metric="rmsd"),
])
def test_knobs_not_ported_raise(knobs):
    X = np.zeros((6, 3), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cluster(X, "complete", device="cpu", **knobs)


@pytest.mark.parametrize("knobs", [dict(method="nope"), dict(variant="nope"),
                                   dict(algorithm="nope"), dict(backend="nope"),
                                   dict(compaction="sometimes"), dict(compaction="on"),
                                   dict(compaction=None), dict(metric="nope")])
def test_bad_knobs_raise_value_error(knobs):
    X = np.zeros((6, 3), np.float32)
    with pytest.raises(ValueError):
        cluster(X, **{"method": "complete", **knobs}, device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    X = np.zeros((6, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster(X, "complete")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_distance_matrix(X)


def test_non_symmetric_square_input_warns(rng):
    A = rng.random((8, 8))
    with pytest.warns(UserWarning, match="not symmetric"):
        cluster(A, "complete", device="cpu")


def test_package_imports_no_jax():
    """The port, every module of it, imports neither jax nor repro.*."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 12, mods\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'jax' or m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
