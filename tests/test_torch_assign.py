"""Port streaming labeler vs the JAX package's ``repro.service.assign``.

Both packages label the same queries against the same representatives:
the port's index is built from the JAX index's fields (``reps`` is numpy
in both).  Labels must be equal for all four metrics and the three
backends; on the CPU the port's ``kernel`` route is B4's plain version.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cluster as jcluster  # noqa: E402
from repro.core import count_distance_queries as jcount  # noqa: E402
from repro_torch.core import cluster, count_distance_queries  # noqa: E402
from repro_torch.data.synthetic import conformations, gaussian_mixture  # noqa: E402

# the modules, not the functions both packages' ``service`` exports under their name
jassign = importlib.import_module("repro.service.assign")
tassign = importlib.import_module("repro_torch.service.assign")

BACKENDS = ("auto", "xla", "kernel")


@pytest.fixture(scope="module")
def fitted():
    pts, _ = gaussian_mixture(seed=0, n=120, dim=8, k=4, spread=8.0)
    return jcluster(pts, "ward"), cluster(pts, "ward", device="cpu"), pts


@pytest.fixture(scope="module")
def fitted_rmsd():
    C, _ = conformations(0, 40, 10, k=3, noise=0.1)
    return jcluster(C, "average", metric="rmsd"), C


def port_index(jidx):
    return tassign.AssignIndex(reps=np.asarray(jidx.reps), metric=jidx.metric, kind=jidx.kind)


def queries_for(metric, rng, n=57):
    if metric == "rmsd":
        return conformations(5, n, 10, k=3, noise=0.2)[0]
    return rng.normal(scale=6.0, size=(n, 8)).astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("metric,kind", [("sqeuclidean", "exemplar"), ("sqeuclidean", "centroid"),
                                         ("euclidean", "exemplar"), ("euclidean", "centroid"),
                                         ("cosine", "exemplar"), ("rmsd", "exemplar")])
def test_labels_match_reference(metric, kind, backend, fitted, fitted_rmsd, rng):
    if metric == "rmsd":
        jres, _ = fitted_rmsd
        jidx = jassign.build_index(jres, 3, kind=kind)
    else:
        jres = fitted[0]
        jidx = jassign.build_index(jres, 4, kind=kind, metric=metric)
    Q = queries_for(metric, rng)
    with jcount() as jb:
        want = jassign.assign(jidx, Q, backend=backend)
    with count_distance_queries() as tb:
        got = tassign.assign(port_index(jidx), Q, backend=backend, device="cpu")
    assert got.dtype == np.int64 and got.shape == (len(Q),)
    np.testing.assert_array_equal(got, want)
    assert tb.by_tag == jb.by_tag          # the kernel route records nothing in both


@pytest.mark.parametrize("kind", ("exemplar", "centroid"))
@pytest.mark.parametrize("k", (1, 4, 9))
def test_build_index_matches_reference(kind, k, fitted):
    jres, tres, _ = fitted
    jidx, tidx = jassign.build_index(jres, k, kind=kind), tassign.build_index(tres, k, kind=kind)
    assert (tidx.metric, tidx.kind, tidx.k) == (jidx.metric, jidx.kind, jidx.k)
    assert tidx.reps.dtype == np.float32
    np.testing.assert_allclose(tidx.reps, jidx.reps, rtol=1e-5, atol=1e-6)


def test_build_index_rmsd_exemplars(fitted_rmsd):
    jres, C = fitted_rmsd
    tres = cluster(C, "average", metric="rmsd", device="cpu")
    np.testing.assert_array_equal(tassign.build_index(tres, 3).reps,
                                  jassign.build_index(jres, 3).reps)


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_query_and_empty_batch(backend, fitted):
    jres, _, pts = fitted
    idx = port_index(jassign.build_index(jres, 4))
    one = tassign.assign(idx, pts[0], backend=backend, device="cpu")
    assert one.shape == (1,)
    np.testing.assert_array_equal(one, jassign.assign(jassign.build_index(jres, 4), pts[0],
                                                      backend=backend))
    empty = tassign.assign(idx, np.zeros((0, 8), np.float32), backend=backend, device="cpu")
    assert empty.shape == (0,) and empty.dtype.kind == "i"


def test_zero_vector_cosine_ties_go_to_first():
    reps = np.eye(3, dtype=np.float32)
    queries = np.asarray([[0.0, 0.0, 0.0], [0.0, 2.0, 0.0]], np.float32)
    idx = tassign.AssignIndex(reps=reps, metric="cosine", kind="exemplar")
    np.testing.assert_array_equal(tassign.assign(idx, queries, device="cpu"), [0, 1])
    zidx = tassign.AssignIndex(reps=np.zeros((2, 3), np.float32), metric="cosine",
                               kind="exemplar")
    np.testing.assert_array_equal(tassign.assign(zidx, queries, device="cpu"),
                                  jassign.assign(jassign.AssignIndex(zidx.reps, "cosine",
                                                                     "exemplar"), queries))


def test_kernel_route_matches_auto_route(fitted, rng):
    """B4's route and the Gram builder give the same labels (the
    reference's ``test_kernel_route_matches_xla_route``)."""
    _, tres, _ = fitted
    Q = rng.normal(scale=6.0, size=(57, 8)).astype(np.float32)
    for metric in ("sqeuclidean", "euclidean"):
        idx = tassign.build_index(tres, 4, metric=metric)
        np.testing.assert_array_equal(tassign.assign(idx, Q, backend="kernel", device="cpu"),
                                      tassign.assign(idx, Q, backend="xla", device="cpu"))


@pytest.mark.parametrize("call,match", [
    (lambda idx, res: tassign.assign(idx, np.zeros((2, 8), np.float32), backend="tpu",
                                     device="cpu"), "backend"),
    (lambda idx, res: tassign.assign(idx, np.zeros((2, 5), np.float32), device="cpu"),
     "does not match"),
    (lambda idx, res: tassign.build_index(res, 3, metric="manhattan"), "not in"),
    (lambda idx, res: tassign.build_index(res, 3, kind="medoid"), "kind"),
])
def test_validation(call, match, fitted):
    _, tres, _ = fitted
    with pytest.raises(ValueError, match=match):
        call(tassign.build_index(tres, 3), tres)
    assert set(tassign.ASSIGN_METRICS) == set(jassign.ASSIGN_METRICS)


def test_build_index_needs_points(fitted):
    _, tres, pts = fitted
    D = tres._distance_matrix()
    with pytest.raises(ValueError, match="from points"):
        tassign.build_index(cluster(D, "ward", device="cpu"), 3)


def test_default_device_is_cuda(fitted):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    idx = tassign.build_index(fitted[1], 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        tassign.assign(idx, np.zeros((2, 8), np.float32))
