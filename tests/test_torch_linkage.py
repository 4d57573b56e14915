"""Port vs reference: the Lance-Williams coefficient table, all 7 methods."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import linkage as ref  # noqa: E402
from repro_torch.core import linkage  # noqa: E402


@pytest.mark.parametrize("method", ref.METHODS)
def test_coefficients_match_reference(method, rng):
    n_k = rng.integers(1, 9, 50).astype(np.float32)
    want = ref.coefficients(method, 3.0, 5.0, n_k)
    got = linkage.coefficients(method, 3.0, 5.0, torch.from_numpy(n_k))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("method", ref.METHODS)
def test_update_row_matches_reference(method, rng):
    d_ki = np.abs(rng.normal(size=64)).astype(np.float32)
    d_kj = np.abs(rng.normal(size=64)).astype(np.float32)
    sizes = rng.integers(1, 6, 64).astype(np.float32)
    want = ref.update_row(method, d_ki, d_kj, 0.41, 2.0, 5.0, sizes)
    got = linkage.update_row(
        method, torch.from_numpy(d_ki), torch.from_numpy(d_kj),
        torch.tensor(0.41), torch.tensor(2.0), torch.tensor(5.0), torch.from_numpy(sizes),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_method_table_and_metric_convention():
    assert linkage.METHODS == ref.METHODS
    assert linkage.GEOMETRIC_METHODS == ref.GEOMETRIC_METHODS
    for m in ref.METHODS:
        assert linkage.default_metric(m) == ref.default_metric(m)
    for fn in (linkage.default_metric, lambda m: linkage.coefficients(m, 1, 1, 1)):
        with pytest.raises(ValueError, match="unknown linkage method"):
            fn("nope")
