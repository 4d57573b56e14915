"""The port's LM configuration registry against the JAX package's: the
archs, every field of every config (full and reduced), the derived sizes,
the parameter counts, the shape grid and its cells, and ``model_flops``
for every (arch, shape) cell."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import all_cells as ref_all_cells  # noqa: E402
from repro.configs import cell_runnable as ref_cell_runnable  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.configs.shapes import LONG_CONTEXT_OK as REF_LONG_CONTEXT_OK  # noqa: E402
from repro.roofline.analysis import model_flops as ref_model_flops  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    SHAPES,
    ModelConfig,
    all_cells,
    cell_runnable,
    get_config,
    list_archs,
)
from repro_torch.configs.shapes import LONG_CONTEXT_OK  # noqa: E402
from repro_torch.roofline import model_flops  # noqa: E402

ARCHS = ref_list_archs()


def test_list_archs_equal():
    assert list_archs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("reduced", (False, True), ids=("full", "reduced"))
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch, reduced):
    got, want = get_config(arch, reduced=reduced), ref_get_config(arch, reduced=reduced)
    assert isinstance(got, ModelConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for name in ("head_dim_", "d_inner_", "moe_dff_", "vocab_padded"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_replace_and_unknown_arch():
    cfg = get_config("gemma3-1b").replace(n_layers=2)
    assert cfg.n_layers == 2 and get_config("gemma3-1b").n_layers == 26
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_shapes_and_cells_equal():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert LONG_CONTEXT_OK == REF_LONG_CONTEXT_OK
    assert all_cells() == ref_all_cells()
    assert len(all_cells()) == 40
    for arch, shape in all_cells():
        assert cell_runnable(arch, shape) == ref_cell_runnable(arch, shape)


@pytest.mark.parametrize("steps", (1, 3))
def test_model_flops_equal_every_cell(steps):
    for arch, shape in all_cells():
        for reduced in (False, True):
            got = model_flops(get_config(arch, reduced=reduced), SHAPES[shape], steps)
            want = ref_model_flops(ref_get_config(arch, reduced=reduced), REF_SHAPES[shape], steps)
            assert got == want, (arch, shape, reduced)
