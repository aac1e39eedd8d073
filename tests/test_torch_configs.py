"""Parity of the port's configs (``repro_torch.configs``) with the
reference's: the registry, the shape cells and every arch's ``CONFIG``
and ``SMOKE``. Tolerance: none, the configs are copies and must be equal."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.configs import registry as ref_reg  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402

ARCHS = ref_reg.arch_ids()


def test_registry_lists_the_same_archs_and_families():
    assert registry.arch_ids() == ARCHS
    assert [registry.family_of(a) for a in ARCHS] == [ref_reg.family_of(a) for a in ARCHS]
    assert registry.all_cells() == ref_reg.all_cells()
    assert len(registry.all_cells()) == 40


def test_shape_tables_are_equal():
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "MSF_SHAPES"):
        got = [dataclasses.asdict(s) for s in getattr(base, name)]
        assert got == [dataclasses.asdict(s) for s in getattr(ref_base, name)], name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
def test_config_fields_equal(arch, smoke):
    got, want = registry.get_config(arch, smoke), ref_reg.get_config(arch, smoke)
    assert type(got).__name__ == type(want).__name__
    assert type(got).__module__.startswith("repro_torch.configs.")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if hasattr(want, "param_count"):
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.hd == want.hd


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_for_and_get_shape(arch):
    got = registry.shapes_for(arch)
    assert [dataclasses.asdict(s) for s in got] == [
        dataclasses.asdict(s) for s in ref_reg.shapes_for(arch)]
    for s in got:
        assert dataclasses.asdict(registry.get_shape(arch, s.name)) == dataclasses.asdict(
            ref_reg.get_shape(arch, s.name))
    with pytest.raises(KeyError):
        registry.get_shape(arch, "no_such_shape")
