"""The port's architecture configs against the JAX package's: every field
of all ten configs (dtypes compared by name), the shape grid,
``applicable_shapes``, ``reduce_for_smoke`` and the parameter counts."""
import dataclasses

import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs as pt_configs

ARCH_IDS = sorted(ref_configs.ARCHS)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else dt.name


def test_registry_lists_the_same_ten_archs():
    assert pt_configs.list_archs() == ref_configs.list_archs() == ARCH_IDS
    assert len(ARCH_IDS) == 10
    with pytest.raises(KeyError):
        pt_configs.get_config("no-such-arch")


def test_shape_grid_is_the_same():
    assert [dataclasses.asdict(s) for s in pt_configs.SHAPES] == \
        [dataclasses.asdict(s) for s in ref_configs.SHAPES]
    assert sorted(pt_configs.SHAPES_BY_NAME) == sorted(ref_configs.SHAPES_BY_NAME)
    assert all(s.is_decode == (s.mode == "decode") for s in pt_configs.SHAPES)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_config_fields_and_dtypes(name):
    pt, ref = pt_configs.get_config(name), ref_configs.get_config(name)
    assert _fields(pt) == _fields(ref)
    assert pt.hd == ref.hd and pt.is_moe == ref.is_moe
    assert isinstance(pt.pdtype, torch.dtype) and isinstance(pt.cdtype, torch.dtype)
    assert _dtype_name(pt.pdtype) == _dtype_name(ref.pdtype)
    assert _dtype_name(pt.cdtype) == _dtype_name(ref.cdtype)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_reduce_for_smoke(name):
    pt = pt_configs.reduce_for_smoke(pt_configs.get_config(name))
    ref = ref_configs.reduce_for_smoke(ref_configs.get_config(name))
    assert _fields(pt) == _fields(ref)
    assert pt.pdtype == pt.cdtype == torch.float32


@pytest.mark.parametrize("name", ARCH_IDS)
def test_applicable_shapes(name):
    pt = pt_configs.applicable_shapes(pt_configs.get_config(name))
    ref = ref_configs.applicable_shapes(ref_configs.get_config(name))
    assert [dataclasses.asdict(s) for s in pt] == [dataclasses.asdict(s) for s in ref]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_parameter_counts(name, reduced):
    pt, ref = pt_configs.get_config(name), ref_configs.get_config(name)
    if reduced:
        pt, ref = pt_configs.reduce_for_smoke(pt), ref_configs.reduce_for_smoke(ref)
    assert pt.n_params_dense_equivalent() == ref.n_params_dense_equivalent()
    assert pt.n_active_params() == ref.n_active_params()
