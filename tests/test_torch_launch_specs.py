"""The port's abstract specs (``repro_torch.launch.specs``: ``meta``
tensors) against the reference's ``ShapeDtypeStruct``s, for every arch
and applicable shape: the batch, the train state (parameters, moments,
step), the decode cache and the decode position; shapes and dtypes, no
storage.  The reference stacks each group's leaves (and an encoder's
layers) on a leading axis: each port leaf is one slice of it."""
import functools

import jax
import pytest
from jax.tree_util import DictKey

from repro import configs as ref_configs
from repro.launch import specs as ref_specs
from repro_torch import configs as pt_configs
from repro_torch.launch import specs as pt_specs
from repro_torch.models.convert import restack

CELLS = [(a, s.name) for a in sorted(ref_configs.ARCHS)
         for s in ref_configs.applicable_shapes(ref_configs.get_config(a))]


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _ref_flat(tree) -> dict:
    return {tuple(str(e.key) for e in path if isinstance(e, DictKey)): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same(port_leaf, ref_leaf, what):
    """A port leaf (or a restacked list of them) against a reference aval."""
    shape = ((len(port_leaf), *port_leaf[0].shape) if isinstance(port_leaf, list)
             else tuple(port_leaf.shape))
    first = port_leaf[0] if isinstance(port_leaf, list) else port_leaf
    assert first.device.type == "meta", what
    assert shape == tuple(ref_leaf.shape), (what, shape, ref_leaf.shape)
    assert _dtype(first) == str(ref_leaf.dtype), (what, first.dtype, ref_leaf.dtype)


@functools.lru_cache(maxsize=None)
def _train_states(arch):
    return (ref_specs.abstract_train_state(ref_configs.get_config(arch)),
            pt_specs.abstract_train_state(pt_configs.get_config(arch)))


@pytest.mark.parametrize("arch", sorted(ref_configs.ARCHS))
def test_train_state_equals_the_reference(arch):
    ref, pt = _train_states(arch)
    cfg = pt_configs.get_config(arch)
    trees = [(dict(pt.params.named_parameters()), ref.params, "params"),
             (pt.opt.mu, ref.opt.mu, "mu"), (pt.opt.nu, ref.opt.nu, "nu")]
    for port, theirs, what in trees:
        mine = dict(_flat(restack(port, cfg)))
        want = _ref_flat(theirs)
        assert sorted(mine) == sorted(want), what
        for key, leaf in mine.items():
            _same(leaf, want[key], (what, key))
    _same(pt.opt.step, ref.opt.step, "step")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_equal_the_reference(arch, shape):
    ref_cfg, pt_cfg = ref_configs.get_config(arch), pt_configs.get_config(arch)
    ref_shape, pt_shape = ref_configs.SHAPES_BY_NAME[shape], pt_configs.SHAPES_BY_NAME[shape]
    ref_b, pt_b = ref_specs.batch_specs(ref_cfg, ref_shape), pt_specs.batch_specs(pt_cfg,
                                                                                   pt_shape)
    assert sorted(ref_b) == sorted(pt_b)
    for k in ref_b:
        _same(pt_b[k], ref_b[k], k)
    if not ref_shape.is_decode:
        return
    ref_c = _ref_flat(ref_specs.abstract_cache(ref_cfg, ref_shape))
    pt_c = pt_specs.abstract_cache(pt_cfg, pt_shape)
    mine = {}
    for group in pt_c["groups"]:
        for key, leaf in _flat(group):
            mine.setdefault(("groups",) + key, []).append(leaf)
    mine.update({("rem",) + key: leaf for key, leaf in _flat(pt_c.get("rem", {}))})
    assert sorted(mine) == sorted(ref_c)
    for key, leaf in mine.items():
        _same(leaf, ref_c[key], key)
    _same(pt_specs.decode_pos_spec(), ref_specs.decode_pos_spec(), "pos")


def test_abstract_params_hold_no_storage():
    params = pt_specs.abstract_train_state(pt_configs.get_config("phi4-mini-3.8b")).params
    assert all(p.is_meta for p in params.parameters())
    assert sum(p.numel() for p in params.parameters()) == 4_450_618_368
