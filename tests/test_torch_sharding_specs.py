"""The port's placement rules (``repro_torch.launch.shardings``) and
logical axes (``repro_torch.models.sharding``) against the JAX package's,
on no world: the rules depend on leaf names, shapes and mesh axis sizes
only, so the reference is evaluated on a ``jax.sharding.AbstractMesh``
and the port on a mapping of the same sizes.

Every parameter, moment, cache and input leaf of all ten archs, on both
production meshes and the host meshes (2, 2) and (4, 2), equals the
reference's.  The reference stacks each group's leaves (and an encoder's
layers) on a leading axis, which the port unstacks: a port leaf's spec is
the tail of the reference's.  A stacked moment's ZeRO-1 ``data`` sits on
that leading axis in the reference, so only the tail is compared there
too."""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P
from jax.tree_util import DictKey

from repro import configs as ref_configs
from repro.launch import shardings as ref_sh
from repro.launch import specs as ref_specs
from repro.models import sharding as ref_sharding
from repro_torch import configs as pt_configs
from repro_torch.launch import shardings as pt_sh
from repro_torch.launch import specs as pt_specs
from repro_torch.models import sharding as pt_sharding

ARCHS = sorted(ref_configs.ARCHS)
MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
    "host22": ((2, 2), ("data", "model")),
    "host42": ((4, 2), ("data", "model")),
}


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), dict(zip(axes, sizes))


def _tuple(spec) -> tuple:
    """A spec as a tuple, a one-axis tuple entry as its axis (jax's
    ``PartitionSpec`` normalises ``("data",)`` to ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    from repro.models.model import abstract_params
    return abstract_params(ref_configs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _pt_state(arch):
    return pt_specs.abstract_train_state(pt_configs.get_config(arch))


def _ref_leaves(tree, specs):
    """``[(path keys, aval, spec)]`` of a reference tree and its spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return [([str(e.key) for e in path if isinstance(e, DictKey)], aval, spec)
            for (path, aval), spec in zip(leaves, spec_leaves)]


def _port_names(keys, cfg):
    """The port's ``named_parameters()`` names of one reference leaf (one a
    group or encoder layer when the reference stacks it)."""
    if keys[0] == "groups":
        n = len(_pt_state(cfg.name).params["groups"])
        return [".".join(["groups", str(g)] + keys[1:]) for g in range(n)], True
    if keys[:2] == ["encoder", "layers"]:
        return [".".join(["encoder", "layers", str(i)] + keys[2:])
                for i in range(cfg.encoder_layers)], True
    return [".".join(keys)], False


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs(arch, mesh):
    amesh, sizes = _meshes(mesh)
    cfg = ref_configs.get_config(arch)
    ref_p = _ref_params(arch)
    ref_ps = ref_sh.param_pspecs(ref_p, amesh)
    ref_os = ref_sh.opt_pspecs(ref_p, ref_ps, amesh)
    params = _pt_state(arch).params
    pt_ps = pt_sh.param_pspecs(params, sizes)
    pt_os = pt_sh.opt_pspecs(params, pt_ps, sizes)
    seen = set()
    for (keys, aval, spec), (_, _, ospec) in zip(_ref_leaves(ref_p, ref_ps),
                                                _ref_leaves(ref_p, ref_os)):
        names, stacked = _port_names(keys, cfg)
        want, owant = _tuple(spec), _tuple(ospec)
        if stacked:
            assert want[0] is None
            want, owant = want[1:], owant[1:]
        for n in names:
            assert tuple(params.get_parameter(n).shape) == tuple(aval.shape)[stacked:]
            assert pt_ps[n] == want, (n, pt_ps[n], want)
            assert pt_os[n] == owant, (n, pt_os[n], owant)
            seen.add(n)
    assert seen == set(pt_ps)


def _cache_leaves(cache, prefix=()):
    if isinstance(cache, dict):
        for k, v in cache.items():
            yield from _cache_leaves(v, prefix + (k,))
    elif isinstance(cache, list):
        for i, v in enumerate(cache):
            yield from _cache_leaves(v, prefix + (i,))
    else:
        yield prefix, cache


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_io_specs(arch, mesh):
    amesh, sizes = _meshes(mesh)
    ref_cfg, pt_cfg = ref_configs.get_config(arch), pt_configs.get_config(arch)
    n_cases = 0
    for shape in ref_configs.applicable_shapes(ref_cfg):
        pt_shape = pt_configs.SHAPES_BY_NAME[shape.name]
        ref_b = ref_specs.batch_specs(ref_cfg, shape)
        pt_b = pt_specs.batch_specs(pt_cfg, pt_shape)
        assert sorted(ref_b) == sorted(pt_b)
        for k in ref_b:
            assert _tuple(pt_sh.io_pspec(sizes, tuple(pt_b[k].shape))) == \
                _tuple(ref_sh.io_pspec(amesh, ref_b[k].shape))
        if not shape.is_decode:
            continue
        ref_c = ref_specs.abstract_cache(ref_cfg, shape)
        ref_cs = ref_sh.cache_pspecs(ref_c, amesh)
        pt_c = pt_specs.abstract_cache(pt_cfg, pt_shape)
        pt_cs = pt_sh.cache_pspecs(pt_c, sizes)
        ref_by_path = {}
        for keys, aval, spec in _ref_leaves(ref_c, ref_cs):
            ref_by_path[tuple(keys)] = (aval, _tuple(spec))
        for path, leaf in _cache_leaves(pt_c):
            got = _tuple(_get(pt_cs, path))
            if path[0] == "groups":   # reference: stacked on the groups axis
                aval, want = ref_by_path[("groups",) + path[2:]]
                assert want[0] is None
                want, rshape = want[1:], tuple(aval.shape)[1:]
            else:
                aval, want = ref_by_path[path]
                rshape = tuple(aval.shape)
            assert tuple(leaf.shape) == rshape and got == want, (path, got, want)
            n_cases += 1
    assert n_cases or not any(s.is_decode for s in ref_configs.applicable_shapes(ref_cfg))


def _spec_case(arch, mesh, shape_name):
    """(reference, port) specs of one named cell's leaves."""
    amesh, sizes = _meshes(mesh)
    ref_cfg, pt_cfg = ref_configs.get_config(arch), pt_configs.get_config(arch)
    ref_p = _ref_params(arch)
    ref_ps = {".".join(k): _tuple(s) for k, _, s in
              _ref_leaves(ref_p, ref_sh.param_pspecs(ref_p, amesh))}
    pt_ps = pt_sh.param_pspecs(_pt_state(arch).params, sizes)
    shape = ref_configs.SHAPES_BY_NAME[shape_name]
    ref_c = ref_specs.abstract_cache(ref_cfg, shape)
    ref_cs = {".".join(k): _tuple(s) for k, _, s in
              _ref_leaves(ref_c, ref_sh.cache_pspecs(ref_c, amesh))}
    pt_c = pt_specs.abstract_cache(pt_cfg, pt_configs.SHAPES_BY_NAME[shape_name])
    return ref_ps, pt_ps, ref_cs, pt_sh.cache_pspecs(pt_c, sizes)


def test_mixtral_experts_on_16_shard_d_ff():
    """8 experts do not divide a 16-wide axis: Megatron TP within each
    expert, d_ff over ``model``."""
    ref_ps, pt_ps, _, _ = _spec_case("mixtral-8x7b", "single", "decode_32k")
    assert ref_ps["groups.b0.moe.w_in"] == (None, None, None, "model")
    assert pt_ps["groups.0.b0.moe.w_in"] == (None, None, "model")
    assert pt_ps["groups.0.b0.moe.w_out"] == (None, "model", None)
    # 64 experts divide it: expert parallelism
    _, pt_ps, _, _ = _spec_case("moonshot-v1-16b-a3b", "single", "decode_32k")
    assert pt_ps["groups.0.b0.moe.w_in"] == ("model", None, None)


def test_kv1_cache_shards_head_dim():
    """One KV head (gemma-2b's MQA): the cache's head_dim goes over ``model``."""
    _, _, ref_cs, pt_cs = _spec_case("gemma-2b", "single", "decode_32k")
    assert ref_cs["groups.b0.kv.k"] == (None, "data", None, None, "model")
    assert pt_cs["groups"][0]["b0"]["kv"]["k"] == (("data",), None, None, "model")


def test_long_500k_batch_one_shards_length_over_data():
    """B = 1 does not divide ``data``: the cache length goes over it."""
    _, _, ref_cs, pt_cs = _spec_case("gemma-2b", "multi", "long_500k")
    assert ref_cs["groups.b0.kv.k"] == (None, None, "data", None, "model")
    assert pt_cs["groups"][0]["b0"]["kv"]["k"] == (None, "data", None, "model")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_and_spec_match_the_reference(mesh):
    amesh, sizes = _meshes(mesh)
    for dim in (None, "batch", "model", "expert", "data"):
        want = ref_sharding._resolve(dim, amesh)
        assert pt_sharding._resolve(dim, sizes) == want
    with pytest.raises(ValueError):
        pt_sharding._resolve("heads", sizes)
    dims = ("batch", None, "model")
    with pt_sharding.use_mesh(sizes):
        got = pt_sharding.spec(*dims)
    assert got == tuple(ref_sharding._resolve(d, amesh) for d in dims)


def test_spec_and_constrain_without_a_mesh_do_nothing():
    import torch

    assert pt_sharding.current_mesh() is None
    assert pt_sharding.spec("batch", "model") == _tuple(ref_sharding.spec("batch", "model"))
    x = torch.randn(2, 3)
    assert pt_sharding.constrain(x, "batch", "model") is x
    with pt_sharding.use_mesh({"data": 2, "model": 2}):
        assert pt_sharding.current_mesh() == {"data": 2, "model": 2}
        assert pt_sharding.constrain(x, "batch", "model") is x   # not a DTensor
    assert pt_sharding.current_mesh() is None


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_of_specs(mesh):
    from torch.distributed.tensor import Replicate, Shard

    _, sizes = _meshes(mesh)
    got = pt_sharding.placements((("pod", "data") if "pod" in sizes else ("data",),
                                  None, "model"), sizes)
    want = [Shard(0)] * (len(sizes) - 1) + [Shard(2)]
    assert got == want
    assert pt_sharding.placements((None, None), sizes) == [Replicate()] * len(sizes)
