"""The port's checkpoints against the JAX package's, on the CPU.

Each package restores the other's checkpoint of a train state: the port's
written by ``repro_torch.training.checkpoint`` and restored by
``repro.training.checkpoint`` into the reference's ``TrainState``, and the
reference's restored by the port's into a port state, equal leaf for
leaf, for a float32 and a bfloat16 state (bfloat16 leaves: the same
bytes, npz ``|V2`` on both sides, ROADMAP R10).  The layout (manifest,
shards by descending bytes, leaf order) is the reference's; a stale
``.tmp.step_X`` is ignored; a shape mismatch raises;
``numpy_from_params`` inverts ``params_from_numpy`` bit for bit."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import model as ref_model
from repro.training import checkpoint as ref_ckpt
from repro.training import optimizer as ref_opt
from repro.training import train_step as ref_step
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.convert import (
    numpy_from_params, params_from_numpy, restack, to_numpy)
from repro_torch.training import checkpoint as pt_ckpt
from repro_torch.training import optimizer as pt_opt
from repro_torch.training import train_step as pt_step

CPU = "cpu"
STATES = {  # id: (arch, param dtype, layers)
    "phi4-float32": ("phi4-mini-3.8b", "float32", None),
    "phi4-bfloat16": ("phi4-mini-3.8b", "bfloat16", None),
    "whisper-bfloat16": ("whisper-base", "bfloat16", None),
    "recurrentgemma-rem-float32": ("recurrentgemma-2b", "float32", 5),
}


def _configs(case):
    arch, dtype, layers = STATES[case]
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    if layers:
        kw["n_layers"] = layers
    return (dataclasses.replace(ref_reduce(ref_get_config(arch)), **kw),
            dataclasses.replace(reduce_for_smoke(get_config(arch)), **kw))


def _ref_state(ref_cfg, seed):
    """A reference TrainState with non-zero moments and step."""
    params = ref_model.init_model(jax.random.PRNGKey(seed), ref_cfg)
    rng = np.random.default_rng(seed)

    def moment(x):
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))

    return ref_step.TrainState(params, ref_opt.OptState(
        step=jnp.int32(seed + 3), mu=jax.tree.map(moment, params),
        nu=jax.tree.map(moment, params)))


def _port_state(ref_state, cfg):
    """The port's TrainState carrying the same values."""
    params = params_from_numpy(jax.tree.map(np.asarray, ref_state.params), cfg, CPU)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")

    def named(tree):
        mod = params_from_numpy(jax.tree.map(np.asarray, tree), cfg32, CPU)
        return {n: p.detach().clone() for n, p in mod.named_parameters()}

    return pt_step.TrainState(params, pt_opt.OptState(
        step=torch.tensor(int(ref_state.opt.step), dtype=torch.int32),
        mu=named(ref_state.opt.mu), nu=named(ref_state.opt.nu)))


def _bits(x):
    a = np.asarray(x)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V":  # bfloat16, or its raw bytes
        return a.view(np.uint16)
    return a


def _assert_leaves_equal(got_leaves, want_leaves):
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _port_leaves(state, cfg):
    """The port state's leaves in the reference's order (numpy)."""
    params = jax.tree.leaves(numpy_from_params(state.params, cfg))
    opt = state.opt
    moments = []
    for d in (opt.mu, opt.nu):
        moments.append([to_numpy(x) for x in jax.tree.leaves(
            restack(d, cfg), is_leaf=lambda x: isinstance(x, list))])
    return params + [np.asarray(opt.step)] + moments[0] + moments[1]


@pytest.mark.parametrize("case", list(STATES))
def test_the_reference_restores_the_ports_checkpoint(case, tmp_path):
    ref_cfg, cfg = _configs(case)
    ref_state = _ref_state(ref_cfg, 1)
    state = _port_state(ref_state, cfg)
    pt_ckpt.save_checkpoint(str(tmp_path), 7, state, cfg, n_shards=3)
    like = _ref_state(ref_cfg, 2)
    assert ref_ckpt.latest_step(str(tmp_path)) == 7
    restored = ref_ckpt.restore_checkpoint(str(tmp_path), 7, like)
    assert jax.tree.structure(restored) == jax.tree.structure(like)
    _assert_leaves_equal(jax.tree.leaves(restored), jax.tree.leaves(ref_state))
    manifest = json.load(open(tmp_path / "step_000000007" / "manifest.json"))
    want_dtypes = [str(np.asarray(x).dtype) for x in jax.tree.leaves(ref_state)]
    assert manifest["dtypes"] == want_dtypes


@pytest.mark.parametrize("case", list(STATES))
def test_the_port_restores_the_references_checkpoint(case, tmp_path):
    ref_cfg, cfg = _configs(case)
    ref_state = _ref_state(ref_cfg, 1)
    ref_ckpt.save_checkpoint(str(tmp_path), 9, ref_state, n_shards=3)
    state = _port_state(_ref_state(ref_cfg, 2), cfg)
    params = state.params
    out = pt_ckpt.restore_checkpoint(str(tmp_path), 9, state, cfg)
    assert out is state and out.params is params  # written in place
    if STATES[case][1] == "bfloat16":
        assert all(p.dtype in (torch.bfloat16, torch.float32) for p in params.parameters())
    _assert_leaves_equal(_port_leaves(out, cfg), jax.tree.leaves(ref_state))
    assert pt_ckpt.state_digest(out, cfg) == pt_ckpt.state_digest(
        _port_state(ref_state, cfg), cfg)


def test_the_layout_is_the_references(tmp_path):
    """The same state written by both packages: the same manifest and the
    same npz members, byte for byte."""
    ref_cfg, cfg = _configs("phi4-bfloat16")
    ref_state = _ref_state(ref_cfg, 4)
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, ref_state, n_shards=4)
    pt_ckpt.save_checkpoint(str(tmp_path / "pt"), 3, _port_state(ref_state, cfg), cfg,
                            n_shards=4)
    dirs = [tmp_path / side / "step_000000003" for side in ("ref", "pt")]
    manifests = [json.load(open(d / "manifest.json")) for d in dirs]
    assert manifests[0] == manifests[1]
    for s in range(4):
        with np.load(dirs[0] / f"shard_{s:03d}.npz") as a, \
                np.load(dirs[1] / f"shard_{s:03d}.npz") as b:
            assert a.files == b.files
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(_bits(a[key]), _bits(b[key]))


def test_stale_tmp_is_ignored_and_latest_step_wins(tmp_path):
    ref_cfg, cfg = _configs("phi4-float32")
    state = _port_state(_ref_state(ref_cfg, 1), cfg)
    d = str(tmp_path)
    assert pt_ckpt.latest_step(d) is None
    pt_ckpt.save_checkpoint(d, 5, state, cfg, n_shards=3)
    pt_ckpt.save_checkpoint(d, 9, state, cfg, n_shards=3)
    os.makedirs(os.path.join(d, ".tmp.step_000000012"))  # a crashed write
    os.makedirs(os.path.join(d, "step_000000011"))        # no manifest yet
    assert pt_ckpt.latest_step(d) == 9
    fresh = _port_state(_ref_state(ref_cfg, 2), cfg)
    pt_ckpt.restore_checkpoint(d, 9, fresh, cfg)
    assert pt_ckpt.state_digest(fresh, cfg) == pt_ckpt.state_digest(state, cfg)
    # a write over a stale temporary directory of its own step
    os.makedirs(os.path.join(d, ".tmp.step_000000013"))
    pt_ckpt.save_checkpoint(d, 13, state, cfg, n_shards=3)
    assert pt_ckpt.latest_step(d) == 13
    assert not os.path.exists(os.path.join(d, ".tmp.step_000000013"))


def test_shape_mismatch_and_missing_cfg_raise(tmp_path):
    d = str(tmp_path)
    pt_ckpt.save_checkpoint(d, 1, {"a": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        pt_ckpt.restore_checkpoint(d, 1, {"a": np.zeros((2, 2), np.float32)})
    got = pt_ckpt.restore_checkpoint(d, 1, {"a": np.ones((3, 3), np.float32)})
    assert torch.equal(got["a"], torch.zeros(3, 3))
    ref_cfg, cfg = _configs("phi4-float32")
    state = _port_state(_ref_state(ref_cfg, 1), cfg)
    pt_ckpt.save_checkpoint(d, 2, state, cfg)
    wide = dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)
    other = _port_state(_ref_state(dataclasses.replace(ref_cfg, d_ff=ref_cfg.d_ff * 2), 1),
                        wide)
    with pytest.raises(ValueError, match="shape"):
        pt_ckpt.restore_checkpoint(d, 2, other, wide)
    with pytest.raises(ValueError, match="cfg"):
        pt_ckpt.save_checkpoint(d, 3, state)


@pytest.mark.parametrize("case", list(STATES))
def test_numpy_from_params_inverts_params_from_numpy(case):
    ref_cfg, cfg = _configs(case)
    ref_params = ref_model.init_model(jax.random.PRNGKey(5), ref_cfg)
    tree = numpy_from_params(params_from_numpy(jax.tree.map(np.asarray, ref_params), cfg,
                                               CPU), cfg)
    assert jax.tree.structure(tree) == jax.tree.structure(ref_params)
    _assert_leaves_equal(jax.tree.leaves(tree), jax.tree.leaves(ref_params))
