"""``repro_torch.launch.mesh`` against the reference's meshes.

The reference builds its meshes in a subprocess on 512 forced XLA host
devices (the device count is fixed when jax starts), and hands back each
mesh's shape, axis names and grid of device ids.  The port's production
meshes are built over a fake process group of 256 and 512 ranks in this
process (torch's ``fake`` backend: a rank of a world that does not
exist), its host meshes over a fake world of 8; their shapes, axis
names, rank grids and each rank's coordinates and axis slices must equal
the reference's.  Also ``make_mesh`` and ``rank_device``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.launch import mesh as pt_mesh

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import numpy as np
    from repro.launch import mesh as m

    out = {}
    for name, mesh in (("production", m.make_production_mesh()),
                       ("production-multi-pod", m.make_production_mesh(multi_pod=True)),
                       ("host", m.make_host_mesh(4, 2)),
                       ("host-pod", m.make_host_mesh(2, 2, 2))):
        out[name + "-ids"] = np.vectorize(lambda d: d.id)(mesh.devices)
        out[name + "-axes"] = np.array(mesh.axis_names)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``{name: (device-id grid, axis names)}`` of the reference's meshes."""
    tmp = tmp_path_factory.mktemp("mesh")
    (tmp / "reference.py").write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(tmp / "reference.py"),
                           str(tmp / "reference.npz")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = np.load(tmp / "reference.npz")
    names = {f[:-4] for f in got.files if f.endswith("-ids")}
    return {n: (got[n + "-ids"], tuple(str(a) for a in got[n + "-axes"]))
            for n in names}


def _same_as_reference(m, ids, axes, rank):
    """``m`` has the reference mesh's shape, axis names and rank grid, and
    ``rank`` its coordinate and axis slices there."""
    assert tuple(m.mesh.shape) == ids.shape and m.mesh_dim_names == axes
    assert m.mesh.tolist() == ids.tolist()
    coord = tuple(int(c) for c in np.argwhere(ids == rank)[0])
    assert tuple(m.get_coordinate()) == coord
    assert tuple(m.get_local_rank(a) for a in axes) == coord
    for i, a in enumerate(axes):
        assert m.size(i) == ids.shape[i]
        # the ranks that share this rank's slice along ``a``
        idx = list(coord)
        idx[i] = slice(None)
        assert m[a].mesh.tolist() == ids[tuple(idx)].tolist()


@pytest.fixture
def fake_world():
    """``init(world, rank)`` joins a fake world; torn down after the test."""
    def init(world, rank):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    try:
        yield init
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("rank_of", [0, 37, 200, -1])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(reference, fake_world, multi_pod, rank_of, device_type):
    ids, axes = reference["production-multi-pod" if multi_pod else "production"]
    world = ids.size
    rank = rank_of % world
    fake_world(world, rank)
    m = pt_mesh.make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    assert m.device_type == device_type
    _same_as_reference(m, ids, axes, rank)


def test_host_mesh_over_the_world_that_exists(reference, fake_world):
    fake_world(8, 5)
    m = pt_mesh.make_host_mesh(data=4, model=2, device_type="cpu")
    _same_as_reference(m, *reference["host"], 5)
    m3 = pt_mesh.make_host_mesh(data=2, model=2, pod=2, device_type="cpu")
    _same_as_reference(m3, *reference["host-pod"], 5)
    small = pt_mesh.make_host_mesh(data=2, model=2, device_type="cpu")
    assert small.get_coordinate() is None          # rank 5 is outside a 4-rank mesh
    with pytest.raises(ValueError, match="needs 16 ranks, the world has 8"):
        pt_mesh.make_host_mesh(data=4, model=2, pod=2, device_type="cpu")
    # make_mesh: explicit ranks, the world's device type (the fake group is no nccl)
    mine = pt_mesh.make_mesh([[4, 5], [6, 7]], ("pod", "data"))
    assert mine.device_type == "cpu" and mine.mesh_dim_names == ("pod", "data")
    assert tuple(mine.get_coordinate()) == (0, 1)


def test_rank_device(fake_world, monkeypatch):
    assert pt_mesh.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_mesh.rank_device()
    fake_world(4, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert pt_mesh.rank_device() == torch.device("cuda", 0)   # every rank on one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pt_mesh.rank_device() == torch.device("cuda", 3)
    assert pt_mesh.rank_device("cuda") == torch.device("cuda", 3)  # indexed by rank
    assert pt_mesh.rank_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pt_mesh.rank_device() == torch.device("cuda", 1)


def test_importing_touches_no_process_group():
    assert not dist.is_initialized()
