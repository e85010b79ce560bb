"""The port's dry run (``repro_torch.launch.dryrun``) on a fake world, two
cells: phi4-mini ``decode_32k`` on the single-pod mesh (256 ranks) and
gemma-2b ``prefill_32k`` on the two-pod mesh (512 ranks).

``arg_bytes_per_device`` equals the reference's ``_sharded_bytes`` over
its own avals and specs (on a ``jax.sharding.AbstractMesh``) exactly, and
``model_flops`` its ``model_flops_for``.  The phi4-mini decode step's
collectives equal a count by hand, bytes included (below), and ``--list``
prints what the reference's prints."""
import json
import os

import pytest
from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro.launch import shardings as ref_sh
from repro.launch import specs as ref_specs
from repro.roofline.analysis import model_flops_for as ref_model_flops
from repro_torch.launch import dryrun

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
FIELDS = ("variant", "arch", "shape", "mesh", "chips", "mode", "arg_bytes_per_device",
          "memory_analysis", "lower_s", "compile_s", "flops", "hbm_bytes", "link_bytes",
          "compute_s", "memory_s", "collective_s", "dominant", "model_flops",
          "useful_ratio")


def _ref_dryrun():
    """``repro.launch.dryrun`` imported without its XLA_FLAGS (it sets 512
    host devices at import; no backend starts here)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


def _ref_arg_bytes(arch, shape_name, multi):
    """The reference's ``arg_bytes_per_device`` of a decode or prefill
    cell, from its own avals and specs."""
    ref = _ref_dryrun()
    cfg, shape = ref_configs.get_config(arch), ref_configs.SHAPES_BY_NAME[shape_name]
    mesh = AbstractMesh(*MESHES[multi])
    params = ref_specs.abstract_train_state(cfg).params
    total = ref._sharded_bytes(params, ref_sh.param_pspecs(params, mesh), mesh)
    if shape.mode == "decode":
        cache = ref_specs.abstract_cache(cfg, shape)
        return total + ref._sharded_bytes(cache, ref_sh.cache_pspecs(cache, mesh), mesh)
    batch = ref_specs.batch_specs(cfg, shape)
    specs = {k: ref_sh.io_pspec(mesh, v.shape) for k, v in batch.items()}
    return total + ref._sharded_bytes(batch, specs, mesh)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The phi4-mini cell through the CLI (its JSON record), the gemma-2b
    cell through ``run_cell``."""
    out = tmp_path_factory.mktemp("dryrun")
    assert dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(out)]) == 0
    with open(out / "phi4-mini-3.8b_decode_32k_single.json") as f:
        phi4 = json.load(f)
    gemma = dryrun.run_cell("gemma-2b", "prefill_32k", multi_pod=True, verbose=False)
    return {("phi4-mini-3.8b", "decode_32k", False): phi4,
            ("gemma-2b", "prefill_32k", True): gemma}


CELLS = [("phi4-mini-3.8b", "decode_32k", False), ("gemma-2b", "prefill_32k", True)]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_arg_bytes_and_model_flops_equal_the_reference(records, cell):
    rec = records[cell]
    arch, shape_name, multi = cell
    assert rec["arg_bytes_per_device"] == _ref_arg_bytes(arch, shape_name, multi)
    assert rec["model_flops"] == ref_model_flops(ref_configs.get_config(arch),
                                                 ref_configs.SHAPES_BY_NAME[shape_name])
    assert rec["chips"] == (512 if multi else 256)
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_record_has_the_reference_fields(records, cell):
    rec = records[cell]
    assert set(FIELDS) <= set(rec)
    assert rec["compile_s"] is None and rec["memory_analysis"] is None
    assert "compiles nothing" in rec["notes"]
    assert rec["flops"] > 0 and rec["hbm_bytes"] > 0 and rec["link_bytes"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")


def test_prefill_counts_k12_a_layer(records):
    """K12 counted by its launch contract once a layer (gemma-2b: 18)."""
    assert records[("gemma-2b", "prefill_32k", True)]["kernels"] == {
        "flash_attention_bf16": 18}


def test_phi4_decode_collectives_by_hand(records):
    """phi4-mini decode, (16, 16): 32 layers, H 24, KV 8, hd 128, D 3072,
    rank 0's batch rows 128 / 16 = 8, a 32768-row cache sharded on
    head_dim (8 KV heads do not divide 16).  Each layer all-gathers q, k
    and v (their flat dims, 3072 / 16 and 1024 / 16 wide, do not split
    into heads over 16) and P·V's head_dim slices before the flat
    reshape: 4 all-gathers; it all-reduces the partial logits of its
    head_dim slice, the attention output and the MLP output: 3
    all-reduces; plus one for the vocab-sharded embedding lookup.  Link
    bytes (bf16 activations, float32 logits; ring factors 2 (n-1)/n and
    n - 1 at n = 16):"""
    rec = records[("phi4-mini-3.8b", "decode_32k", False)]
    L, B, n = 32, 8, 16
    assert rec["collectives"] == {"all_reduce": 3 * L + 1, "all_gather_into_tensor": 4 * L}
    act = B * 3072 * 2                          # (8, 1, 3072) bf16
    logits = B * 8 * 3 * 32768 * 4              # (8, KV 8, G 3, 1, 32768) f32
    all_reduce = (L * (2 * act + logits) + act) * 2 * (n - 1) / n
    gathered = B * (3072 + 1024 + 1024 + 8 * 3 * 128) // n * 2   # local q, k, v, P·V
    all_gather = L * gathered * (n - 1)
    assert rec["link_bytes_by_kind"] == {"all-reduce": all_reduce,
                                         "all-gather": all_gather}
    assert rec["link_bytes"] == all_reduce + all_gather


def test_list_equals_the_reference(capsys, monkeypatch):
    ref = _ref_dryrun()
    monkeypatch.setattr("sys.argv", ["dryrun", "--list"])
    ref.main()
    want = capsys.readouterr().out
    assert dryrun.main(["--list"]) == 0
    assert capsys.readouterr().out == want
    assert len(want.splitlines()) == 10


def test_refuses_an_existing_world(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="own"):
            dryrun.run_cell("phi4-mini-3.8b", "decode_32k", multi_pod=False)
    finally:
        dist.destroy_process_group()
