"""Multi-pod dry run: every (arch x shape x mesh) cell placed and run once
on a fake world, without a device (port of ``repro.launch.dryrun``).

For each cell this driver:

1. joins a ``fake`` process group of 256 ranks (the ``(16, 16)`` single
   pod) or 512 (``(2, 16, 16)``, two pods) as rank 0, and builds the
   production mesh over it (``launch.mesh.make_production_mesh``);
2. under ``FakeTensorMode`` (CPU fake tensors: shapes and dtypes, no
   storage, so every dispatcher takes its plain path) places the
   parameters, moments, batch and cache by the rules
   (``launch.shardings``) as DTensors holding rank 0's blocks;
3. runs the mode's function once: the train step with remat, prefill,
   decode, or decode with the ``serve_topk`` variant (each model shard's
   local top-k over its vocabulary slice, merged by the tournament of
   ``serving.router.distributed_vocab_topk``);
4. counts what rank 0 ran (``roofline.op_cost.count_cost``: its local
   ops' FLOPs and bytes, K12 by its launch contract, each collective's
   operand bytes times the reference's ring factor) and the collectives
   (``CommDebugMode``), and records them.

The record has the reference's fields.  ``arg_bytes_per_device`` is the
reference's ``_sharded_bytes`` formula (a leaf's bytes over the product
of the mesh axes in its spec) over the port's leaves and specs.  The
roofline terms are one rank's counts at an H100's rates
(``roofline.analysis.roofline_per_device``), not the reference's TPU's.
The port compiles nothing, so ``compile_s`` and ``memory_analysis`` are
null (``notes`` says so); ``lower_s`` is the seconds the cell took.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Records go to ``--out`` (default ``experiments/dryrun_torch/`` at the
repository root), one JSON file a cell.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES_BY_NAME, applicable_shapes, get_config, list_archs
from repro_torch.launch import shardings as sh
from repro_torch.launch.specs import abstract_cache, abstract_train_state, batch_specs
from repro_torch.models.sharding import axis_sizes, use_mesh
from repro_torch.roofline.analysis import model_flops_for, roofline_per_device
from repro_torch.roofline.op_cost import count_cost

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")
NOTES = ("compile_s and memory_analysis are null: the port runs eagerly and "
         "compiles nothing; lower_s is the seconds of the fake-world run")


@contextlib.contextmanager
def fake_world(world: int):
    """Rank 0 of a ``fake`` process group of ``world`` ranks for the body
    (collectives return at once and move nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own (fake) world: a process group "
                           "already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def sharded_bytes(leaves, specs, mesh) -> float:
    """Per-device bytes of ``leaves`` under ``specs`` (the reference's
    ``_sharded_bytes``): each leaf's bytes over the product of the mesh
    axes its spec names."""
    sizes = axis_sizes(mesh)
    total = 0.0
    for t, spec in zip(leaves, specs):
        shards = 1
        for ax in spec:
            for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
                shards *= sizes[a]
        total += t.numel() * t.element_size() / shards
    return total


def _flat(tree, specs):
    """Matching leaves of a cache-like tree and its spec tree."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _flat(tree[k], specs[k])]
    if isinstance(tree, list):
        return [p for a, b in zip(tree, specs) for p in _flat(a, b)]
    return [(tree, specs)]


def _fake(t: torch.Tensor, spec, mesh):
    """A CPU fake DTensor of meta ``t``'s shape and dtype under ``spec``."""
    return sh.distribute(t, spec, mesh, device="cpu")


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               variant: str = "baseline"):
    """Place and run one cell on the fake world; returns ``(cfg, shape,
    mesh axis sizes, arg_bytes_per_device, cost, comm counts, seconds)``."""
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    t0 = time.time()
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        return _run_on(cfg, shape, mesh, variant, t0)


def _run_on(cfg, shape, mesh, variant, t0):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models.model import decode_step, prefill
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step

    with FakeTensorMode():
        sizes = axis_sizes(mesh)
        state = abstract_train_state(cfg)
        params = state.params
        p_specs = sh.param_pspecs(params, mesh)
        batch = batch_specs(cfg, shape)
        b_specs = {k: sh.io_pspec(mesh, tuple(v.shape)) for k, v in batch.items()}
        names = list(p_specs)
        arg_bytes = sharded_bytes([params.get_parameter(n) for n in names],
                                  [p_specs[n] for n in names], mesh)
        inputs = {k: _fake(v, b_specs[k], mesh) for k, v in batch.items()}
        if shape.mode == "train":
            o_specs = sh.opt_pspecs(params, p_specs, mesh)
            for tree in (state.opt.mu, state.opt.nu):
                arg_bytes += sharded_bytes([tree[n] for n in names],
                                           [o_specs[n] for n in names], mesh)
            arg_bytes += state.opt.step.element_size()
            arg_bytes += sharded_bytes(batch.values(), b_specs.values(), mesh)
            placed = sh.distribute_train_state(params, mesh, device="cpu")
            step = make_train_step(cfg, AdamWConfig(), remat=True)

            def run():
                return step(placed, inputs)
        elif shape.mode == "prefill":
            arg_bytes += sharded_bytes(batch.values(), b_specs.values(), mesh)
            sh.distribute_params(params, mesh, p_specs, device="cpu")

            def run():
                return prefill(params, cfg, inputs, shape.seq_len)
        else:
            sh.distribute_params(params, mesh, p_specs, device="cpu")
            cache = abstract_cache(cfg, shape)
            c_specs = sh.cache_pspecs(cache, mesh)
            leaves = _flat(cache, c_specs)
            arg_bytes += sharded_bytes([t for t, _ in leaves], [s for _, s in leaves],
                                       mesh)
            cache = sh.distribute_cache(cache, mesh, c_specs, device="cpu")
            pos = shape.seq_len - 1

            def run():
                logits, new_cache = decode_step(params, cfg, inputs["tokens"], cache, pos)
                if variant == "serve_topk":
                    from repro_torch.serving.router import distributed_vocab_topk

                    return distributed_vocab_topk(logits.to_local(), mesh=mesh, k=8,
                                                  batch_axes=b_specs["tokens"][0])
                return logits, new_cache

        with use_mesh(mesh), CommDebugMode() as comm:
            _, cost = count_cost(run)
    counts = {str(k).split(".")[-1]: int(v) for k, v in comm.get_comm_counts().items()}
    return cfg, shape, sizes, arg_bytes, cost, counts, time.time() - t0


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, verbose: bool = True,
             variant: str = "baseline") -> dict:
    cfg, shape, sizes, arg_bytes, cost, counts, secs = lower_cell(
        arch, shape_name, multi_pod=multi_pod, variant=variant)
    chips = math.prod(sizes.values())
    roof = roofline_per_device(cost, chips, model_flops=model_flops_for(cfg, shape))
    record = {
        "variant": variant,
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, sizes.values())),
        "chips": chips,
        "mode": shape.mode,
        "arg_bytes_per_device": arg_bytes,
        "memory_analysis": None,
        "lower_s": secs,
        "compile_s": None,
        **roof.as_dict(),
        "collectives": counts,
        "link_bytes_by_kind": {k: b for k, (_, b) in cost.collectives.items()},
        "kernels": cost.kernels,
        "notes": NOTES,
    }
    if verbose:
        print(f"[dryrun] {arch:24s} {shape_name:12s} mesh={record['mesh']:8s} "
              f"OK  args/dev={arg_bytes/2**30:6.2f}GiB "
              f"compute={roof.compute_s*1e3:8.2f}ms mem={roof.memory_s*1e3:8.2f}ms "
              f"coll={roof.collective_s*1e3:8.2f}ms dom={roof.dominant:10s} "
              f"useful={roof.useful_ratio:5.2f} collectives={counts} "
              f"({secs:.1f}s)", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all applicable)")
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--variant", default="baseline", choices=("baseline", "serve_topk"))
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a in list_archs():
            print(a, [s.name for s in applicable_shapes(get_config(a))])
        return 0

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_ok = n_fail = 0
    for arch in archs:
        shapes = ([args.shape] if args.shape
                  else [s.name for s in applicable_shapes(get_config(arch))])
        for shape_name in shapes:
            for multi in meshes:
                tag = f"{arch}_{shape_name}_{'multi' if multi else 'single'}"
                try:
                    rec = run_cell(arch, shape_name, multi_pod=multi, variant=args.variant)
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(rec, f, indent=1)
                    n_ok += 1
                except Exception as e:
                    n_fail += 1
                    print(f"[dryrun] {tag} FAILED: {e}", flush=True)
                    traceback.print_exc()
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
