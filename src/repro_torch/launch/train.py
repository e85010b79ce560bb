"""End-to-end training CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --smoke --steps 200 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \\
        --mesh host --ranks 4 --device cpu

The twin of ``repro.launch.train``, on the card unless ``--device`` names
another; ``--seed`` seeds the weights and the token stream.  ``--smoke``
on a CUDA device takes the reduced config with head width 64, the
narrowest K12 takes (``configs.smoke_config``), and says so;
``--layers N`` cuts any config's depth to N layers at full width.
Sharded-checkpoint resume, gradient accumulation; the parameters are
created frozen and turned trainable here, and the train state is updated
in place (the twin of ``donate_argnums``).  Prints the reference's
``[train] step ...`` lines, a ``[train] checkpoint`` line with each
save's sha256 (and after a resume the restored state's), ``[train]
done``, and one line with K12's launches and the card's name and power
limit (``nvidia-smi``).

``--mesh host`` trains tensor- and data-parallel on the reference's host
mesh over the world that exists, ``(data = max(1, n // 2), model =
min(2, n))`` for n ranks: inside a ``torch.distributed`` world its own,
otherwise ``--ranks`` processes spawned by ``launch.spawn.run_ranks``
(``gloo``, a file rendezvous; every rank computes on its
``launch.mesh.rank_device``, which under one card is the same card).
Every rank draws the same weights from the seed and keeps its block:
parameters placed by ``launch.shardings.param_pspecs``, moments by
``opt_pspecs`` (ZeRO-1), the batch by ``io_pspec``; the step runs under
``models.sharding.use_mesh``.  Rank 0 prints; a checkpoint holds the
bytes of the one-rank save.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.index import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.kernels.flash_attention import flash_attention_fwd_cuda
from repro_torch.launch import shardings as sh
from repro_torch.launch.serve import card_line
from repro_torch.models.model import init_model
from repro_torch.models.sharding import full, use_mesh
from repro_torch.training.checkpoint import (
    latest_step, restore_checkpoint, save_checkpoint, state_digest)
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import TrainState, make_train_step


#: Seconds a spawned ``--mesh host`` world may take.
WORLD_TIMEOUT = 3600.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers (full width)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=("none", "host"), default="none")
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks to spawn for --mesh host outside a world")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch.distributed as dist

    if args.mesh == "host" and not dist.is_initialized():
        from repro_torch.launch.spawn import run_ranks

        with tempfile.TemporaryDirectory() as d:
            run_ranks(_rank_main, args.ranks, argv, rdzv_dir=d, timeout=WORLD_TIMEOUT)
        return 0
    train(args)
    return 0


def _rank_main(rank: int, world: int, argv) -> dict:
    """One rank of ``--mesh host`` (spawned by :func:`main`)."""
    return train(parse_args(argv))


def train(args: argparse.Namespace) -> dict:
    """Run the CLI's training; returns ``{"losses": [...], "k12": N,
    "seconds": s, "peak": bytes}``: this rank's K12 launches, the steps'
    seconds and its peak device memory (0 off the card)."""
    import torch.distributed as dist

    mesh = None
    say = print
    if args.mesh == "host":
        from repro_torch.launch.mesh import make_host_mesh, rank_device

        dev = rank_device(args.device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        n = dist.get_world_size()
        mesh = make_host_mesh(data=max(1, n // 2), model=min(2, n),
                              device_type=dev.type)
        if dist.get_rank() != 0:
            def say(*a, **k):
                pass
    else:
        dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg, note = smoke_config(cfg, dev)
        if note:
            say(f"[train] {note}")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    ds = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                global_batch=args.batch, seed=args.seed))

    params = init_model(cfg, seed=args.seed, device=dev)
    if mesh is None:
        state = TrainState(params.requires_grad_(True), init_opt_state(params))
    else:
        state = sh.distribute_train_state(params, mesh)

    def save(step: int) -> None:
        path = save_checkpoint(args.ckpt_dir, step, state, cfg)
        say(f"[train] checkpoint step {step}: {path} sha256 "
            f"{state_digest(state, cfg)}", flush=True)

    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(args.ckpt_dir, last, state, cfg)
            start = last
            say(f"[train] resumed from step {last}")
            say(f"[train] restored state sha256 {state_digest(state, cfg)}")

    k12_before = flash_attention_fwd_cuda.launches
    losses = []
    t0 = time.time()
    with use_mesh(mesh):
        for i in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(i).items()}
            if mesh is not None:
                batch = {k: sh.distribute(v, sh.io_pspec(mesh, tuple(v.shape)), mesh)
                         for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            loss = float(full(metrics["loss"]))
            losses.append(loss)
            if i % 10 == 0 or i == args.steps - 1:
                dt = (time.time() - t0) / max(i - start + 1, 1)
                say(f"[train] step {i:5d} loss={loss:.4f} "
                    f"gnorm={float(full(metrics['grad_norm'])):.3f} "
                    f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms/step", flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                save(i + 1)
    if args.ckpt_dir:
        save(args.steps)
    seconds = time.time() - t0
    say("[train] done")
    k12 = flash_attention_fwd_cuda.launches - k12_before
    say(f"[train] K12 launches {k12}; {cfg.name} on {card_line(dev)}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {"losses": losses, "k12": k12, "seconds": seconds, "peak": peak}


if __name__ == "__main__":
    raise SystemExit(main())
