"""End-to-end training CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --smoke --steps 200 --batch 8 --seq 128 --device cpu

The twin of ``repro.launch.train``, on the card unless ``--device`` names
another; ``--seed`` seeds the weights and the token stream.  No
``--mesh``: one card.  ``--smoke`` on a CUDA device takes the reduced
config with head width 64, the narrowest K12 takes
(``configs.smoke_config``), and says so.  Sharded-checkpoint resume,
gradient accumulation; the parameters are created frozen and turned
trainable here, and the train state is updated in place (the twin of
``donate_argnums``).  Prints the reference's ``[train] step ...`` lines,
a ``[train] checkpoint`` line with each save's sha256 (and after a resume
the restored state's), ``[train] done``, and one line with K12's launches
and the card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.index import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.kernels.flash_attention import flash_attention_fwd_cuda
from repro_torch.launch.serve import card_line
from repro_torch.models.model import init_model
from repro_torch.training.checkpoint import (
    latest_step, restore_checkpoint, save_checkpoint, state_digest)
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import TrainState, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg, note = smoke_config(cfg, dev)
        if note:
            print(f"[train] {note}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    ds = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                global_batch=args.batch, seed=args.seed))

    params = init_model(cfg, seed=args.seed, device=dev).requires_grad_(True)
    state = TrainState(params, init_opt_state(params))

    def save(step: int) -> None:
        path = save_checkpoint(args.ckpt_dir, step, state, cfg)
        print(f"[train] checkpoint step {step}: {path} sha256 "
              f"{state_digest(state, cfg)}", flush=True)

    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(args.ckpt_dir, last, state, cfg)
            start = last
            print(f"[train] resumed from step {last}")
            print(f"[train] restored state sha256 {state_digest(state, cfg)}")

    k12_before = flash_attention_fwd_cuda.launches
    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(i).items()}
        state, metrics = step_fn(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            dt = (time.time() - t0) / max(i - start + 1, 1)
            print(f"[train] step {i:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms/step", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save(i + 1)
    if args.ckpt_dir:
        save(args.steps)
    print("[train] done")
    print(f"[train] K12 launches {flash_attention_fwd_cuda.launches - k12_before}; "
          f"{cfg.name} on {card_line(dev)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
