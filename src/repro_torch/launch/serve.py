"""Serving CLI: batched requests against a (reduced or full) model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke \\
        --requests 8 --new-tokens 16 --device cpu

The twin of ``repro.launch.serve``, on the card unless ``--device`` names
another.  ``--arch`` takes any config of the dense, MoE and RG-LRU/local
hybrid families (RWKV6 and Whisper raise ``NotImplementedError``).
Prints the ``[serve] ... tok/s`` line, the first outputs, and one line
with the flash-attention kernel's (K12's) launches and the card's name and
power limit (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.kernels.flash_attention import flash_attention_fwd_cuda
from repro_torch.serving.engine import Request, ServingEngine


def card_line(device: torch.device) -> str:
    """``name, power limit`` of the card, as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return f"no card ({device.type})"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(device.index)], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)

    eng = ServingEngine(cfg, batch_size=args.batch, max_len=args.max_len,
                        rng_seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(3, 10))
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, size=plen).astype(np.int32),
            max_new_tokens=args.new_tokens,
        ))
    k12_before = flash_attention_fwd_cuda.launches
    t0 = time.time()
    done = []
    while eng.queue:
        done += eng.step_batch()
    dt = time.time() - t0
    n_tok = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s)")
    for r in done[:4]:
        print(f"  rid={r.rid} -> {r.output[:8]}...")
    print(f"[serve] K12 launches {flash_attention_fwd_cuda.launches - k12_before}; "
          f"{cfg.name} on {card_line(eng.device)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
