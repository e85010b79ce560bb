"""Serve a small model with batched requests (prefill + decode loop),
greedy sampling: the PyTorch port's twin of ``examples/serve_lm.py``.
On a CUDA device the reduced config takes head width 64, the narrowest
the flash-attention kernel takes.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.serving.engine import Request, ServingEngine


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg, note = smoke_config(get_config("gemma-2b"), args.device)
    if note:
        print(note)
    eng = ServingEngine(cfg, batch_size=4, max_len=48, device=args.device)
    rng = np.random.default_rng(0)
    for rid in range(8):
        plen = int(rng.integers(3, 12))
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, size=plen).astype(np.int32),
            max_new_tokens=12,
        ))
    done = []
    while eng.queue:
        done += eng.step_batch()
    for r in done:
        print(f"request {r.rid}: prompt[{len(r.prompt)}] -> {r.output}")
    assert all(len(r.output) == 12 for r in done)
    print(f"served {len(done)} requests OK")


if __name__ == "__main__":
    main()
