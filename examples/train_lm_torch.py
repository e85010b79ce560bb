"""Train a (reduced) LM for a few hundred steps with checkpoint/resume: the
PyTorch port's twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]
Equivalent to, twice (a cold start, then a resume from its checkpoint):
    python -m repro_torch.launch.train --arch phi4-mini-3.8b --smoke --steps 120 \\
        --batch 8 --seq 64 --lr 1e-3 --ckpt-dir <tmp> --ckpt-every 60 --device cuda
"""
import argparse
import subprocess
import sys
import tempfile


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        for phase in ("cold start", "resume"):
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train",
                 "--arch", "phi4-mini-3.8b", "--smoke",
                 "--steps", "120", "--batch", "8", "--seq", "64",
                 "--lr", "1e-3", "--ckpt-dir", d, "--ckpt-every", "60",
                 "--device", args.device],
                capture_output=True, text=True, timeout=560,
            )
            print(f"--- {phase} ---")
            print("\n".join(out.stdout.splitlines()[-6:]))
            if out.returncode != 0 or "done" not in out.stdout:
                raise SystemExit(f"{phase}: rc {out.returncode}\n{out.stderr}")


if __name__ == "__main__":
    main()
