"""Run one cell of the ODYS port's benchmark once, on the card it starts on.

    python3 odys_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m odys_bench.run ...`` from the checkout's root).  The cell,
its configuration (``odys_bench/configs/<config>.json``), its traffic mix
(``odys_bench/traffic/<mix>.json``) and its metrics are found by name in
``BENCHMARK.json``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: every number the
correctness check compared, beside its limit, which also end standard
error.

It exits non-zero and prints no result when there is no CUDA card or fewer
than the cell asks for, when the port is missing from the checkout, and
when JAX or the JAX package was loaded.  Kernel builds stay in the
checkout's ``build/``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "odys_bench"
#: Top-level modules that may not be loaded in the measured process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(name: str) -> tuple[dict, dict, dict, list, list]:
    """(cell, configuration, traffic, end-to-end metrics, per-layer metrics)
    of workload ``name``, from ``BENCHMARK.json`` and the files it names."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return cell, config, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"])


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config, traffic, end_to_end, per_layer = load_cell(args.workload)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"odys_bench: needs {chips} CUDA card(s), found {n}", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (the system under test must be in the checkout)
    from odys_bench.harness import run_cell

    limit = power_limit()
    res = run_cell(config, traffic, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda", t0=T0,
                   per_layer=per_layer if args.trace else ())
    bad = loaded_forbidden()
    if bad:
        print(f"odys_bench: the process loaded {bad}", file=sys.stderr)
        return 4

    wanted = per_layer if args.trace else end_to_end
    metrics = {}
    for m in wanted:
        value, unit = res["metrics"].get(m["name"], (None, None))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["peak"], "power_limit": limit}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    trace = res["run"].device
    if args.trace and trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.top_gaps()}
    n_win, n_rb = res["checked"]
    times = sorted(res["run"].response_s) or [float("nan")]
    print(f"odys_bench: {args.workload} seed {args.seed}: {res['answered']} answered "
          f"in {res['window_s']:.3f} s (response p95 "
          f"{1e3 * times[int(0.95 * (len(times) - 1))]:.1f} ms), set-up {res['setup_s']:.3f} s, "
          f"{n_win} window answers and {n_rb} read-backs checked, {limit}",
          file=sys.stderr)
    print("odys_bench: set-up " + ", ".join(f"{w} {sec:.3f} s" for w, sec in
                                            res["setup_parts"]), file=sys.stderr)
    print("odys_bench: batches " + "; ".join(
        f"k {k}: {len(v)}, {1e3 * sum(v) / len(v):.3f} ms mean, "
        f"{1e3 * sorted(v)[len(v) // 2]:.3f} median" for k, v in sorted(res["step_s"].items())),
        file=sys.stderr)
    pub = res["run"].publish_s
    if pub:
        print(f"odys_bench: publishes {len(pub)}: {1e3 * sum(pub) / len(pub):.3f} ms mean, "
              f"{1e3 * min(pub):.3f} min, {1e3 * max(pub):.3f} max", file=sys.stderr)
    if res["fill"] is not None:
        print(f"odys_bench: mutations pre-fill {res['fill'][0]}, applied "
              f"{res['fill'][1]}, posting fill at the close {res['posting_fill']}",
              file=sys.stderr)
    from odys_bench import host
    for what, values in res["host"].items():
        print(host.line(what, values), file=sys.stderr)
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in res["compared"].items()}
    for name, (v, lim) in res["compared"].items():
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
