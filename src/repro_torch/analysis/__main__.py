"""CLI: ``python -m repro_torch.analysis {check,lint,selftest,launch}``.

``check``, ``lint`` and ``selftest`` run on the CPU and exit 1 when any
finding fires (``selftest``: when any negative fixture is not rejected by
its own check), as the reference's CLI does.  ``launch`` needs a card: it
launches every contract's wrapper at each canonical instance and holds
the result against the plain version (the process ``chip_smoke.py`` runs
under ``compute-sanitizer``); it exits 1 on a mismatch.
"""
from __future__ import annotations

import argparse
import sys


def _cmd_check(args) -> int:
    from repro_torch.analysis.contracts import check_all

    contracts, findings = check_all(args.kernels or None,
                                    smem_budget=args.smem_budget * 1024)
    for c in contracts:
        mine = [f for f in findings if f.kernel == c.name]
        geo = "; ".join(f"{l.kernel} grid={l.grid} block={l.threads} smem={l.smem}"
                        for l in c.instances[0].launches)
        print(f"[{'FAIL' if mine else 'ok':4s}] {c.name:26s} {c.kid:4s} {c.site:52s} "
              f"{len(c.instances)} instance(s); {geo}")
    for f in findings:
        print(f, file=sys.stderr)
    print(f"{len(contracts)} launch contract(s), {len(findings)} finding(s)")
    return 1 if findings else 0


def _cmd_lint(args) -> int:
    from repro_torch.analysis.lint import default_root, lint_tree

    root = args.root or default_root()
    findings = lint_tree(root)
    for f in findings:
        print(f, file=sys.stderr)
    print(f"lint: {root}: {len(findings)} finding(s)")
    return 1 if findings else 0


def _cmd_selftest(args) -> int:
    """Every negative fixture must be rejected with the expected check."""
    from repro_torch.analysis.contracts import check_contract
    from repro_torch.analysis.fixtures import broken_contracts, broken_lint_sources
    from repro_torch.analysis.lint import lint_source

    bad = 0
    cases = [(c.name, expected, {f.check for f in check_contract(c)})
             for c, expected in broken_contracts()]
    cases += [(name, expected, {f.rule for f in lint_source(source, rel)})
              for name, rel, source, expected in broken_lint_sources()]
    for name, expected, got in cases:
        if expected in got:
            print(f"[ok  ] {name:32s} rejected by {expected!r}")
        else:
            bad += 1
            print(f"[FAIL] {name:32s} expected {expected!r}, got "
                  f"{sorted(got) or ['<nothing>']}", file=sys.stderr)
    print(f"selftest: {bad} missed rejection(s)")
    return 1 if bad else 0


def _cmd_launch(args) -> int:
    from repro_torch.analysis.launch import launch_all

    results = launch_all(args.kernels or None)
    bad = [r for r in results if not r.ok]
    for r in results:
        print(f"[launch] {r.name} {r.label}: {'ok' if r.ok else 'MISMATCH'} "
              f"max_abs_err={r.max_abs_err}")
    print(f"launch: {len(results)} instance(s), {len(bad)} mismatch(es)")
    return 1 if bad else 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Launch-contract checker and lints of the port's CUDA kernel layer.")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("check", help="check the registered launch contracts")
    pc.add_argument("kernels", nargs="*", help="_build.KERNELS entries (default: all)")
    pc.add_argument("--smem-budget", type=int, default=227,
                    help="dynamic shared memory budget a block in KiB (default 227, "
                         "H100's opt-in maximum)")
    pc.set_defaults(fn=_cmd_check)

    pl = sub.add_parser("lint", help="AST lints over src/repro_torch")
    pl.add_argument("--root", default=None, help="tree to lint")
    pl.set_defaults(fn=_cmd_lint)

    ps = sub.add_parser("selftest", help="negative fixtures must each be rejected")
    ps.set_defaults(fn=_cmd_selftest)

    pr = sub.add_parser("launch", help="launch each canonical instance on the card")
    pr.add_argument("kernels", nargs="*", help="_build.KERNELS entries (default: all)")
    pr.set_defaults(fn=_cmd_launch)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
